"""All of a work item's assays in one native call (tnt_frag_search_panel,
`NativeFragContext.search_panel`) against one native call an assay.

`search_assay` builds an assay's hits from the panel call's rows where the
context holds them, else it searches the assay alone.  Both must give the
same hit objects, field for field and in order, for every assay format, on
fragments with and without the device's injected seeds; whole searches
must print the same bytes on the host path and on the device path's plain
versions, with one worker or four and where `query_sched` segments; the
counters `host.panel.calls` and `host.panel.assays` and the span
`host.panel_search` count one call a work item of more than one assay; and
a patched `engine.search_assay` (the benchmark's `altered_answer` fault)
still reaches the output."""

import dataclasses
import importlib
import io
import json
import pathlib
import sys

import pytest
import torch

from tntblast_tpu_torch import cli, native, trace
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import engine as eng
from tntblast_tpu_torch.io.fastx import open_database
from tntblast_tpu_torch.model import (
    expand_degenerate_signatures, read_input_file)
from tntblast_tpu_torch.options import Options
from tntblast_tpu_torch.parallel.panel import FragmentPanelManager
from tntblast_tpu_torch.search.native_assays import (
    NativeFragContext, PanelAssays, _codes, search_assay)

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
BENCH = HERE.parent / "benchmark"

PRIMERS = ["TTGACCTAGATATTCAGCAAC", "GGGAGAGACTCACCCAAAGATC"]
PROBES = ["CCTGTTTTGTGGAATGACATTTCC", "TTGACCTAGATATTCAGCAAC"]
ARMS = ["AATGACATTTCC", "CCTGTTTTGTGG", "TGTTTTGTGGA", "ATGACATTTCC"]
# (argv, assay lines): every format the native search has (PCR 0, probe
# 1, padlock 2, MIPS 3), each panel mixing assays with and without
# primers or a probe; AFFY searches no assay with primers (format -1)
FORMATS = {
    "pcr": (["-A", "PCR", "-e", "30", "-E", "30"],
            [f"pcrA\t{PRIMERS[0]}\t{PRIMERS[1]}",
             f"taqA\t{PRIMERS[0]}\t{PRIMERS[1]}\t{PROBES[0]}",
             f"probeA\t{PROBES[0]}",
             f"selfF\t{PRIMERS[0]}\t{PRIMERS[0]}",
             f"probeB\t{PROBES[1]}"]),
    "probe": (["-A", "PROBE", "-E", "30"],
              [f"probeA\t{PROBES[0]}", f"probeB\t{PROBES[1]}",
               f"pairA\t{PRIMERS[0]}\t{PRIMERS[1]}"]),
    "padlock": (["-A", "PADLOCK", "-E", "20"],
                [f"padA\t{ARMS[0]}\t{ARMS[1]}", f"probeA\t{PROBES[0]}",
                 f"padB\t{ARMS[2]}\t{ARMS[3]}"]),
    "mips": (["-A", "MIPS", "-E", "20", "-l", "30"],
             [f"padA\t{ARMS[0]}\t{ARMS[1]}", f"padB\t{ARMS[2]}\t{ARMS[3]}",
              f"taqA\t{PRIMERS[0]}\t{PRIMERS[1]}\t{PROBES[0]}"]),
    "affy": (["-A", "AFFY", "-E", "30"],
             [f"probeA\t{PROBES[0]}", f"pcrA\t{PRIMERS[0]}\t{PRIMERS[1]}",
              f"probeB\t{PROBES[1]}"]),
}


def _options(tmp_path, argv, lines):
    path = tmp_path / "assays.txt"
    path.write_text("\n".join(lines) + "\n")
    opt = Options()
    opt.parse(["-i", str(path), "-d", str(DATA / "small_db.fna")] + argv)
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(str(path), opt.ignore_probe,
                        opt.assay_format == C.ASSAY_PROBE),
        opt.degen_rescale_ct)
    opt.validate_search_threshold()
    return opt


def _fields(hits):
    return [dataclasses.asdict(h) for h in hits]


@pytest.fixture(scope="module")
def records():
    db = open_database(str(DATA / "small_db.fna"))
    return [db.read(i) for i in range(db.size())]


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_panel_call_gives_the_per_assay_hits(name, records, tmp_path,
                                             monkeypatch):
    opt = _options(tmp_path, *FORMATS[name])
    sigs = opt.sig_list
    engine = eng.make_melt_engine(opt, n_threads=1)
    mgr = FragmentPanelManager(opt, engine, "cpu")
    assays = PanelAssays(sigs, opt)
    real_search = native.FragSearch.search
    found = 0
    for defline, seq in records:
        for injected in (None, mgr.run_fragment(seq)):
            one = NativeFragContext(engine, seq, opt.hash_word_size,
                                    defline, panel_result=injected)
            want = [search_assay(one, s, opt) for s in sigs]
            panel = NativeFragContext(engine, seq, opt.hash_word_size,
                                      defline, panel_result=injected)
            panel.search_panel(assays, sigs)
            # every assay's hits come from the panel call's rows
            monkeypatch.setattr(native.FragSearch, "search", None)
            got = [search_assay(panel, s, opt) for s in sigs]
            monkeypatch.setattr(native.FragSearch, "search", real_search)
            assert [_fields(h) for h in got] == [_fields(h) for h in want]
            assert panel._panel == {}
            assert panel.frag.stats() == one.frag.stats()
            found += sum(map(len, want))
            one.close()
            panel.close()
    assert found > 0


def test_assay_table_holds_each_assays_search(tmp_path):
    """The table's rows: each assay's format, its forward, reverse and
    probe codes (empty where the native search takes none), its
    concentrations and its length cap.  MIPS searches the arms alone;
    AFFY searches no assay with primers.  An index outside the table
    raises."""
    opt = _options(tmp_path, *FORMATS["mips"])
    t = PanelAssays(opt.sig_list, opt).table
    assert t.formats.tolist() == [3, 3, 3]
    ends = [0] + t.ends.tolist()
    parts = [t.codes[a:b].tolist() for a, b in zip(ends, ends[1:])]
    codes = [_codes(x).tolist() for x in ARMS + PRIMERS]
    assert parts == [codes[0], codes[1], [], codes[2], codes[3], [],
                     codes[4], codes[5], []]
    assert t.max_len.tolist() == [30, 30, 30]
    ct, cp = opt.forward_primer_strand, opt.probe_strand
    assert t.conc.tolist() == pytest.approx(
        [ct, ct, 0.0, ct, ct, 0.0, ct, ct, cp], rel=1e-6)
    opt = _options(tmp_path, *FORMATS["affy"])
    t = PanelAssays(opt.sig_list, opt).table
    assert t.formats.tolist() == [1, -1, 1]
    ends = [0] + t.ends.tolist()
    assert [b - a for a, b in zip(ends, ends[1:])] == [
        0, 0, len(PROBES[0]), 0, 0, 0, 0, 0, len(PROBES[1])]
    # an index outside the table never reaches the native call
    frag = native.MeltEngine(n_threads=1).frag_search(
        _codes("ACGT" * 20), opt.hash_word_size)
    for idx in ([3], [0, -1]):
        with pytest.raises(ValueError):
            frag.search_panel(t, idx)
    assert frag.search_panel(t, [1]) == ([0], [], [], [])
    frag.close()


def _traffic(name):
    """The benchmark's generator `name` and its configuration's params."""
    sys.path.insert(0, str(BENCH))
    try:
        gen = importlib.import_module(f"traffic.{name}")
    finally:
        sys.path.remove(str(BENCH))
    params = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return gen, params["params"]


def _write_artic(tmp, genomes, amplicons=None):
    gen, params = _traffic("artic_v3")
    if amplicons is not None:
        params = dict(params, amplicons=params["amplicons"][:amplicons],
                      panels={"artic": params["panels"]["artic"][
                          :amplicons]})
    got = gen.generate(str(tmp), 2**33 + 5, **dict(params, genomes=genomes))
    return ["-i", got["queries"]["artic"], "-d", got["db"], "-A", "PCR",
            "-e", "40", "-E", "45", "-l", "2000", "-v", "F"]


def _write_config5(tmp):
    gen, params = _traffic("config5")
    got = gen.generate(str(tmp), 2**34 + 3, **dict(
        params, records=[30000, 20000, 15000, 10000], plants_per_record=3))
    base = ["-d", got["db"], "-e", "40", "-E", "45", "-v", "F"]
    return {"pcr": ["-i", got["queries"]["pcr"], "-A", "PCR", "-l", "2000",
                    "--query-seg", "adaptive"] + base,
            "padlock": ["-i", got["queries"]["padlock"], "-A", "PADLOCK"]
            + base}


def _run(argv, out, monkeypatch, threads, panel=True, device=False):
    """One search; without `panel`, every assay makes its own native
    call.  Returns the output and the search's trace."""
    with monkeypatch.context() as mp:
        mp.setenv("TNTBLAST_TPU_THREADS", str(threads))
        mp.setenv("TNTBLAST_TPU_PROFILE", "1")
        if not panel:
            mp.setattr(NativeFragContext, "search_panel",
                       lambda self, assays, sigs: None)
        flags = ["--tpu-screen", "T" if device else "F"]
        rc = cli.local_main(argv + ["-o", str(out)] + flags,
                            stdout=io.StringIO(), device="cpu")
    assert rc == 0
    return out.read_bytes(), trace.searches()[-1]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _panel_counts(s):
    names = [x.name for x in s.spans]
    return (s.counters.get("host.panel.calls", 0),
            s.counters.get("host.panel.assays", 0),
            names.count("host.panel_search"), names.count("host.search"))


def test_artic_outputs_are_equal(tmp_path, monkeypatch):
    """The 98-assay panel over three genomes: the per-assay calls, the
    panel call with one worker (the serial loop) and with four, and forced
    query segmentation print the same bytes; one panel call a genome, none
    on a one-assay item."""
    argv = _write_artic(tmp_path / "artic", 3)
    want, s = _run(argv, tmp_path / "a.out", monkeypatch, 4, panel=False)
    assert _panel_counts(s) == (0, 0, 0, 3 * 98)
    assert want.count(b"\n") > 100
    for threads in (1, 4):
        got, s = _run(argv, tmp_path / f"t{threads}.out", monkeypatch,
                      threads)
        assert got == want
        assert _panel_counts(s) == (3, 3 * 98, 3, 3 * 98)
    got, s = _run(argv + ["--query-seg", "always"], tmp_path / "seg.out",
                  monkeypatch, 4)
    assert got == want
    assert _panel_counts(s) == (0, 0, 0, 3 * 98)


def test_device_path_outputs_are_equal(tmp_path, monkeypatch):
    """The device path's plain versions with the panel call print the host
    path's bytes: the first 6 ARTIC amplicons (one panel group) over two
    genomes, and the config5 PCR and padlock panels over four records of
    10-30 kb.  Under adaptive segmentation `query_sched` keeps the PCR
    search's first record whole (four records for four workers) and
    splits its last (one record left)."""
    runs = [("artic", _write_artic(tmp_path / "artic", 2, amplicons=6))]
    runs += sorted(_write_config5(tmp_path / "config5").items())
    for name, argv in runs:
        want, _ = _run(argv, tmp_path / f"{name}.host", monkeypatch, 4,
                       panel=False)
        assert want.count(b"\n") > 10, name
        got, s = _run(argv, tmp_path / f"{name}.dev", monkeypatch, 4,
                      device=True)
        assert got == want, name
        calls, served, spans, searches = _panel_counts(s)
        assert spans == calls >= 1 and served > calls, name
        if name == "artic":
            assert (calls, served) == (2, 12)
        elif name == "pcr":
            # the segmented items search one assay each, with no panel
            assert served == 10 * calls and searches > served
        else:
            assert (calls, served, searches) == (4, 24, 24)


def test_a_patched_search_assay_reaches_the_output(tmp_path, monkeypatch):
    """The benchmark's altered_answer fault: engine.search_assay patched
    to scale the first hit's dH changes what is written."""
    argv = _write_artic(tmp_path / "artic", 2)
    want, _ = _run(argv, tmp_path / "a.out", monkeypatch, 4)
    real = eng.search_assay

    def altered(ctx, sig, opt):
        hits = real(ctx, sig, opt)
        if hits:
            hits[0].forward_dH *= 1.01
        return hits

    monkeypatch.setattr(eng, "search_assay", altered)
    got, s = _run(argv, tmp_path / "b.out", monkeypatch, 4)
    assert got != want
    assert _panel_counts(s)[:2] == (2, 2 * 98)
