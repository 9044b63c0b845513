"""A search with long hybridization probes end to end, on the CPU: probes
of 45 to 60 nt, and of 130 and 140 nt (windows past 128 columns), (more
than the 31 words of the word-table seeding path at word length 7, so
every panel seeds on the dense path) cut from tests/data/small_db.fna,
half as they stand and half reverse-complemented,
through the JAX package's CLI with the device path on (--tpu-screen T),
the port's CLI with the device path on CPU tensors, and the port's host
path: the three output files must be byte-identical, with hits on both
strands and no fallback.  The long-probe configuration at full size
(tools/probe_bench.py) runs on the card in chip_smoke.py."""

import io
import pathlib

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"


# (length, offset) of the probes cut from small_db.fna's sequences in turn:
# four of 45-60 nt, and two past the 120 nt a window of 128 columns holds
CUTS = {"long": ((45, 300), (52, 900), (57, 1500), (60, 200)),
        "past-120-nt": ((130, 300), (140, 900))}


def _probes(path, cuts=CUTS["long"]):
    """Probes cut from small_db.fna, the odd ones reverse-complemented;
    returns their lengths."""
    from tntblast_tpu_torch.tools.probe_bench import read_sequences

    seqs = read_sequences(DATA / "small_db.fna")
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    lines, lengths = [], []
    for i, (n, x) in enumerate(cuts):
        site = seqs[i % len(seqs)][x:x + n]
        if i % 2:
            site = site.translate(comp)[::-1]
        lines.append(f"LONG{i}\t{site.decode()}\n")
        lengths.append(n)
    path.write_text("".join(lines))
    return lengths


@pytest.mark.parametrize("cuts", ["long", "past-120-nt"])
def test_long_probes_jax_port_and_host_agree(tmp_path, monkeypatch, cuts):
    from tntblast_tpu import cli as jax_cli
    from tntblast_tpu.parallel import panel as jax_panel

    import tntblast_tpu_torch.parallel.panel as port_panel
    from tntblast_tpu_torch import cli

    probes = tmp_path / "probes.txt"
    lengths = _probes(probes, CUTS[cuts])
    assert min(lengths) >= 45
    db = "small_db.fna"
    if cuts == "past-120-nt":
        # the two sequences the probes are cut from, a fragment a step:
        # the plain versions' DP over the wide windows of a step of eight
        # fragments would take most of a minute on the CPU
        recs = (DATA / db).read_text().split(">")[1:3]
        db = str(tmp_path / "two.fna")
        pathlib.Path(db).write_text("".join(">" + r for r in recs))
        monkeypatch.setenv("TNTBLAST_TPU_BATCH", "1")
        assert max(lengths) > 120
    args = ["-i", str(probes), "-d", db, "-A", "PROBE", "-E", "40", "-v",
            "F"]
    made = []
    for mod in (jax_panel, port_panel):
        class Spy(mod.FragmentPanelManager):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)
        monkeypatch.setattr(mod, "FragmentPanelManager", Spy)
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "2")
    outs = {}
    for name, run in (
            ("jax", lambda o: jax_cli.local_main(
                [*args, "-o", o, "--tpu-screen", "T"],
                stdout=io.StringIO())),
            ("port", lambda o: cli.local_main(
                [*args, "-o", o, "--tpu-screen", "T"],
                stdout=io.StringIO(), device="cpu")),
            ("host", lambda o: cli.local_main(
                [*args, "-o", o], stdout=io.StringIO(), device="cpu"))):
        out = tmp_path / f"{name}.out"
        assert run(str(out)) == 0
        outs[name] = out.read_bytes()
    assert outs["jax"] == outs["port"] == outs["host"]
    text = outs["host"].decode()
    assert text.count("probe tm") >= len(lengths) and "LONG1" in text
    # both device runs took the dense seeding path, with no fallback
    jax_mgr, port_mgr = made
    for mgr in made:
        assert mgr.stats["fragments"] > 0 and mgr.stats["fallback"] == 0
    assert all(np.asarray(dp.args[1]).shape[0] == 1 for g in jax_mgr.groups
               for dp in g._panels.values())
    dense = [dp.host_tables[1].shape[0] for g in port_mgr.groups
             for dp in g._panels.values()]
    assert dense and all(rows == 1 for rows in dense)
