"""BASELINE config 5 (tntblast_tpu_torch/tools/scaled_bench.py) on the CPU
at a small size: the port's generator writes the same bytes as the
repository's scale benchmark (tools/scaled_bench.py, whose sizes the test
sets by monkeypatch; the tool is not edited), its one-sequence database is
a prefix of its two-sequence one, and both assay families come out
byte-equal through the JAX CLI's host path, the port's device path on CPU
tensors and the port's host path; the tool's gate refuses runs whose
sha256 differ from host's."""

import importlib.util
import io
import pathlib

import pytest
import torch

import tntblast_tpu_torch.parallel.panel as port_panel
from tntblast_tpu_torch.tools import scaled_bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
NSEQ, SEQLEN = 2, 300_000


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_scaled_bench", ROOT / "tools" / "scaled_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return scaled_bench.build(str(tmp_path_factory.mktemp("scaled")), NSEQ,
                              SEQLEN)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_generator_is_byte_equal_to_the_jax_tool(files, tmp_path,
                                                 monkeypatch):
    tool = _jax_tool()
    monkeypatch.setattr(tool, "NSEQ", NSEQ)
    monkeypatch.setattr(tool, "SEQLEN", SEQLEN)
    want = tool.build(str(tmp_path))
    for got, ref in zip(files, want):
        assert pathlib.Path(got).read_bytes() == pathlib.Path(ref).read_bytes(
        ), got


def test_one_sequence_database_is_a_prefix(files, tmp_path):
    one = scaled_bench.build(str(tmp_path), 1, SEQLEN)
    head = pathlib.Path(one[0]).read_bytes()
    whole = pathlib.Path(files[0]).read_bytes()
    assert len(head) * NSEQ == len(whole) and whole.startswith(head)
    for a, b in zip(one[1:], files[1:]):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


def test_fasta_lines_cover_every_remainder():
    import numpy as np

    for n in (0, 1, 69, 70, 71, 140, 141):
        codes = np.arange(n, dtype=np.uint8) % 4
        txt = scaled_bench.BASES[codes].tobytes().decode()
        want = "".join(txt[i:i + 70] + "\n" for i in range(0, n, 70))
        assert scaled_bench._fasta_lines(codes).tobytes().decode() == want


@pytest.mark.parametrize("fmt", scaled_bench.FAMILIES)
def test_jax_cli_port_device_and_host_agree(fmt, files, tmp_path,
                                            monkeypatch):
    from tntblast_tpu import cli as jax_cli

    from tntblast_tpu_torch import cli
    from tntblast_tpu_torch.engine import _fragment_work_items
    from tntblast_tpu_torch.io.fastx import open_database

    fna, pcr, pad = files
    qfile = pcr if fmt == "PCR" else pad
    made = []

    class Spy(port_panel.FragmentPanelManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(port_panel, "FragmentPanelManager", Spy)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "2")
    # a fragment a step: the plain versions' step over eight fragments,
    # six of them padding, would take minutes on the CPU
    monkeypatch.setenv("TNTBLAST_TPU_BATCH", "1")
    outs = {}
    for name, run in (
            ("jax", lambda argv: jax_cli.local_main(
                argv, stdout=io.StringIO())),
            ("port", lambda argv: cli.local_main(
                argv + ["--tpu-screen", "T"], stdout=io.StringIO(),
                device="cpu")),
            ("host", lambda argv: cli.local_main(
                argv, stdout=io.StringIO(), device="cpu"))):
        out = tmp_path / f"{name}.out"
        argv = scaled_bench.family_argv(fmt, qfile, fna, str(out))
        assert run(argv + ["-v", "F"]) == 0
        outs[name] = out.read_bytes()
    assert outs["jax"] == outs["port"] == outs["host"]
    # every planted assay is found; at 300 kb a few of the sites planted
    # later overwrite earlier ones (at 128 Mb about 0.01 overlap), so the
    # count of sites is the full size's gate, not this one's
    text = outs["host"].decode()
    n_planted = scaled_bench.NPLANT if fmt == "PCR" else \
        scaled_bench.NPAD_PLANT
    prefix = "SCPCR" if fmt == "PCR" else "SCPAD"
    for a in range(n_planted):
        assert text.count(f"name = {prefix}{a:02d}\n") >= (
            scaled_bench.PLANTS_PER_SEQ * NSEQ * 9 // 10), a
    opt = scaled_bench.options(
        scaled_bench.family_argv(fmt, qfile, fna, str(tmp_path / "x")))
    items, _ = _fragment_work_items(opt, open_database(fna))
    (mgr,) = made
    assert mgr.stats["fragments"] == len(items) > 0
    assert mgr.stats["fallback"] == 0 and mgr.stats["seeds"] > 0


def _run(mode, fmt, digest, fallback=0):
    rec = {"mode": mode, "fmt": fmt, "rc": 0, "rcs": [0], "sha": digest,
           "hits": scaled_bench.planted(fmt, 1)}
    if mode in scaled_bench.DEVICE_MODES:
        rec["ranks"] = [{"fragments": 3, "steps": 1, "fallback": fallback,
                         "outside": None,
                         "launches": {"seed": 1, "screen_dp": 1}}]
    return rec


PLANS = {("screen", "PCR"): [{"fragments": 3, "steps": 1, "seed": 1,
                              "screen_dp": 1}]}


def test_gate_passes_equal_runs():
    runs = [_run("host", "PCR", "a" * 64), _run("screen", "PCR", "a" * 64)]
    assert scaled_bench.gate(runs, PLANS, 1) == []


@pytest.mark.parametrize("fault", ["sha", "fallback", "launches", "rc",
                                   "hits"])
def test_gate_refuses_a_faulty_run(fault):
    runs = [_run("host", "PCR", "a" * 64),
            _run("screen", "PCR", "b" * 64 if fault == "sha" else "a" * 64,
                 fallback=int(fault == "fallback"))]
    if fault == "launches":
        runs[1]["ranks"][0]["launches"]["screen_dp"] = 2
    if fault == "rc":
        runs[1].update(rc=1, rcs=[1])
    if fault == "hits":
        runs[1]["hits"] = 0
    bad = scaled_bench.gate(runs, PLANS, 1)
    assert len(bad) == 1 and bad[0].startswith("screen PCR"), bad


def test_step_plan_counts_the_steps_of_each_mode(files):
    """One step a batch of 8 fragments on one card, one a fragment on a
    one-card mesh, and each rank's share over two ranks."""
    from tntblast_tpu_torch.io.fastx import open_database

    fna, pcr, _ = files
    argv = scaled_bench.family_argv("PCR", pcr, fna, "/dev/null")
    db = open_database(fna)
    (one,) = scaled_bench.step_plan(argv, db, "screen")
    (mesh,) = scaled_bench.step_plan(argv, db, "mesh")
    ranks = scaled_bench.step_plan(argv, db, "ranks")
    assert one["fragments"] == mesh["fragments"] == NSEQ
    assert one["steps"] == 1 and mesh["steps"] == NSEQ
    assert [r["fragments"] for r in ranks] == [1, 1]
    for plan in (one, mesh, *ranks):
        assert plan["seed"] == plan["pool"] == plan["win_decode"] == plan[
            "kept"] == plan["steps"] and plan["seed_dense"] == 0
        assert plan["screen_dp"] == plan["eval_pack"] >= plan["steps"]


@pytest.mark.parametrize("line,device,outside", [
    ("rank 1: setup 3.0s search 25.9s gather 0.0s device cuda:0 "
     "seed.launches 4 seed_dense.launches 0 pool.launches 4 "
     "win_decode.launches 4 screen_dp.launches 8 eval_pack.launches 8 "
     "kept.launches 4 stats {'fragments': 30, 'steps': 4, 'seeds': 33, "
     "'kept': 12, 'fallback': 0} maxrss 5140144 kB outside 0",
     "cuda:0", 0),
    ("[profile] device cuda seed.launches 4 seed_dense.launches 0 "
     "pool.launches 4 win_decode.launches 4 screen_dp.launches 8 "
     "eval_pack.launches 8 kept.launches 4 stats {'fragments': 30, "
     "'steps': 4, 'seeds': 33, 'kept': 12, 'fallback': 0}", "cuda", None),
])
def test_device_record_reads_a_rank_line_and_a_search_line(line, device,
                                                           outside):
    rec = scaled_bench._device_record(line)
    assert rec == {"device": device, "fragments": 30, "steps": 4,
                   "fallback": 0, "outside": outside,
                   "launches": {"seed": 4, "seed_dense": 0, "pool": 4,
                                "win_decode": 4, "screen_dp": 8,
                                "eval_pack": 8, "kept": 4}}
    assert scaled_bench.peak_kb(line) == (5140144 if outside == 0 else None)


def test_tool_exits_non_zero_when_a_sha_differs(monkeypatch, capsys):
    """main() over two made-up runs whose outputs differ returns 1 and
    prints the failure on its last line; equal ones return 0."""
    import json

    digests = {"host": "a" * 64, "twoproc": "b" * 64}
    monkeypatch.setattr(scaled_bench, "build",
                        lambda work, nseq: ("db.fna", "pcr.txt", "pad.txt"))
    monkeypatch.setattr(
        scaled_bench, "run_mode",
        lambda mode, fmt, files, work, mb: _run(mode, fmt, digests[mode]))
    assert scaled_bench.main(["--nseq", "1", "host", "twoproc"]) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert not last["ok"] and all(
        f.startswith("twoproc") and "sha256" in f for f in last["failures"])
    digests["twoproc"] = digests["host"]
    assert scaled_bench.main(["--nseq", "1", "host", "twoproc"]) == 0
