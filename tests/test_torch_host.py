"""The port's host path (no device flag) on the CPU: every recorded
reference configuration through tntblast_tpu_torch's CLI must give the
reference binary's output byte for byte (file and terminal; only the
wall-clock seconds line is normalised), and the port's native engine must
agree with the JAX package's on tables and melt evaluations bit for bit."""

import io
import pathlib
import re
import sys

import numpy as np
import pytest

from tntblast_tpu import native as ref_native
from tntblast_tpu_torch import cli, native
from tntblast_tpu_torch.cli import usage_text
from tntblast_tpu_torch.engine import make_melt_engine, query_sched
from tntblast_tpu_torch.options import Options

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"

CONFIGS = sorted(p.stem for p in GOLD.glob("*.cmd"))


def _normalize_stdout(text, out_path):
    text = re.sub(r"Search completed in \d+ sec", "Search completed in N sec",
                  text)
    # the recorded "Output = <path>" line carries the golden's own path
    return text.replace(str(out_path), "OUTPATH")


def test_all_recorded_configurations_are_covered():
    assert len(CONFIGS) == 44


@pytest.mark.parametrize("name", CONFIGS)
def test_port_host_path_matches_golden(name, tmp_path, monkeypatch):
    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "1")

    stdout = io.StringIO()
    monkeypatch.setattr(sys, "stdout", stdout)
    print("Running on local machine [1 thread(s)]")
    ret = cli.local_main(args + ["-o", str(out_file)], stdout=stdout,
                         device="cpu")
    monkeypatch.undo()
    assert ret == 0

    got = out_file.read_text() if out_file.exists() else ""
    want_path = GOLD / f"{name}.out"
    assert got == (want_path.read_text() if want_path.exists() else "")
    # network output mode (-m 2) writes .sif/.atr companions
    for ext in (".sif", ".atr"):
        want_c = GOLD / f"{name}.out{ext}"
        if want_c.exists():
            got_c = pathlib.Path(str(out_file) + ext)
            assert got_c.exists(), f"missing {ext} output"
            assert got_c.read_text() == want_c.read_text(), ext

    recorded = (GOLD / f"{name}.stdout").read_text()
    recorded_path = re.search(r"^\s*Output = (\S+)$", recorded, re.M)
    want_stdout = _normalize_stdout(
        recorded, recorded_path.group(1) if recorded_path else "\0")
    assert _normalize_stdout(stdout.getvalue(), out_file) == want_stdout


@pytest.mark.parametrize("name", ["pcr_frag", "taqman", "query_seg_frag"])
def test_port_host_path_threaded(name, tmp_path, monkeypatch):
    """The port's threaded fragment loop gives the sequential hit list."""
    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "4")
    ret = cli.local_main(args + ["-o", str(out_file)], stdout=io.StringIO(),
                         device="cpu")
    assert ret == 0
    assert out_file.read_text() == (GOLD / f"{name}.out").read_text()


def test_port_usage_text_parity():
    """-h usage equals the reference's, modulo the appended device-flag
    lines and the BLAST-build lines; the --mesh line names torch."""
    text = usage_text()
    ours = [ln for ln in text.splitlines(keepends=True)
            if "--tpu-" not in ln and "--blast-" not in ln
            and "--mesh" not in ln]
    assert "".join(ours) == (HERE / "golden"
                             / "usage_noblast.txt").read_text()
    (mesh_line,) = [ln for ln in text.splitlines() if "--mesh" in ln]
    assert "torch devices" in mesh_line and "jax" not in mesh_line


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("argv,seed", [
    ([], 11),
    (["-s", "0.1", "--temperature", "320.0"], 12),
    (["--dangle5", "T", "--dangle3", "T"], 13),
    (["--dinkelbach", "T"], 14),
])
def test_native_engines_agree(argv, seed):
    """Both native engines, built from the same options: equal delta_g and
    delta_g_screen tables, equal screening slack, and equal eval_batch
    results (f32 compared as bit patterns) in all three modes."""
    opt = Options()
    opt.parse(["-i", "x", "-d", "y", "-e", "40", "-E", "40", *argv])
    port = make_melt_engine(opt, n_threads=1)
    ref = ref_native.MeltEngine(
        target_T=opt.target_t, na=opt.salt, dangle5=opt.allow_dangle_5,
        dangle3=opt.allow_dangle_3, dinkelbach=opt.use_dinkelbach,
        n_threads=1)
    assert port._lib is not ref._lib
    assert port.screen_slack == ref.screen_slack
    for T in (None, 313.15, 338.4):
        np.testing.assert_array_equal(port.delta_g(T), ref.delta_g(T))
        np.testing.assert_array_equal(port.delta_g_screen(T),
                                      ref.delta_g_screen(T))

    rng = np.random.default_rng(seed)
    n = 48
    queries = [rng.integers(0, 4, rng.integers(16, 30)).astype(np.uint8)
               for _ in range(n)]
    targets = []
    for q in queries:
        t = (3 - q[::-1]).astype(np.uint8)       # reverse complement
        for pos in rng.integers(0, len(t), rng.integers(0, 4)):
            t[pos] = rng.integers(0, 4)          # a few mismatches
        flank = rng.integers(0, 4, 8).astype(np.uint8)
        targets.append(np.concatenate([flank[:4], t, flank[4:]]))
    conc = rng.choice(np.float32([9e-7, 2.5e-7, 1e-6]), n)
    for mode in (native.HETERO, native.HOMO, native.HAIRPIN):
        got = port.eval_batch(mode, queries, targets, conc)
        want = ref.eval_batch(mode, queries, targets, conc)
        assert got.keys() == want.keys()
        assert got["align"] == want["align"]
        for key in want:
            if key != "align":
                np.testing.assert_array_equal(
                    _bits(got[key]), _bits(want[key]), err_msg=f"{mode} {key}")
        if mode == native.HETERO:
            assert got["valid"].any() and (got["tm"] > 0).any()


def test_native_engine_builds_into_the_ports_build_directory():
    native.get_lib()
    lib = pathlib.Path(native._LIB)
    assert lib.exists()
    assert lib.parent == (HERE.parent / "tntblast_tpu_torch" / "_build")
    assert not list((HERE.parent / "tntblast_tpu_torch" / "native").glob(
        "*.so"))


def test_query_sched_is_the_references():
    from tntblast_tpu.engine import query_sched as ref_sched
    rng = np.random.default_rng(5)
    for _ in range(200):
        a = (int(rng.integers(0, 50)), int(rng.integers(0, 50)),
             int(rng.integers(1, 9)), float(rng.random() * 3),
             int(rng.integers(0, 3)))
        assert query_sched(*a) == ref_sched(*a)
