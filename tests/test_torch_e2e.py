"""The PyTorch port end to end on CPU tensors: every recorded reference
configuration through tntblast_tpu_torch's local_main with the device path
on must be byte-identical to the reference binary's recorded output; the
device-path behaviours tests/test_e2e_screen.py holds for the JAX package
(pruning, overflow fallback, N runs, swapped padlock arms) hold for the port
on the same inputs; and the package must never import jax or the JAX package
(this file imports neither)."""

import importlib
import importlib.abc
import io
import pathlib
import random
import subprocess
import sys

import pytest
import torch

import tntblast_tpu_torch.parallel.panel as port_panel
from tntblast_tpu_torch import cli

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def managers(monkeypatch):
    """Every panel manager the port's run_search builds."""
    made = []

    class Spy(port_panel.FragmentPanelManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(port_panel, "FragmentPanelManager", Spy)
    return made


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "tntblast_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None


def _block_jax_package(monkeypatch):
    """Until the test ends, any import of jax or of tntblast_tpu raises,
    also where another test file of this process has imported them."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "tntblast_tpu")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(sys, "meta_path", [_Block(), *sys.meta_path])


def _run(name, tmp_path, monkeypatch, extra):
    _block_jax_package(monkeypatch)
    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "2")
    ret = cli.local_main(args + ["-o", str(out_file), "-v", "F"] + extra,
                         stdout=io.StringIO(), device="cpu")
    assert ret == 0
    return out_file.read_text() if out_file.exists() else ""


CONFIGS = sorted(p.stem for p in GOLD.glob("*.cmd"))
# the configurations tests/test_e2e_screen.py runs through the JAX device
# path: every assay mode, fragmentation, degenerates, query segmentation
SCREENED = {"probe_small", "probe_dg", "pcr_small", "pcr_lowtm", "taqman",
            "degen", "padlock", "mips", "pcr_frag", "pcr_dinkelbach",
            "query_seg", "query_seg_frag"}


def test_every_recorded_configuration_is_listed():
    assert len(CONFIGS) == 44 and SCREENED <= set(CONFIGS)


@pytest.mark.parametrize("name", CONFIGS)
def test_port_device_path_matches_golden(name, tmp_path, monkeypatch,
                                         managers):
    got = _run(name, tmp_path, monkeypatch, ["--tpu-screen", "T"])
    want = GOLD / f"{name}.out"
    assert got == (want.read_text() if want.exists() else "")
    # network output mode (-m 2) writes .sif/.atr companions and no .out
    companions = [ext for ext in (".sif", ".atr")
                  if (GOLD / f"{name}.out{ext}").exists()]
    assert want.exists() or companions
    for ext in companions:
        assert (tmp_path / f"{name}.out{ext}").read_text() == (
            GOLD / f"{name}.out{ext}").read_text(), ext
    if name in SCREENED:
        (mgr,) = managers
        assert mgr.stats["fragments"] > 0 and mgr.stats["seeds"] > 0
        assert mgr.stats["fallback"] == 0


def _random_genome(seed, n):
    rng = random.Random(seed)
    return rng, [rng.choice("ACGT") for _ in range(n)]


def _local(argv, monkeypatch, threads="1"):
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", threads)
    assert cli.local_main(argv, stdout=io.StringIO(), device="cpu") == 0


@pytest.mark.parametrize("seed,length,extra,bound", [
    (1, 100000, [], 0.4),                       # a 40 C threshold prunes most
    (5, 60000, ["--dinkelbach", "T"], 1.0),     # the screen stays active
])
def test_port_screen_prunes_random_background(seed, length, extra, bound,
                                              tmp_path, monkeypatch,
                                              managers):
    """tests/test_e2e_screen.py::test_screen_prunes_random_background and
    ::test_dinkelbach_screen_prunes on the port."""
    db = tmp_path / "rand.fna"
    db.write_text(">rand\n" + "".join(_random_genome(seed, length)[1]) + "\n")
    monkeypatch.chdir(DATA)
    _local(["-i", "assay_pcr.txt", "-d", str(db), "-A", "PCR", "-e", "40",
            "-E", "40", "-o", str(tmp_path / "o.out"), *extra,
            "--tpu-screen", "T", "-v", "F"], monkeypatch)
    s = managers[0].stats
    assert s["seeds"] > 0, s
    assert s["kept"] < s["seeds"] and s["kept"] <= bound * s["seeds"], s


def test_port_overflow_falls_back_to_host(tmp_path, monkeypatch, capsys,
                                          managers):
    """A repetitive genome that overflows the device candidate capacity
    falls back to host seeding, with the unscreened run's output and a
    warning the user sees."""
    fwd = "TTGACCTAGATATTCAGCAAC"
    db = tmp_path / "rep.fna"
    db.write_text(">rep\n" + fwd * 1200 + "\n")
    monkeypatch.setattr(port_panel, "MAX_CAP", 2048)     # force overflow
    monkeypatch.chdir(DATA)
    argv = ["-i", "assay_pcr.txt", "-d", str(db), "-A", "PCR",
            "-e", "40", "-E", "40", "-v", "F"]
    _local(argv + ["-o", str(tmp_path / "scr.out"), "--tpu-screen", "T"],
           monkeypatch)
    assert managers[0].stats["fallback"] > 0, managers[0].stats
    assert "fell back to host seeding" in capsys.readouterr().err
    _local(argv + ["-o", str(tmp_path / "ref.out")], monkeypatch)
    assert (tmp_path / "scr.out").read_text() == (
        tmp_path / "ref.out").read_text()


def test_port_device_path_on_n_run_genome(tmp_path, monkeypatch):
    """A genome with assembly-gap N runs, scattered IUPAC bases and planted
    amplicons: the packed upload (2-bit stream + N-run/exception sideband)
    and the routing of degenerate windows to the host keep the output."""
    rng, seq = _random_genome(99, 200000)
    fwd = "TTGACCTAGATATTCAGCAAC"
    rev = "GGGAGAGACTCACCCAAAGATC"
    revc = rev.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    for base_pos in (30000, 120000):
        seq[base_pos:base_pos + len(fwd)] = fwd
        stop = base_pos + 700
        seq[stop:stop + len(revc)] = revc
    for start, ln in ((15000, 800), (30000 - 60, 50), (90000, 3000)):
        seq[start:start + ln] = "N" * ln
    for _ in range(200):
        seq[rng.randrange(len(seq))] = rng.choice("RYSWKMBDHVN")
    (tmp_path / "nrun.fna").write_text(">nrun\n" + "".join(seq) + "\n")
    (tmp_path / "assays.txt").write_text(f"pcr1\t{fwd}\t{rev}\n")
    monkeypatch.chdir(tmp_path)
    argv = ["-i", "assays.txt", "-d", "nrun.fna", "-A", "PCR", "-e", "40",
            "-E", "45", "-l", "2000", "--max-target-len", "60000", "-v", "F"]
    _local(argv + ["-o", "host.out"], monkeypatch)
    _local(argv + ["-o", "dev.out", "--tpu-screen", "T"], monkeypatch)
    host_text = (tmp_path / "host.out").read_text()
    assert host_text == (tmp_path / "dev.out").read_text()
    assert "pcr1" in host_text    # the planted amplicons were found


def test_port_padlock_swapped_arm_roles_device(tmp_path, monkeypatch):
    """An oligo that is the downstream arm of one assay and the upstream arm
    of another gets two slots with different ligation-clamp filters; the
    search that finds the other's filter falls back to host seeding, and
    the output stays the host path's."""
    _, seq = _random_genome(5, 60000)
    up = "TTGACCTAGATATTCAGCAAC"
    down = "GGGAGAGACTCACCCAAAGATC"
    seq[20000:20000 + len(down + up)] = down + up
    seq[40000:40000 + len(up + down)] = up + down
    (tmp_path / "pad.fna").write_text(">pad\n" + "".join(seq) + "\n")
    (tmp_path / "assays.txt").write_text(
        f"padA\t{down}\t{up}\npadB\t{up}\t{down}\n")
    monkeypatch.chdir(tmp_path)
    argv = ["-i", "assays.txt", "-d", "pad.fna", "-A", "PADLOCK", "-E", "40",
            "--probe-clamp5", "2", "-v", "F"]
    _local(argv + ["-o", "host.out"], monkeypatch)
    _local(argv + ["-o", "dev.out", "--tpu-screen", "T"], monkeypatch)
    host_text = (tmp_path / "host.out").read_text()
    assert host_text == (tmp_path / "dev.out").read_text()
    assert "padA" in host_text and "padB" in host_text


def test_port_tpu_frag_synonym(tmp_path, monkeypatch, managers):
    got = _run("pcr_small", tmp_path, monkeypatch, ["--tpu-frag", "T"])
    assert got == (GOLD / "pcr_small.out").read_text()
    assert managers and managers[0].stats["fragments"] > 0


def test_port_host_path_without_device_flag(tmp_path, monkeypatch,
                                            managers):
    got = _run("taqman", tmp_path, monkeypatch, [])
    assert got == (GOLD / "taqman.out").read_text()
    assert not managers


def test_port_mesh_is_refused(tmp_path, monkeypatch):
    """--mesh T is refused only where its devices are missing: with the
    default device (cuda) and no card it raises and does not carry on on
    the CPU; with device="cpu" it runs (tests/test_torch_mesh.py)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(DATA)
    argv = ["-i", "assay_pcr.txt", "-d", "small_db.fna", "-e", "40",
            "-E", "40", "-o", str(tmp_path / "o.out"), "-v", "F"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.local_main(argv + ["--mesh", "T"], stdout=io.StringIO())
    assert not (tmp_path / "o.out").exists() or not (
        tmp_path / "o.out").read_text()


def test_port_cuda_device_without_cuda_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(DATA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.local_main(["-i", "assay_pcr.txt", "-d", "small_db.fna",
                        "-e", "40", "-E", "40", "-o", str(tmp_path / "o.out"),
                        "-v", "F", "--tpu-screen", "T"],
                       stdout=io.StringIO())


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import tntblast_tpu_torch.cli, tntblast_tpu_torch.ops.thermo_dp\n"
            "import tntblast_tpu_torch._kernels\n"
            "import tntblast_tpu_torch.parallel.mesh\n"
            "import tntblast_tpu_torch.tools.screen_probe\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'tntblast_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_block_refuses_the_jax_package(monkeypatch):
    _block_jax_package(monkeypatch)
    for name in ("tntblast_tpu.constants", "jax.numpy"):
        with pytest.raises(ImportError, match="blocked"):
            importlib.import_module(name)
    importlib.import_module("tntblast_tpu_torch.constants")
