"""The PyTorch port end to end on CPU tensors: the golden configurations
through tntblast_tpu_torch's local_main with the device path on must be
byte-identical to the reference binary's recorded output, and the package
must never import jax or the JAX package (this file imports neither)."""

import importlib
import importlib.abc
import io
import pathlib
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


@pytest.mark.parametrize("name", ["pcr_small", "taqman", "probe_small",
                                  "padlock", "pcr_frag", "degen"])
def test_port_device_path_matches_golden(name, tmp_path, monkeypatch,
                                         managers):
    got = _run(name, tmp_path, monkeypatch, ["--tpu-screen", "T"])
    assert got == (GOLD / f"{name}.out").read_text()
    (mgr,) = managers
    assert mgr.stats["fragments"] > 0 and mgr.stats["seeds"] > 0
    assert mgr.stats["fallback"] == 0 and not mgr.dead


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
