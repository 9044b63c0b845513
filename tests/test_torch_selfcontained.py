"""The port is a package of its own: no module of tntblast_tpu_torch, and
not chip_smoke.py, imports jax or anything of the JAX package
tntblast_tpu; its copies of the reference's host modules stay equal to
their originals apart from the package name."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tntblast_tpu_torch"
REF = ROOT / "tntblast_tpu"
GOLD = ROOT / "tests" / "golden" / "e2e"

PORT_SOURCES = sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]

# files copied from the JAX package: the port's text, with the package name
# put back and the first (origin) line dropped, is the original's text
VERBATIM = [
    "constants.py", "utils/__init__.py", "utils/cppio.py",
    "utils/listsort.py", "options.py", "model.py", "heuristics.py",
    "thermo/__init__.py", "thermo/santa_lucia.py",
    "native/melt_engine.cpp", "screen_bound.py",
    "search/__init__.py", "search/seed.py", "search/bind.py",
    "search/assays.py", "search/mask.py",
    "search/dedup.py", "io/__init__.py", "io/annot.py",
    "io/blastdb.py", "io/lmdb.py", "output.py",
]
# copied files with one reworded comment line (1-based, in the original)
REWORDED_LINES = {"native/melt_engine.cpp": {355}}
# counterparts with intended edits, and why they are not compared
EDITED = {
    "engine.py": "device branch: explicit torch device, no health probe, "
                 "no host search in place of a missing device",
    "screen.py": "numpy screening tables for the panel; screen_windows on an "
                 "explicit torch device with a per-device table cache",
    "native/__init__.py": "builds into _build/ through a temporary file; "
                          "a lock per engine around tnt_eval_batch and "
                          "tnt_eval_alignment, whose scratch is per engine",
    "cli.py": "device= argument; the --mesh usage line names torch; the "
              "search's spans",
    "io/fastx.py": "SequenceDatabase.read records the spans io.read and "
                   "io.decode and the counter io.bytes_decoded",
    "search/native_assays.py": "the spans host.frag_index, "
                               "host.seed_inject and host.search",
    "native/frag_search.cpp": "one-call block injection; the eval filter "
                              "factored out",
}


def _forbidden(name):
    return name is not None and (
        name == "jax" or name.startswith("jax.")
        or name == "tntblast_tpu" or name.startswith("tntblast_tpu."))


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_no_import_of_jax_or_the_jax_package(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [(node.lineno, a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module):
                bad.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")):
            bad += [(node.lineno, a.value) for a in node.args[:1]
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{rel} imports {bad}"


def test_the_walk_sees_every_port_module():
    assert "tntblast_tpu_torch/engine.py" in PORT_SOURCES
    assert "tntblast_tpu_torch/parallel/mesh.py" in PORT_SOURCES
    assert "tntblast_tpu_torch/tools/screen_probe.py" in PORT_SOURCES
    for rel in ("parallel/multiproc.py", "entry.py", "tools/device_bench.py"):
        assert f"tntblast_tpu_torch/{rel}" in PORT_SOURCES
    assert "chip_smoke.py" in PORT_SOURCES
    assert len(PORT_SOURCES) >= 44
    assert _forbidden("tntblast_tpu.io.fastx") and _forbidden("jax.numpy")
    assert not _forbidden("tntblast_tpu_torch.io.fastx")
    assert not _forbidden("jaxtyping")


_BLOCKED_RUN = r"""
import importlib, importlib.abc, io, pkgutil, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if (name == "jax" or name.startswith("jax.")
                or name == "tntblast_tpu" or name.startswith("tntblast_tpu.")):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import tntblast_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tntblast_tpu_torch.__path__, "tntblast_tpu_torch.")]
for name in names:
    if name != "tntblast_tpu_torch.__main__":    # runs the CLI on import
        importlib.import_module(name)
assert len(names) >= 40, names
from tntblast_tpu_torch.cli import local_main
rc = local_main(sys.argv[1:], stdout=io.StringIO(), device="cpu")
assert rc == 0, rc
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "tntblast_tpu" or m.startswith("tntblast_tpu.")]
assert not loaded, loaded
print("modules", len(names))
"""


def test_port_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    """Every module of the port imports, and the pcr_small golden runs
    through the device path on the CPU, while a meta-path finder raises on
    jax and tntblast_tpu."""
    out = tmp_path / "pcr_small.out"
    args = (GOLD / "pcr_small.cmd").read_text().split()
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, *args, "-o", str(out),
         "--tpu-screen", "T", "-v", "F"],
        cwd=ROOT / "tests" / "data", capture_output=True, text=True,
        timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "TNTBLAST_TPU_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("modules")
    assert out.read_bytes() == (GOLD / "pcr_small.out").read_bytes()


def test_the_block_does_block():
    code = _BLOCKED_RUN.split("import tntblast_tpu_torch\n")[0] + (
        "try:\n    import tntblast_tpu.constants\n"
        "except ImportError as e:\n    print('refused', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("refused")


def _restored(rel):
    lines = (PORT / rel).read_text().replace(
        "tntblast_tpu_torch", "tntblast_tpu").splitlines(keepends=True)
    return lines[0], lines[1:]


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_equals_its_original(rel):
    head, got = _restored(rel)
    assert f"tntblast_tpu/{rel}" in head, head
    assert head.startswith("//" if rel.endswith(".cpp") else "#")
    want = (REF / rel).read_text().splitlines(keepends=True)
    assert len(got) == len(want)
    differing = {i + 1 for i, (g, w) in enumerate(zip(got, want)) if g != w}
    assert differing == REWORDED_LINES.get(rel, set())


def test_copied_data_file_equals_its_original():
    rel = "thermo/special_hairpin_loops.json"
    assert (PORT / rel).read_bytes() == (REF / rel).read_bytes()


@pytest.mark.parametrize("rel", sorted(EDITED))
def test_edited_counterpart_names_its_original(rel):
    """The counterparts with intended edits say where they come from
    and keep every public name of the original they still serve."""
    head, _ = _restored(rel)
    assert f"tntblast_tpu/{rel}" in head, head

    def public(path):
        if path.suffix == ".cpp":       # the C entry points
            return set(re.findall(r"^[\w*]+[ *]+(tnt_\w+)\(",
                                  path.read_text(), re.M))
        tree = ast.parse(path.read_text())
        return {n.name for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("__")}

    missing = public(REF / rel) - public(PORT / rel)
    assert not missing, missing


def test_every_copied_or_edited_file_is_listed():
    """A host module added to the port later must be put on one of the
    lists: the port has no unlisted file that also exists in the JAX
    package, except the modules it ported to torch."""
    ported = {"__init__.py", "__main__.py", "ops/__init__.py",
              "ops/eval_gapless.py", "ops/thermo_dp.py",
              "parallel/__init__.py", "parallel/device_search.py",
              "parallel/panel.py", "parallel/mesh.py",
              "parallel/multiproc.py"}
    shared = {str(p.relative_to(PORT)) for p in PORT.rglob("*")
              if p.suffix in (".py", ".cpp", ".json")
              and (REF / p.relative_to(PORT)).exists()}
    listed = set(VERBATIM) | set(EDITED) | ported | {
        "thermo/special_hairpin_loops.json"}
    assert shared == listed, shared ^ listed
