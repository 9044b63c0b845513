"""Nothing of the JAX side in a run, nothing of the program in the
reference, and no benchmark file opens the repository's older bench
files."""

import os
import re
import subprocess
import sys

import run
from conftest import BENCH


def test_forbidden_names_compare_whole_top_level_names():
    assert run.forbidden_modules(["tntblast_tpu_torch",
                                  "tntblast_tpu_torch.cli", "jaxtyping",
                                  "numpy"]) == []
    assert run.forbidden_modules(["tntblast_tpu.cli", "jaxlib.xla_client",
                                  "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "tntblast_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference, "
            "nucruc, roofline, devtrace; "
            "bad = sorted({m.split('.')[0] for m in "
            "sys.modules} & {'jax', 'jaxlib', 'flax', 'tntblast_tpu', "
            "'tntblast_tpu_torch', 'torch'}); print(bad)" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_no_benchmark_file_opens_the_older_bench_files():
    pat = re.compile(r"bench\.py|bench_data|bench_work|BASELINE")
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
        for f in files:
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, f)).read()
            code = "\n".join(ln for ln in text.splitlines()
                             if not ln.lstrip().startswith("#"))
            # only docstrings may name them (as the source of a copy)
            for m in pat.finditer(code):
                line = code[:m.start()].count("\n")
                src = code.splitlines()[line]
                assert "open(" not in src and "import" not in src, (f, src)


def test_no_result_without_the_program(tmp_path):
    import shutil

    from conftest import ROOT

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "config5.chrom128",
         "--seed", "1", "--seconds", "1", "--rehearse"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
