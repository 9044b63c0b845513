"""The port's multi-process runtime (tntblast_tpu_torch.parallel.multiproc
on torch.distributed, gloo): N processes each search their shard of the
(target, fragment) work items on the CPU (`--device cpu`), results gather
to process 0, whose merged hit list must be BYTE-IDENTICAL to the recorded
reference golden, the cases of tests/test_multiproc.py.  Every rank runs
with imports of jax and of the JAX package blocked."""

import filecmp
import io
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from tntblast_tpu.parallel.multiproc import partition_items as jax_partition
from tntblast_tpu_torch import cli
from tntblast_tpu_torch.parallel import multiproc
from tntblast_tpu_torch.tools import launches

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"
REPO = HERE.parent

# a rank: the module's entry point behind a finder that refuses jax and the
# JAX package
_RANK = r"""
import importlib.abc, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tntblast_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
from tntblast_tpu_torch.parallel import multiproc
sys.exit(multiproc.main(sys.argv[1:]))
"""


def _free_port():
    """A port the OS has free now (tests/test_multiproc.py counts up from
    9742 and may run beside this file)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env.update({"TNTBLAST_TPU_THREADS": "1", "PYTHONPATH": str(REPO),
                "OMP_NUM_THREADS": "2", "TNTBLAST_TPU_PROFILE": "1"})
    env.update(extra)
    return env


def _run_ranks(base_cmd, extra_args, out_file, num_procs, device="cpu",
               check=True):
    """Run `num_procs` ranks of the port's multiproc on `base_cmd`'s golden
    arguments, each with `--device device` (a list names each rank's; None
    leaves the flag out); returns [(returncode, stdout + stderr)] by rank.
    Each rank writes to a file: a pipe that fills would block the rank
    while another waits for it in the gather."""
    args = (GOLD / f"{base_cmd}.cmd").read_text().split()
    port = _free_port()
    devices = device if isinstance(device, list) else [device] * num_procs
    procs, logs = [], []
    for i in range(num_procs):
        own = ["--coordinator", f"127.0.0.1:{port}",
               "--num-procs", str(num_procs), "--proc-id", str(i)]
        if devices[i] is not None:
            own += ["--device", devices[i]]
        cmd = [sys.executable, "-c", _RANK, *own, "--", *args, *extra_args,
               "-o", str(out_file) if i == 0
               else str(out_file) + f".rank{i}.ignore"]
        logs.append(pathlib.Path(str(out_file) + f".rank{i}.log.ignore"))
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(
                cmd, cwd=DATA, env=_env(), stdout=fh,
                stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    results = [(p.returncode, log.read_text())
               for p, log in zip(procs, logs)]
    if check:
        for rc, err in results:
            assert rc == 0, err[-2000:]
    return results


def _profile_line(err, rank):
    lines = [ln for ln in err.splitlines() if ln.startswith(f"rank {rank}:")]
    assert len(lines) == 1, err[-2000:]
    return lines[0]


@pytest.mark.parametrize("name,num_procs", [
    ("pcr_frag", 2),      # fragmented targets: shard axis really splits
    ("taqman", 3),        # probe containment + secondary Tms
    ("inverse_target", 2),  # -m 3: merged no-match target report
])
def test_port_multiproc_matches_golden(name, num_procs, tmp_path):
    out_file = tmp_path / f"{name}.out"
    results = _run_ranks(name, [], out_file, num_procs)
    got = out_file.read_text() if out_file.exists() else ""
    assert got == (GOLD / f"{name}.out").read_text()
    for rank, (_, err) in enumerate(results):
        line = _profile_line(err, rank)
        # no device flag: no panel, and nothing from outside the port
        assert "device None" in line and "stats None" in line
        assert line.endswith("outside 0")


@pytest.mark.parametrize("flag", ["--tpu-screen", "--mesh"])
def test_port_multiproc_device_panel(flag, tmp_path):
    """Each rank drives its own device panel (here the CPU): output
    byte-identical, every rank's profile line shows device fragments and no
    fallback, and together the ranks sent every work item to a device."""
    out_file = tmp_path / "out.txt"
    results = _run_ranks("pcr_frag", [flag, "T"], out_file, 2)
    assert out_file.read_text() == (GOLD / "pcr_frag.out").read_text()
    fragments = 0
    for rank, (_, err) in enumerate(results):
        line = _profile_line(err, rank)
        assert "device cpu" in line and "'fallback': 0" in line
        assert line.endswith("outside 0")
        # CPU tensors take the plain versions: the counts read 0
        assert launches.rank_counts(line) == dict.fromkeys(
            launches.STEP_KERNELS, 0)
        n = int(line.split("'fragments': ")[1].split(",")[0])
        assert n > 0
        fragments += n
        assert "fell back" not in err
    assert fragments == 7          # pcr_frag's work items


def test_port_multiproc_per_query_files(tmp_path):
    """-n T (one output file per query) under the distributed runtime gives
    the per-query files of the port's single-process run."""
    single_dir = tmp_path / "single"
    multi_dir = tmp_path / "multi"
    single_dir.mkdir()
    multi_dir.mkdir()
    args = (GOLD / "pcr_frag.cmd").read_text().split()
    cwd = os.getcwd()
    try:
        os.chdir(DATA)
        rc = cli.local_main(
            args + ["-n", "T", "-o", str(single_dir / "out.txt")],
            stdout=io.StringIO(), device="cpu")
    finally:
        os.chdir(cwd)
    assert rc == 0
    _run_ranks("pcr_frag", ["-n", "T"], multi_dir / "out.txt", 2)
    singles = sorted(p.name for p in single_dir.iterdir())
    multis = sorted(p.name for p in multi_dir.iterdir()
                    if ".ignore" not in p.name)
    assert singles == multis and singles, (singles, multis)
    for name in singles:
        assert filecmp.cmp(single_dir / name, multi_dir / name,
                           shallow=False), name


def test_port_multiproc_rank_without_its_card_fails_the_run(tmp_path):
    """With a device flag and the default device (the rank's card), a
    machine without a card raises on every rank: no host search in its
    place, a non-zero exit code, no output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out_file = tmp_path / "out.txt"
    results = _run_ranks("pcr_frag", ["--tpu-screen", "T"], out_file, 2,
                         device=None, check=False)
    for rc, err in results:
        assert rc != 0
        assert "no CUDA device is available" in err
    assert not out_file.exists()


def test_port_multiproc_one_failing_rank_fails_the_others_at_once(tmp_path):
    """Only rank 1 raises (it is given a card this machine lacks; rank 0
    the CPU): rank 0, waiting in the gather that has no time limit, fails
    as soon as rank 1 is gone, long before the rendezvous timeout, and
    writes no output."""
    import time

    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out_file = tmp_path / "out.txt"
    t0 = time.monotonic()
    results = _run_ranks("pcr_frag", ["--tpu-screen", "T"], out_file, 2,
                         device=["cpu", "cuda:0"], check=False)
    assert time.monotonic() - t0 < multiproc.RENDEZVOUS_TIMEOUT_S / 4
    (rc0, err0), (rc1, err1) = results
    assert rc1 != 0 and "CUDA is not available" in err1
    assert rc0 != 0 and "CUDA is not available" not in err0
    assert "Traceback" in err0
    assert not out_file.exists()


_SLOW_RANK = r"""
import sys, time
from tntblast_tpu_torch.parallel import multiproc

multiproc.RENDEZVOUS_TIMEOUT_S = 4.0
plain = multiproc._search_shard


def slow(opt, db, engine, process_id, *rest):
    if process_id == 1:
        time.sleep(12.0)
    return plain(opt, db, engine, process_id, *rest)


multiproc._search_shard = slow
sys.exit(multiproc.main(sys.argv[1:]))
"""


def test_port_multiproc_gather_outlasts_the_rendezvous_timeout(tmp_path):
    """The rendezvous timeout does not bound the gather: with it set to 4 s,
    rank 0 waits 12 s and more for a slow rank 1 and the run succeeds."""
    args = (GOLD / "pcr_frag.cmd").read_text().split()
    port = _free_port()
    out_file = tmp_path / "out.txt"
    procs, logs = [], []
    for i in range(2):
        logs.append(tmp_path / f"rank{i}.log")
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SLOW_RANK, "--coordinator",
                 f"127.0.0.1:{port}", "--num-procs", "2", "--proc-id", str(i),
                 "--device", "cpu", "--", *args, "-o",
                 str(out_file) if i == 0 else str(out_file) + ".ignore"],
                cwd=DATA, env=_env(), stdout=fh, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-2000:]
    gather_s = float(_profile_line(logs[0].read_text(), 0)
                     .split("gather ")[1].split("s")[0])
    assert gather_s > 6.0
    assert out_file.read_text() == (GOLD / "pcr_frag.out").read_text()


def test_port_multiproc_usage(capsys):
    assert multiproc.main(["--num-procs", "2"]) == 2
    assert "usage: multiproc" in capsys.readouterr().err


def test_partition_items_equals_the_jax_package():
    # the skewed database of tests/test_multiproc.py: one 50 Mb chromosome
    # fragmented into 100 x 500 kb + 1000 x 10 kb plasmids
    items = [(0, i * 500_000, (i + 1) * 500_000 - 1, 49_999_999)
             for i in range(100)]
    items += [(1 + t, 0, 9_999, 9_999) for t in range(1000)]
    alt = []
    for i in range(100):
        alt.append((2 * i, 0, 499_999, 499_999))
        alt.append((2 * i + 1, 0, 9_999, 9_999))
    rng = np.random.default_rng(12)
    lists = [items, alt, []]
    for _ in range(6):
        n = int(rng.integers(1, 400))
        starts = rng.integers(0, 10**6, n)
        lens = rng.integers(1, 10**6 if n % 2 else 4, n)   # many ties too
        lists.append([(int(t), int(s), int(s + ln - 1), 10**7) for t, s, ln
                      in zip(rng.integers(0, 50, n), starts, lens)])
    for its in lists:
        for num_procs in (1, 2, 3, 8):
            got = multiproc.partition_items(its, num_procs)
            assert got == jax_partition(its, num_procs)
    sizes = [stop - start + 1 for (_, start, stop, _) in items]
    for num_procs in (2, 3, 8):
        loads = [0] * num_procs
        for o, sz in zip(multiproc.partition_items(items, num_procs), sizes):
            loads[o] += sz
        assert max(loads) <= sum(sizes) / num_procs + 500_000


_GATHER = r"""
import datetime, sys
import torch.distributed as dist
from tntblast_tpu_torch.parallel import multiproc

rank, port = int(sys.argv[1]), sys.argv[2]
multiproc.GATHER_CHUNK = 1000           # several rounds for rank 0's payload
dist.init_process_group(
    backend="gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
    world_size=2, timeout=datetime.timedelta(seconds=120))
calls = []
plain = multiproc._all_gather_u8
multiproc._all_gather_u8 = lambda buf, *a: (calls.append(buf.numel()),
                                            plain(buf, *a))[1]
try:
    payload = ([(i, [("sig", bytes(range(256)) * 3)]) for i in range(9)]
               if rank == 0 else [])
    got = multiproc._gather_blobs(payload, 2)
finally:
    dist.destroy_process_group()
assert got[0] == [(i, [("sig", bytes(range(256)) * 3)]) for i in range(9)]
assert got[1] == []
# the size exchange, then rounds of at most GATHER_CHUNK bytes a rank
assert calls[0] == 8 and len(calls) > 4, calls
assert max(calls[1:]) == 1000 and all(c <= 1000 for c in calls[1:]), calls
print("gathered", len(calls) - 1)
"""


def test_gather_blobs_in_rounds_with_an_empty_rank():
    """_gather_blobs on two gloo ranks with GATHER_CHUNK patched small: one
    payload spans several rounds, the other rank's is empty, and no round
    carries more than GATHER_CHUNK bytes a rank."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GATHER, str(rank), port], cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
        assert out.decode().startswith("gathered")
    assert outs[0][0] == outs[1][0]
