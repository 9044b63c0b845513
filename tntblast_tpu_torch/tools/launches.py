"""The launch counts of the device step's seven hand-written kernels (seed
or seed_dense, pool, win_decode, screen_dp, eval_pack, kept), in this
process and in the ranks of the multi-process runtime.

`reset()` and `counts()` (from ops/__init__.py) set the step's kernels'
counts to 0 and read them; `run_ranks` runs ranks of
parallel/multiproc.py with TNTBLAST_TPU_PROFILE=1, whose one profile line a
rank carries that rank's counts, and `rank_counts` reads them from a line.
Used by chip_smoke.py, tools/device_bench.py and profile_slice.py.
"""

import os
import socket
import subprocess
import sys
import time

from tntblast_tpu_torch.ops import (  # noqa: F401  (re-exported)
    STEP_KERNELS, counts, reset, wrappers)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv, cwd, n_ranks=2, timeout=600, device=None, env=None):
    """`n_ranks` processes of the port's multi-process runtime on the
    tntblast arguments `argv` (rank 0 writes argv's -o file), each on
    `device` (`--device`; by default its own, parallel/multiproc.py
    rank_device), from directory `cwd`, with the variables of `env` added
    to the environment.  Returns (wall seconds, [(exit code, output) of
    each rank])."""
    env = dict(os.environ, PYTHONPATH=ROOT, TNTBLAST_TPU_PROFILE="1",
               **(env or {}))
    own = ["--device", device] if device is not None else []
    port = free_port()
    o = argv.index("-o") + 1
    t0 = time.perf_counter()
    procs, logs = [], []
    for rank in range(n_ranks):
        args = list(argv)
        if rank:
            args[o] = f"{argv[o]}.rank{rank}.ignore"
        # to a file, not a pipe: a rank that prints much must not block
        # while another waits for it in the gather
        logs.append(open(f"{argv[o]}.rank{rank}.log", "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tntblast_tpu_torch.parallel.multiproc",
             "--coordinator", f"127.0.0.1:{port}", "--num-procs",
             str(n_ranks), "--proc-id", str(rank), *own, "--", *args],
            cwd=cwd, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        deadline = t0 + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    return time.perf_counter() - t0, [(p.returncode, out)
                                      for p, out in zip(procs, outs)]


def profile_line(out, rank):
    """Rank `rank`'s profile line in its output, or None."""
    found = [ln for ln in out.splitlines() if ln.startswith(f"rank {rank}:")]
    return found[0] if len(found) == 1 else None


def rank_counts(line):
    """{kernel name: launches} from a rank's profile line (or from the
    device line of a search's TNTBLAST_TPU_PROFILE output, cli.py)."""
    return {name: int(line.split(f"{name}.launches ")[1].split()[0])
            for name in STEP_KERNELS}


def line_stats(line):
    """The panel manager's stats ({"fragments", "steps", "seeds", "kept",
    "fallback"}) from the same lines, or None where the line has none."""
    import ast

    text = line.split(" stats ", 1)[1]
    if text.startswith("None"):
        return None
    return ast.literal_eval(text[:text.index("}") + 1])


def kernel_of(key):
    """The step kernel (a name of STEP_KERNELS) whose wrapper launches the
    CUDA kernel of mangled name `key`, or None: the longest name that `key`
    holds (seed_dense_kernel is seed_dense's, not seed's)."""
    for name in sorted(STEP_KERNELS, key=len, reverse=True):
        if name in key:
            return name
    return None
