"""Time the screening DP's recurrence apart from its energy reads.

Counterpart of tools/tpu_pallas_probe2.py for an NVIDIA GPU:

    python -m tntblast_tpu_torch.tools.screen_probe

runs the three variants of ops/screen_probe.py (const_energy, sel5, sel30)
at the TPU probe's shapes (280 blocks of 512 windows, 24 rows, 32 columns,
3 conditions; inputs from np.random.default_rng(0)), checks each against
the plain PyTorch version and prints one JSON line per variant with the
CUDA-event time of the kernel (cuda_ms: launches queued back to back) and
the card's name and power limit.  It runs on `cuda` and raises when there is
no card; `--device cpu` runs the plain version only (a check of the
arithmetic, no device time).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tntblast_tpu_torch.ops.screen_probe import (
    screen_probe, screen_probe_reference)

VARIANTS = (("const_energy", 0), ("sel5", 5), ("sel30", 30))
BB, WQ_MAX, WT_MAX, NC_ALL, N_BLOCKS = 512, 24, 32, 3, 280


def probe_inputs(n_blocks=N_BLOCKS, bb=BB, wt_max=WT_MAX, ql=22, wt_e=30):
    """(meta, ptb) numpy arrays of tools/tpu_pallas_probe2.py:57-61."""
    rng = np.random.default_rng(0)
    meta = np.zeros((n_blocks, 4), np.int32)
    meta[:, 1] = ql
    meta[:, 2] = wt_e
    meta[:, 3] = 1
    ptb = rng.integers(0, 30, (n_blocks, wt_max, bb)).astype(np.int32)
    return meta, ptb


def card_name():
    """`name, power.limit` of the first card as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, batches=5):
    """Milliseconds of one run of fn on the card: `reps` runs are queued
    back to back between two CUDA events (so the card does not wait for the
    host between them), after one warm-up run; the median of `batches` such
    timings."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def graph_ms(fn, reps=20, batches=5):
    """Milliseconds of the device work of one run of fn, without the host
    time of its launches: `reps` runs are captured in one CUDA graph (after
    one warm-up run outside it) and the graph is replayed between two CUDA
    events; the median of `batches` replays, over `reps`."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def host_ms(fn, n=500):
    """Milliseconds of host time of one call of fn, from the host clock
    over `n` calls queued without a synchronisation between them (the
    card's queue takes them while the host goes on), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def run_variants(device, n_blocks=N_BLOCKS):
    """One result dict per variant: kernel against the plain version, and
    on a card the kernel's and the plain version's median times."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("screen_probe: no CUDA device is available")
    meta_np, ptb_np = probe_inputs(n_blocks)
    meta = torch.from_numpy(meta_np).to(device)
    ptb = torch.from_numpy(ptb_np).to(device)
    kw = dict(wq_max=WQ_MAX, nc_all=NC_ALL)
    card = card_name() if device.type == "cuda" else None
    results = []
    for name, n_sel in VARIANTS:
        got = screen_probe(meta, ptb, n_sel, **kw)
        want = screen_probe_reference(meta, ptb, n_sel, **kw)
        res = {"variant": name, "n_sel": n_sel, "device": str(device),
               "n_blocks": n_blocks, "windows": n_blocks * BB,
               "max_abs_err": int((got.long() - want.long()).abs().max()),
               "best_max": int(got.max()), "card": card}
        if device.type == "cuda":
            torch.cuda.synchronize()
            res["ms"] = cuda_ms(
                lambda: screen_probe(meta, ptb, n_sel, **kw), 10)
            res["plain_ms"] = cuda_ms(
                lambda: screen_probe_reference(meta, ptb, n_sel, **kw), 3)
        results.append(res)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-blocks", type=int, default=N_BLOCKS)
    args = ap.parse_args(argv)
    ok = True
    for res in run_variants(args.device, args.n_blocks):
        print(json.dumps(res), flush=True)
        ok = ok and res["max_abs_err"] == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
