"""Smoke run of the PyTorch/CUDA port (tntblast_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. print the card (nvidia-smi name, power limit); build the CUDA kernels
     from csrc/ with nvcc, one compiler process per source, all at once;
  2. screen_dp vs its plain PyTorch version on the card, at the main path's
     shapes: one 32768-window chunk of the bench panel's own tables (mixed
     slots, some invalid entries); best, mgmax and the valid M rows must be
     equal bit for bit; both times from CUDA events (median of several
     runs); the kernel's bound from this chunk's own cell and byte counts;
  3. screen_probe vs its plain version at the TPU probe's full shapes
     (280 blocks of 512 windows), three variants, bit for bit; then the
     probe's own entry point (tntblast_tpu_torch.tools.screen_probe) with
     the launch count read around it;
  4. the slice: the 8 Mb / 10-assay PCR bench config (bench_data.py)
     through the port's local_main with --tpu-screen T on the card; the
     output's sha256 must equal the reference binary's, the screen kernel
     must have run, and no fragment may fall back to the host;
  5. the mesh path: the same config with --mesh T over make_mesh() (every
     visible card), under the same gates;
  6. three golden configs through `python -m tntblast_tpu_torch` on the
     card, byte-identical to the reference output;
  7. nothing of jax or of the JAX package may have been imported; one JSON
     line describing the kernels, then the result line.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over 3.35e12 B/s (HBM3), and
its int32 operations over 64 lanes x 132 SMs x the SM clock nvidia-smi
reports while the kernel runs.  Operations per DP cell are counted from
the kernels' inner loops (OPS_PER_CELL below).
"""

import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# sha256 of the reference tntblast v2.77 output on the bench config
# (the gate of bench.py:62 BENCH_GOLDEN_SHA256)
BENCH_GOLDEN_SHA256 = (
    "4394383a49dbcbe751377f977fa7509c124c243350c755a72bbf876156d66b05")
BENCH_ARGS = ["-A", "PCR", "-e", "40", "-E", "45", "-l", "2000"]
GOLDENS = ("pcr_small", "taqman", "padlock")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, HBM3
INT32_LANES = 64 * 132             # int32 lanes per SM x SMs, per clock
# int32 operations per DP cell, from the kernels' inner loops: three
# relu-subtract pairs and two max for M (8), two pairs and a max for
# I_target (5), relu, subtract, negate, max for the I_query head (4),
# subtract and max for its recurrence (2), the column test and the best max
# (2), the table index (5 in screen_dp: two clamps, multiply, add, multiply;
# 3 in the probe: clamp, multiply), and in screen_dp the gapped-best
# channel of the eval condition (6 on one condition of three: 2 a cell)
OPS_PER_CELL = {"screen_dp": 28, "screen_probe": 24,
                "screen_probe_const": 21}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sm_clock_hz(torch, fn, ms):
    """The SM clock nvidia-smi reports while `fn` (one launch of about
    `ms` milliseconds) keeps the card busy for about a second."""
    for _ in range(max(10, int(1000.0 / max(ms, 0.01)))):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def bound_ms(n_bytes, n_ops, clock_hz):
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (INT32_LANES * clock_hz) * 1e3
    return ((t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations"))


def bench_options(fna, panel, out_path):
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu_torch.options import Options
    opt = Options()
    opt.parse(["-i", panel, "-d", fna, *BENCH_ARGS, "-o", out_path])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    return opt


def kernel_vs_plain(torch, card, fna, panel):
    """Phase 2: screen_dp against screen_dp_reference on the card, its
    times and its bound."""
    import numpy as np

    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.ops.screen_dp import screen_dp, screen_dp_reference
    from tntblast_tpu_torch.parallel.device_search import SCREEN_CHUNK
    from tntblast_tpu_torch.parallel.panel import FragmentPanelManager
    from tntblast_tpu_torch.tools.screen_probe import cuda_ms

    opt = bench_options(fna, panel, os.devnull)
    melt = make_melt_engine(opt, n_threads=1)
    mgr = FragmentPanelManager(opt, melt, device="cuda")
    check(len(mgr.groups) == 1, f"{len(mgr.groups)} panel groups")
    tile = mgr._tile_len(opt.fragment_target_threshold
                         + opt.max_product_length() + 2)
    dp = mgr.groups[0].device_panel(tile)
    cfg = dp.config
    st = dp.tabs["slots"]
    nc_all = dp.tabs["tc_all"].shape[0]
    print(f"bench panel: slots={dp.n_real} num_os={cfg.num_os} "
          f"wq_max={cfg.wq_max} num_cond={cfg.num_cond} nc_all={nc_all} "
          f"eval_on={dp.eval_on} tile={cfg.tile_len} cap={cfg.cap} "
          f"s_max={dp.s_max} k_max={dp.k_max}")

    rng = np.random.default_rng(20260818)
    B = SCREEN_CHUNK
    wt_max = cfg.wq_max + 8
    slot = rng.integers(0, dp.n_real, B).astype(np.int32)
    slot[rng.random(B) < 0.03] = cfg.num_os          # invalid entries
    ql = st["ql"].cpu().numpy()[np.clip(slot, 0, cfg.num_os)]
    wt_e = ql + 8
    tb5 = rng.integers(0, 4, (B, wt_max)).astype(np.int32)
    tb5[np.arange(wt_max)[None, :] >= wt_e[:, None]] = 0
    pt6 = np.concatenate([np.full((B, 1), 5, np.int32), tb5[:, :-1]], 1)
    dev = torch.device("cuda")
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pt6 * 5 + tb5, slot, ql, wt_e)]
    args += [st["qp"], dp.tabs["tc_all"]]

    got = screen_dp(*args, eval_on=dp.eval_on)
    torch.cuda.synchronize()
    want = screen_dp_reference(*args, eval_on=dp.eval_on)
    torch.cuda.synchronize()
    err = [int((got[0].long() - want[0].long()).abs().max()),
           int((got[1].long() - want[1].long()).abs().max())]
    if dp.eval_on:
        valid = args[1] < dp.n_real
        rows = (torch.arange(cfg.wq_max, device=dev)[:, None]
                < args[2][None, :]) & valid[None, :]
        err.append(int((got[2][rows].long()
                        - want[2][rows].long()).abs().max()))
    max_err = max(err)
    print(f"screen_dp vs plain at B={B} wq_max={cfg.wq_max} "
          f"wt_max={wt_max} nc_all={nc_all}: max_abs_err={max_err} "
          f"(best, mgmax, M_rows = {err})")
    check(max_err == 0, "screen_dp kernel disagrees with its plain version")

    def run_kernel():
        screen_dp(*args, eval_on=dp.eval_on)

    def run_plain():
        screen_dp_reference(*args, eval_on=dp.eval_on)

    # plain, kernel, kernel, plain
    p1 = cuda_ms(run_plain, 3)
    k1 = cuda_ms(run_kernel, 10)
    k2 = cuda_ms(run_kernel, 10)
    p2 = cuda_ms(run_plain, 3)
    k_ms = statistics.median([k1, k2])
    p_ms = statistics.median([p1, p2])
    print(f"screen_dp kernel: {k_ms:.4f} ms per 32768-window chunk "
          f"(runs {k1:.4f}, {k2:.4f}) on {card}")
    print(f"screen_dp plain PyTorch: {p_ms:.4f} ms per 32768-window chunk "
          f"(runs {p1:.4f}, {p2:.4f}) on {card}")
    # the same chunk without the eval outputs (no M-row store, no
    # gapped-best channel): what the recurrence and the table reads cost
    s_ms = cuda_ms(lambda: screen_dp(*args, eval_on=False), 10)
    print(f"screen_dp kernel with eval_on=False (same {nc_all} tables, no "
          f"M rows, no mgmax): {s_ms:.4f} ms per chunk on {card}")

    # the bound, from what this chunk's data needs: invalid entries leave
    # the kernel at once, a valid one runs ql rows of wt_max columns for
    # every condition and stores ql M rows of wt_max + 1 words
    ok = slot < dp.n_real
    rows = int(np.minimum(ql, cfg.wq_max)[ok].sum())
    cells = rows * nc_all * wt_max
    n_bytes = (sum(a.numel() * a.element_size() for a in args)
               + 4 * (nc_all * B + B)
               + (4 * rows * (wt_max + 1) if dp.eval_on else 0))
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(n_bytes, cells * OPS_PER_CELL["screen_dp"], clock)
    print(f"screen_dp bound: {b_ms:.4f} ms by {b_by} ({cells} cells x "
          f"{OPS_PER_CELL['screen_dp']} int32 ops at {clock / 1e6:.0f} MHz; "
          f"{n_bytes} bytes); kernel is at {100 * b_ms / k_ms:.1f}% of it "
          f"on {card}")
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_eval_off": s_ms}


def probe_phase(torch, card):
    """Phase 3: screen_probe against screen_probe_reference at the TPU
    probe's shapes, then its entry point with the launch count around it."""
    from tntblast_tpu_torch.ops.screen_probe import (
        screen_probe, screen_probe_reference)
    from tntblast_tpu_torch.tools import screen_probe as tool

    meta_np, ptb_np = tool.probe_inputs()
    dev = torch.device("cuda")
    meta = torch.from_numpy(meta_np).to(dev)
    ptb = torch.from_numpy(ptb_np).to(dev)
    kw = dict(wq_max=tool.WQ_MAX, nc_all=tool.NC_ALL)
    max_err = 0
    for name, n_sel in tool.VARIANTS:
        got = screen_probe(meta, ptb, n_sel, **kw)
        torch.cuda.synchronize()
        want = screen_probe_reference(meta, ptb, n_sel, **kw)
        err = int((got.long() - want.long()).abs().max())
        print(f"screen_probe {name} vs plain at n_blocks={tool.N_BLOCKS} "
              f"BB={tool.BB} wq_max={tool.WQ_MAX} wt_max={tool.WT_MAX} "
              f"nc_all={tool.NC_ALL}: max_abs_err={err} "
              f"best_max={int(got.max())}")
        check(err == 0, f"screen_probe {name} disagrees with its plain "
                        "version")
        max_err = max(max_err, err)

    # the probe's own path: the entry point a user calls
    screen_probe.launches = 0
    results = tool.run_variants("cuda")
    launches = screen_probe.launches
    check(launches > 0, "the probe entry point never launched screen_probe")
    cells = (tool.N_BLOCKS * tool.BB * tool.NC_ALL * tool.WQ_MAX
             * tool.WT_MAX)
    n_bytes = (meta.numel() + ptb.numel()
               + tool.N_BLOCKS * tool.NC_ALL * tool.BB) * 4
    out = {"max_abs_err": max_err, "launches": launches,
           "library_ms": None}
    for res in results:
        check(res["max_abs_err"] == 0,
              f"entry point: {res['variant']} disagrees")
        name, ms = res["variant"], res["ms"]
        print(f"screen_probe {name}: kernel {ms:.4f} ms, plain PyTorch "
              f"{res['plain_ms']:.4f} ms (median CUDA-event times) on "
              f"{card}")
        out[f"ms_{name}"] = ms
        out[f"plain_ms_{name}"] = res["plain_ms"]
    # the kernel's row in the table is its full variant, sel30
    out["ms"], out["plain_ms"] = out["ms_sel30"], out["plain_ms_sel30"]
    clock = sm_clock_hz(
        torch, lambda: screen_probe(meta, ptb, 30, **kw), out["ms"])
    screen_probe.launches = 0
    for name, ops_key in (("sel30", "screen_probe"),
                          ("const_energy", "screen_probe_const")):
        nb = n_bytes if name == "sel30" else n_bytes - ptb.numel() * 4
        b_ms, b_by = bound_ms(nb, cells * OPS_PER_CELL[ops_key], clock)
        print(f"screen_probe {name} bound: {b_ms:.4f} ms by {b_by} "
              f"({cells} cells x {OPS_PER_CELL[ops_key]} int32 ops at "
              f"{clock / 1e6:.0f} MHz; {nb} bytes); kernel is at "
              f"{100 * b_ms / out['ms_' + name]:.1f}% of it on {card}")
        if name == "sel30":
            out["bound_ms"], out["bound_by"] = b_ms, b_by
    return out


def run_slice(torch, card, fna, panel, work, flag, reps):
    """Phases 4 and 5: the bench config through the port's local_main with
    the device flag `flag` ("--tpu-screen" or "--mesh"); returns the
    screen_dp launches of the first run."""
    import tntblast_tpu_torch.parallel.panel as port_panel
    from tntblast_tpu_torch import cli
    from tntblast_tpu_torch.engine import _fragment_work_items
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.ops.screen_dp import screen_dp
    from tntblast_tpu_torch.parallel.mesh import MeshPanel, make_mesh

    made = []
    plain_mgr = port_panel.FragmentPanelManager

    class Recorded(plain_mgr):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    name = "mesh" if flag == "--mesh" else "slice"
    out_path = os.path.join(work, f"port_out_{name}.txt")
    argv = ["-i", panel, "-d", fna, *BENCH_ARGS, "-o", out_path,
            flag, "T", "-v", "F"]
    opt = bench_options(fna, panel, out_path)
    db = open_database(fna)
    items, _ = _fragment_work_items(opt, db)
    mb = sum(db.approx_seq_len(i) for i in range(db.size())) / 1e6

    walls = []
    port_panel.FragmentPanelManager = Recorded
    try:
        for rep in range(reps):
            if rep == 0:
                screen_dp.launches = 0
            t0 = time.perf_counter()
            rc = cli.local_main(argv, stdout=io.StringIO(), device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if rep == 0:
                launches = screen_dp.launches
            check(rc == 0, f"local_main returned {rc}")
            digest = sha256(out_path)
            check(digest == BENCH_GOLDEN_SHA256,
                  f"{name}: bench output sha256 {digest} != reference")
            mgr = made[-1]
            print(f"{name} run {rep}: wall={walls[-1]:.3f} s "
                  f"({mb / walls[-1]:.3f} Mb/s) stats={mgr.stats} "
                  f"dead={mgr.dead} batch={mgr.batch} on {card}")
            check(mgr.stats["fallback"] == 0,
                  "fragments fell back to the host")
            check(mgr.dead is False, "device panel marked dead")
            check(mgr.stats["fragments"] == len(items),
                  f"{mgr.stats['fragments']} device fragments, "
                  f"{len(items)} work items")
            if flag == "--mesh":
                check(mgr.mesh == make_mesh(), "mesh is not make_mesh()")
                check(all(isinstance(dp, MeshPanel) for g in mgr.groups
                          for dp in g._panels.values()),
                      "--mesh did not go through MeshPanel")
    finally:
        port_panel.FragmentPanelManager = plain_mgr
    check(launches > 0, f"the {name} path never launched screen_dp")
    print(f"{name}: bench {mb:.1f} Mb, {len(items)} fragments, output "
          f"sha256 matches the reference, screen_dp launches={launches}")
    med = statistics.median(walls[1:] or walls)
    print(f"{name} wall (median of the runs after the first, {reps} runs): "
          f"{med:.3f} s = {mb / med:.3f} Mb/s; first run {walls[0]:.3f} s; "
          f"on {card}")
    return launches


def run_goldens(card):
    """Phase 6: golden configs through the CLI module on the card."""
    data = os.path.join(HERE, "tests", "data")
    gold = os.path.join(HERE, "tests", "golden", "e2e")
    env = dict(os.environ, PYTHONPATH=HERE)
    for name in GOLDENS:
        with open(os.path.join(gold, f"{name}.cmd")) as fh:
            args = fh.read().split()
        out = os.path.join(HERE, "bench_work", f"golden_{name}.out")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tntblast_tpu_torch", *args, "-o", out,
             "--tpu-screen", "T", "-v", "F"],
            cwd=data, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"{name}: exit {proc.returncode}\n{proc.stderr}")
        with open(out) as a, open(os.path.join(gold, f"{name}.out")) as b:
            check(a.read() == b.read(), f"{name}: output differs")
        print(f"golden {name}: byte-identical on the card "
              f"({time.perf_counter() - t0:.1f} s incl. start-up, {card})")


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import bench_data
    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.tools.screen_probe import card_name

    card = card_name()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # one compiler process per source, all started together
    t0 = time.perf_counter()
    names = ("screen_dp", "screen_probe")
    errors = {}

    def build(name):
        try:
            _kernels.build(name, force=True)
        except Exception as e:      # noqa: BLE001 — reported below
            errors[name] = e

    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, e in errors.items():
        raise SmokeFailure(f"{name} did not build: {e}")
    print(f"built {', '.join(names)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _kernels.build_log[name].splitlines():
            if "ptxas" in line:
                print(f"{name}: {line.strip()}")

    work = os.path.join(HERE, "bench_work")
    fna, panel = bench_data.build(work)

    dp_row = kernel_vs_plain(torch, card, fna, panel)
    probe_row = probe_phase(torch, card)
    launches = run_slice(torch, card, fna, panel, work, "--tpu-screen", 2)
    launches_mesh = run_slice(torch, card, fna, panel, work, "--mesh", 1)
    run_goldens(card)

    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "tntblast_tpu"
              or m.startswith("tntblast_tpu.")]
    check(not loaded, f"imported from outside the port: {loaded[:5]}")
    print("no module of jax or of tntblast_tpu was imported")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [
        {"name": "screen_dp", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/screen_dp.cu",
         "replaces": "tntblast_tpu/ops/pallas_screen.py:93",
         "launches": launches, "launches_mesh": launches_mesh, **dp_row},
        {"name": "screen_probe", "route": "cuda",
         "source": "tntblast_tpu_torch/csrc/screen_probe.cu",
         "replaces": "tools/tpu_pallas_probe2.py:18", **probe_row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
