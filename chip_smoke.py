"""Smoke run of the PyTorch/CUDA port (tntblast_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. print the card (nvidia-smi name, power limit); build the CUDA kernels
     from csrc/ with nvcc, one compiler process per source, all at once;
     print what ptxas reports and fail if a kernel that keeps its DP row in
     registers has a stack frame or spills;
  2. screen_dp vs its plain PyTorch version on the card, at the main path's
     shapes: one 32768-window chunk of the bench panel's own tables (mixed
     slots, some invalid entries); best, mgmax and the valid M rows must be
     equal bit for bit; both times from CUDA events (launches queued back
     to back); the kernel's bound from this chunk's own cell and byte
     counts; the same windows slot-major, as the device step streams them;
     then one width of every other path of the kernel against the plain
     version: a narrow register width, one between two widths, and a window
     too wide for registers (rows in shared memory);
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
reports while the kernel runs.  Operations per DP cell are the fewest the
recurrence needs on this card, a fused add-max counted once (OPS_PER_CELL
below).
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
GOLDENS = ("pcr_small", "taqman", "padlock")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, HBM3
INT32_LANES = 64 * 132             # int32 lanes per SM x SMs, per clock
# int32 operations a DP cell needs on this card, where an add followed by
# a max is one operation (DPX add-max): two adds and five add-max for M,
# I_target and I_query (7), the two clamps the next row reads (2), the
# column test and the best max (2), the table address from the packed pair
# value (2).  A cell of the eval condition adds the gapped-best channel
# (test, add, select, max, and its own best max: 5) and the M-row store (1).
OPS_PER_CELL = {"screen": 13, "eval": 19}
# (wq_max, windows) of the widths phase 2 holds against the plain version
# beside the bench's: wt_max = wq_max + 8 = 24 (the narrow register width),
# 28 (between the two: runs on width 32), 64 (rows in shared memory)
OTHER_WIDTHS = ((16, 8192), (20, 8192), (56, 2048))


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


def kernel_vs_plain(torch, card, fna, panel):
    """Phase 2: screen_dp against screen_dp_reference on the card, its
    times and its bound."""
    import numpy as np

    from tntblast_tpu_torch.ops.screen_dp import (
        kernel_tables, kernel_width, screen_dp, screen_dp_reference)
    from tntblast_tpu_torch.parallel.device_search import SCREEN_CHUNK
    from tntblast_tpu_torch.tools.bench_inputs import (
        bench_chunk, bench_panel, chunk_inputs, dp_errors)
    from tntblast_tpu_torch.tools.screen_probe import cuda_ms

    dp = bench_panel(fna, panel)
    cfg = dp.config
    nc_all = dp.tabs["tc_all"].shape[0]
    print(f"bench panel: slots={dp.n_real} num_os={cfg.num_os} "
          f"wq_max={cfg.wq_max} num_cond={cfg.num_cond} nc_all={nc_all} "
          f"eval_on={dp.eval_on} tile={cfg.tile_len} cap={cfg.cap} "
          f"s_max={dp.s_max} k_max={dp.k_max}")

    B = SCREEN_CHUNK
    wt_max = cfg.wq_max + 8
    args, slot, ql = bench_chunk(dp, B)
    # the tables as the kernel reads them: the panel's own, as the device
    # step passes them (every chunk below uses the panel's tc_all)
    tables = dp.tabs["tc_kernel"]
    check(torch.equal(tables, kernel_tables(dp.tabs["tc_all"])),
          "the panel's kernel tables are not kernel_tables(tc_all)")

    def compare(args, eval_on, what):
        got = screen_dp(*args, eval_on=eval_on, tables=tables)
        torch.cuda.synchronize()
        want = screen_dp_reference(*args, eval_on=eval_on)
        torch.cuda.synchronize()
        err = dp_errors(got, want, args, eval_on)
        wq = args[4].shape[1]
        print(f"screen_dp vs plain, {what}: B={args[0].shape[0]} "
              f"wq_max={wq} wt_max={wq + 8} nc_all={args[5].shape[0]} "
              f"eval_on={eval_on} (register width {kernel_width(wq + 8)}; "
              f"0 = rows in shared memory): max_abs_err={max(err)} "
              f"(best, mgmax, M_rows = {err})")
        check(max(err) == 0,
              f"screen_dp kernel disagrees with its plain version ({what})")
        return max(err)

    max_err = compare(args, dp.eval_on, "bench chunk, mixed slots")
    sargs, _, _ = bench_chunk(dp, B, slot_major=True)
    max_err = max(max_err, compare(sargs, dp.eval_on,
                                   "bench chunk, slot-major"))
    # the other paths: the bench's tables, random qpair rows at other widths
    rng = np.random.default_rng(20261016)
    widths = {}
    for wq, nb in OTHER_WIDTHS:
        qp = torch.from_numpy(
            rng.integers(0, 30, (12, wq)).astype(np.int32)).cuda()
        ql_slot = rng.integers(wq - 6, wq + 1, 12).astype(np.int32)
        oargs, _, _ = chunk_inputs(rng, nb, qp, ql_slot, dp.tabs["tc_all"],
                                   qp.device)
        for eval_on in (True, False):
            e = compare(oargs, eval_on, f"width path wt_max {wq + 8}")
            max_err = max(max_err, e)
        widths[str(wq + 8)] = kernel_width(wq + 8)

    def run_kernel():
        screen_dp(*args, eval_on=dp.eval_on, tables=tables)

    def run_plain():
        screen_dp_reference(*args, eval_on=dp.eval_on)

    # plain, kernel, kernel, plain
    p1 = cuda_ms(run_plain, 3, batches=1)
    k1 = cuda_ms(run_kernel, 20)
    k2 = cuda_ms(run_kernel, 20)
    p2 = cuda_ms(run_plain, 3, batches=1)
    k_ms = statistics.median([k1, k2])
    p_ms = statistics.median([p1, p2])
    print(f"screen_dp kernel: {k_ms:.4f} ms per 32768-window chunk "
          f"(runs {k1:.4f}, {k2:.4f}) on {card}")
    print(f"screen_dp plain PyTorch: {p_ms:.4f} ms per 32768-window chunk "
          f"(runs {p1:.4f}, {p2:.4f}) on {card}")
    # the same chunk without the eval outputs (no M-row store, no
    # gapped-best channel): what the recurrence and the table reads cost
    s_ms = cuda_ms(
        lambda: screen_dp(*args, eval_on=False, tables=tables), 20)
    print(f"screen_dp kernel with eval_on=False (same {nc_all} tables, no "
          f"M rows, no mgmax): {s_ms:.4f} ms per chunk on {card}")
    # the same windows in the order the device step streams them: a warp's
    # lanes then share their query pair and read one table row
    m_ms = cuda_ms(
        lambda: screen_dp(*sargs, eval_on=dp.eval_on, tables=tables), 20)
    ms_ms = cuda_ms(
        lambda: screen_dp(*sargs, eval_on=False, tables=tables), 20)
    print(f"screen_dp kernel, slot-major chunk: {m_ms:.4f} ms "
          f"(eval_on=False {ms_ms:.4f} ms) on {card}")

    # the bound, from what this chunk's data needs: invalid entries leave
    # the kernel at once, a valid one runs ql rows of wt_max columns for
    # every condition and stores ql M rows of wt_max + 1 words
    ok = slot < dp.n_real
    rows = int(np.minimum(ql, cfg.wq_max)[ok].sum())
    cells = rows * nc_all * wt_max
    n_eval = 1 if dp.eval_on else 0
    n_ops = rows * wt_max * ((nc_all - n_eval) * OPS_PER_CELL["screen"]
                             + n_eval * OPS_PER_CELL["eval"])
    n_bytes = (sum(a.numel() * a.element_size() for a in args)
               + 4 * (nc_all * B + B)
               + (4 * rows * (wt_max + 1) if dp.eval_on else 0))
    clock = sm_clock_hz(torch, run_kernel, k_ms)
    b_ms, b_by = bound_ms(n_bytes, n_ops, clock)
    print(f"screen_dp bound: {b_ms:.4f} ms by {b_by} ({cells} cells, "
          f"{OPS_PER_CELL['screen']} int32 ops a cell and "
          f"{OPS_PER_CELL['eval']} in the eval condition, at "
          f"{clock / 1e6:.0f} MHz; {n_bytes} bytes, "
          f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); kernel is at "
          f"{100 * b_ms / k_ms:.1f}% of it "
          f"(slot-major {100 * b_ms / m_ms:.1f}%) on {card}")
    return {"max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_eval_off": s_ms,
            "ms_slot_major": m_ms, "ms_slot_major_eval_off": ms_ms,
            "width_of_wt_max": {str(wt_max): kernel_width(wt_max),
                                **widths}}


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
    n_ops = cells * OPS_PER_CELL["screen"]
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops, clock)
    print(f"screen_probe sel30 bound: {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']} ({cells} cells x {OPS_PER_CELL['screen']} int32 "
          f"ops at {clock / 1e6:.0f} MHz; {n_bytes} bytes); kernel is at "
          f"{100 * out['bound_ms'] / out['ms']:.1f}% of it on {card}")
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
    from tntblast_tpu_torch.tools.bench_inputs import (
        BENCH_ARGS, bench_options)

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
        for line in _kernels.ptxas_summary(_kernels.build_log[name], "."):
            print(f"{name}: ptxas: {line}")
        bad = _kernels.ptxas_problems(_kernels.build_log[name])
        check(not bad, f"{name}: a DP row meant for registers went to "
                       f"local memory: {bad}")
    print("ptxas: 0 bytes of stack frame and spill in every kernel that "
          "keeps its DP row in registers")

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
