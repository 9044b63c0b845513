"""Time the design steps of the two DP kernels against each other.

    python -m tntblast_tpu_torch.tools.dp_steps [--parent-csrc DIR]
    python -m tntblast_tpu_torch.tools.dp_steps --sass-same DIR

builds csrc/screen_dp.cu and csrc/screen_probe.cu several times, each with
the build switches of one design step (see the notes at the top of the .cu
files), checks every variant bit for bit against the plain PyTorch version
and times it with CUDA events on one card, all in one process so the times
compare (each variant is timed twice, going through the list and back):

  screen_dp, one 32768-window chunk of the bench panel (bench_chunk), with
  its slots mixed at random and slot-major, with and without the eval
  condition's outputs:
    regs         rows in registers, ptb loaded a block at a time; table in
                 global memory (new layout), each thread stores its own M
                 row, plain max
    smem_table   + the condition's table in shared memory
    staged_store + M rows staged per warp and stored 16 bytes a lane
    dpx          + DPX add-max instructions: the kernel as it ships
  screen_probe, the TPU probe's shapes (tools/screen_probe.py):
    no_dpx, dpx (as it ships)

--parent-csrc names a directory with an earlier version of the two sources
(their launch functions without the width arguments and with tcan in place
of the kernel tables); it is timed first and last, as `parent`.  For every
variant the ptxas line and the SASS instruction mix of the width-32
instantiations are printed (cuobjdump), and one JSON line at the end holds
all times with the card's name and power limit.

--sass-same DIR times nothing: it builds both kernels as they ship from DIR
(an earlier version of the sources, any launch function) and from the tree,
and prints for each whether its SASS (every instruction of every
instantiation, cuobjdump) is the same; exit code 1 if one differs.  It
shows that a change to shared code left a kernel's instructions alone.
"""

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import threading

import torch

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch._kernels import ptxas_summary
from tntblast_tpu_torch.ops import screen_dp as dp_mod
from tntblast_tpu_torch.ops import screen_probe as probe_mod
from tntblast_tpu_torch.tools import screen_probe as probe_tool
from tntblast_tpu_torch.tools.bench_inputs import (
    bench_chunk, bench_panel, dp_errors)
from tntblast_tpu_torch.tools.screen_probe import card_name, cuda_ms

DP_VARIANTS = (
    ("regs", ["-DDP_TABLE_GLOBAL", "-DDP_DIRECT_STORE", "-DDP_NO_DPX"]),
    ("smem_table", ["-DDP_DIRECT_STORE", "-DDP_NO_DPX"]),
    ("staged_store", ["-DDP_NO_DPX"]),
    ("dpx", []),
)
PROBE_VARIANTS = (("no_dpx", ["-DDP_NO_DPX"]), ("dpx", []))

SASS_OPS = ("VIADDMNMX", "VIMNMX3", "VIMNMX", "IMNMX", "IADD3", "IMAD",
            "LOP3", "PRMT", "ISETP", "SEL", "LDS", "STS", "LDG", "STG", "LDL",
            "STL", "MOV")


def sass_mix(lib, pattern):
    """{kernel: Counter of SASS opcodes} for kernels matching `pattern`,
    counted over the kernel's longest loop (the span of its farthest
    backward branch: the DP row loop with its fully unrolled columns)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "cuobjdump")
    proc = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return {}
    return parse_sass(proc.stdout, pattern)


def parse_sass(text, pattern):
    """sass_mix on the text of `cuobjdump -sass`."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                kernels[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d\s+)?"
                     r"([A-Z0-9_]+)[^;]*?(?:(0x[0-9a-f]+)\s*)?;", line)
        if name and m:
            kernels[name].append((int(m.group(1), 16), m.group(2),
                                  m.group(3)))
    mix = {}
    for name, ins in kernels.items():
        lo, hi = 0, -1
        for addr, op, target in ins:
            if op == "BRA" and target and int(target, 16) < addr:
                if addr - int(target, 16) > hi - lo:
                    lo, hi = int(target, 16), addr
        body = [op for addr, op, _ in ins if lo <= addr <= hi]
        count = collections.Counter(op for op in body if op in SASS_OPS)
        count["row_loop_total"] = len(body)
        count["kernel_total"] = len(ins)
        mix[name] = count
    return mix


def sass_lines(lib):
    """The SASS of every kernel in `lib`: its function names and its
    instructions with their addresses (cuobjdump -sass), nothing that
    names the file."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    proc = subprocess.run([os.path.join(home, "bin", "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True, check=True)
    return [ln.strip() for ln in proc.stdout.splitlines()
            if re.search(r"Function : \w+|/\*[0-9a-f]{4,}\*/", ln)]


def sass_same(csrc):
    """0 when screen_dp and screen_probe built from `csrc` have the SASS
    of the tree's, else 1; a line a kernel."""
    names = ("screen_dp", "screen_probe")
    libs = build_all([(n, tag, [], d) for n in names
                      for tag, d in (("_sass_parent", csrc),
                                     ("_sass_tree", None))])
    rc = 0
    for n in names:
        old, new = (sass_lines(libs[n + t])
                    for t in ("_sass_parent", "_sass_tree"))
        same = old == new and len(new) > 0
        rc |= not same
        print(f"{n} SASS lines parent {len(old)} tree {len(new)} "
              f"{'identical' if same else 'differ'}", flush=True)
    return rc


def build_all(jobs):
    """Build (name, tag, flags, csrc) jobs in parallel; {tag: library}."""
    libs, errors = {}, {}

    def one(name, tag, flags, csrc):
        try:
            libs[name + tag] = _kernels.build(name, force=True, flags=flags,
                                              tag=tag, csrc=csrc)
        except Exception as e:      # noqa: BLE001 — reported below
            errors[name + tag] = e

    threads = [threading.Thread(target=one, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for key, e in errors.items():
        raise RuntimeError(f"{key} did not build: {e}")
    return libs


def parent_screen_dp(lib):
    """screen_dp through an earlier launch function (tcan, no width)."""
    fn = ctypes.CDLL(lib).screen_dp_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(ptb, slot, ql, wt_e, qp, tcan, *, eval_on):
        B, wt_max = ptb.shape
        n_real, wq_max = qp.shape
        nc_all = tcan.shape[0]
        dev = ptb.device
        best = torch.empty((nc_all, B), dtype=torch.int32, device=dev)
        mgmax = torch.empty((B,), dtype=torch.int32, device=dev)
        rows = (torch.empty((wq_max, B, wt_max + 1), dtype=torch.int32,
                            device=dev) if eval_on else None)
        rc = fn(ptb.data_ptr(), slot.data_ptr(), ql.data_ptr(),
                wt_e.data_ptr(), qp.data_ptr(), tcan.data_ptr(),
                best.data_ptr(), mgmax.data_ptr(),
                rows.data_ptr() if eval_on else None, B, wt_max, wq_max,
                nc_all, n_real, int(eval_on),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent screen_dp: CUDA error {rc}")
        return best, mgmax, rows
    return run


def parent_screen_probe(lib):
    """screen_probe through an earlier launch function (no width)."""
    fn = ctypes.CDLL(lib).screen_probe_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(meta, ptb, n_sel, *, wq_max, nc_all):
        n_blocks, wt_max, BB = ptb.shape
        best = torch.empty((n_blocks, nc_all, BB), dtype=torch.int32,
                           device=ptb.device)
        rc = fn(meta.data_ptr(), ptb.data_ptr(), best.data_ptr(), n_blocks,
                BB, wt_max, wq_max, nc_all, n_sel,
                torch.cuda.current_stream(ptb.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent screen_probe: CUDA error {rc}")
        return best
    return run


def with_library(name, lib, fn):
    """fn() with the package's kernel `name` loaded from `lib`."""
    saved = _kernels._libs.get(name)
    _kernels._libs[name] = ctypes.CDLL(lib)
    try:
        return fn()
    finally:
        if saved is None:
            del _kernels._libs[name]
        else:
            _kernels._libs[name] = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--sass-same", default=None, metavar="DIR")
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_steps: no CUDA device", file=sys.stderr)
        return 2
    if opts.sass_same:
        print(card_name())
        return sass_same(opts.sass_same)
    sys.path.insert(0, os.getcwd())
    import bench_data
    from tntblast_tpu_torch.parallel.device_search import SCREEN_CHUNK

    card = card_name()
    print(card)
    jobs = [("screen_dp", f"_{tag}", flags, None)
            for tag, flags in DP_VARIANTS]
    jobs += [("screen_probe", f"_{tag}", flags, None)
             for tag, flags in PROBE_VARIANTS]
    if opts.parent_csrc:
        jobs += [(n, "_parent", [], opts.parent_csrc)
                 for n in ("screen_dp", "screen_probe")]
    libs = build_all(jobs)
    for name, tag, _, _ in jobs:
        key = name + tag
        for line in ptxas_summary(_kernels.build_log[key],
                                  r"Li32E|kernelP"):
            print(f"ptxas {key} {line}")
        for kern, mix in sass_mix(libs[key], r"Li32E|kernelP").items():
            print(f"sass {key} {kern} {dict(mix)}")

    fna, panel = bench_data.build(os.path.join(os.getcwd(), "bench_work"))
    dp = bench_panel(fna, panel)
    args, _, _ = bench_chunk(dp, SCREEN_CHUNK)
    want = dp_mod.screen_dp_reference(*args, eval_on=dp.eval_on)
    # the same windows in the order of the device step's pooled stream
    sargs, _, _ = bench_chunk(dp, SCREEN_CHUNK, slot_major=True)
    swant = dp_mod.screen_dp_reference(*sargs, eval_on=dp.eval_on)
    times = {}

    def time_dp(label, run):
        err = (dp_errors(run(*args, eval_on=dp.eval_on), want, args,
                         dp.eval_on)
               + dp_errors(run(*sargs, eval_on=dp.eval_on), swant, sargs,
                           dp.eval_on))
        res = {"max_abs_err": max(err)}
        for key, a in (("", args), ("_slot_major", sargs)):
            res["ms" + key] = cuda_ms(
                lambda: run(*a, eval_on=dp.eval_on), opts.reps)
            res["ms_eval_off" + key] = cuda_ms(
                lambda: run(*a, eval_on=False), opts.reps)
        times.setdefault(f"screen_dp {label}", []).append(res)
        print(f"screen_dp {label}: mixed slots {res['ms']:.4f} ms per chunk "
              f"(eval_on=False {res['ms_eval_off']:.4f}), slot-major "
              f"{res['ms_slot_major']:.4f} ms (eval_on=False "
              f"{res['ms_eval_off_slot_major']:.4f}), max_abs_err "
              f"{max(err)} on {card}", flush=True)

    tables = dp.tabs["tc_kernel"]       # as the device step passes them

    def shipped(*a, eval_on):
        return dp_mod.screen_dp(*a, eval_on=eval_on, tables=tables)

    order = [t for t, _ in DP_VARIANTS]
    if opts.parent_csrc:
        time_dp("parent", parent_screen_dp(libs["screen_dp_parent"]))
    for tag in order + order[::-1]:     # there and back: drift shows
        with_library("screen_dp", libs[f"screen_dp_{tag}"],
                     lambda: time_dp(tag, shipped))
    if opts.parent_csrc:
        time_dp("parent", parent_screen_dp(libs["screen_dp_parent"]))

    meta_np, ptb_np = probe_tool.probe_inputs()
    meta = torch.from_numpy(meta_np).cuda()
    ptb = torch.from_numpy(ptb_np).cuda()
    kw = dict(wq_max=probe_tool.WQ_MAX, nc_all=probe_tool.NC_ALL)

    def time_probe(label, run):
        res = {}
        for name, n_sel in probe_tool.VARIANTS:
            ref = probe_mod.screen_probe_reference(meta, ptb, n_sel, **kw)
            got = run(meta, ptb, n_sel, **kw)
            res[f"max_abs_err_{name}"] = int(
                (got.long() - ref.long()).abs().max())
            res[f"ms_{name}"] = cuda_ms(
                lambda: run(meta, ptb, n_sel, **kw), opts.reps)
        times.setdefault(f"screen_probe {label}", []).append(res)
        print(f"screen_probe {label}: {res} on {card}", flush=True)

    porder = [t for t, _ in PROBE_VARIANTS]
    if opts.parent_csrc:
        time_probe("parent", parent_screen_probe(libs["screen_probe_parent"]))
    for tag in porder + porder[::-1]:
        with_library("screen_probe", libs[f"screen_probe_{tag}"],
                     lambda: time_probe(tag, probe_mod.screen_probe))
    if opts.parent_csrc:
        time_probe("parent", parent_screen_probe(libs["screen_probe_parent"]))
    print(json.dumps({"card": card, "times": times}))
    bad = [k for k, runs in times.items() for v in runs
           if any(val for key, val in v.items() if "err" in key)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
