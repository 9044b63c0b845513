"""Time the evaluator kernel against earlier versions of its source.

    python -m tntblast_tpu_torch.tools.eval_steps [--parent-csrc DIR]
                                                  [--design-csrc DIR]

checks csrc/eval_pack.cu as it ships, and each earlier build it is asked
for, bit for bit against the plain PyTorch version and times them on one
card, all in one process so the times compare (each build is timed twice,
going through the list and back).  The input is one 32768-entry chunk of
the bench panel behind the screen_dp kernel (bench_eval_chunk), with its
slots mixed at random and slot-major.

--parent-csrc names a directory with an earlier version of the sources,
timed first and last as `parent`.  --design-csrc names a directory with the
sources of commit ddb6f4f, in which each design step of the staged kernel
was a build switch of eval_pack.cu; it is built once a step:

    word_copy      M rows staged per warp through shared memory, every span
                   copied word by word into the odd pitch; double buffered;
                   the diagonal walked one cell at a time, the window codes
                   read from device memory, complementarity tested anew in
                   every loop; each lane stores its own words; the default
                   split of L1 and shared memory
    vec_copy       + spans of an odd pitch copied as their image, 16 bytes
                   a lane
    three_stages   + a ring of three row buffers (two rows in flight)
    staged_store   + the warp's words stored as one span
    batched_walk   + the diagonal's cells loaded eight at a time
    staged_codes   + the warp's window codes staged in shared memory with
                   its first row
    pair_bits      + complementarity computed once a query index, as bits
    l1_carveout    + shared memory for the blocks of a wave, the rest L1:
                   the design as it ships
    retained_walk  every row of a warp kept in shared memory and the
                   diagonal walked there
    scan_only      the M rows staged and scanned, no evaluation (words not
                   eval_pack's, not checked)
    eval_only      no M row copied, steps 2-5 from each entry's last cell
                   (words not checked)

An earlier version launches through its plan where it has one, else
through the entry point eval_pack_launch that the design steps' commit
had; to make a directory, unpack the commit's sources:
`git archive <commit> tntblast_tpu_torch/csrc | tar -x -C DIR
--strip-components=2`.  Times are kernel time alone: 20 launches captured
in a CUDA graph, replayed between CUDA events (tools/screen_probe.py
graph_ms).  Every build's ptxas line is printed, and one JSON line at the
end holds all times with the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import sys

import torch

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch._kernels import ptxas_summary
from tntblast_tpu_torch.ops import eval_pack as ep
from tntblast_tpu_torch.tools.bench_inputs import (
    bench_eval_chunk, bench_panel, eval_stage_args)
from tntblast_tpu_torch.tools.dp_steps import build_all, with_library
from tntblast_tpu_torch.tools.screen_probe import card_name, graph_ms

_NO = ["-DEVAL_COMP_LOOPS", "-DEVAL_NO_CARVEOUT"]
_SERIAL = ["-DEVAL_TB5_GLOBAL", "-DEVAL_WALK_SERIAL", *_NO]
DESIGN_STEPS = (
    ("word_copy", ["-DEVAL_WORD_COPY", "-DEVAL_STAGES=2",
                   "-DEVAL_DIRECT_STORE", *_SERIAL]),
    ("vec_copy", ["-DEVAL_STAGES=2", "-DEVAL_DIRECT_STORE", *_SERIAL]),
    ("three_stages", ["-DEVAL_DIRECT_STORE", *_SERIAL]),
    ("staged_store", _SERIAL),
    ("batched_walk", ["-DEVAL_TB5_GLOBAL", *_NO]),
    ("staged_codes", _NO),
    ("pair_bits", ["-DEVAL_NO_CARVEOUT"]),
    ("l1_carveout", []),
    ("retained_walk", ["-DEVAL_RETAIN"]),
    ("scan_only", ["-DEVAL_SCAN_ONLY"]),
    ("eval_only", ["-DEVAL_EVAL_ONLY"]),
)
UNCHECKED = {"scan_only", "eval_only"}


def earlier_launcher(lib_path, tabs, eval_const):
    """An earlier build's launch as fn(args, eval_const) on the current
    stream: through a plan (EvalPackPlan on that library) where it has
    one, else through its entry point eval_pack_launch (all arguments a
    call; the design steps' commit)."""
    lib = ctypes.CDLL(lib_path)
    if not hasattr(lib, "eval_pack_launch"):
        plan = with_library("eval_pack", lib_path,
                            lambda: ep.EvalPackPlan(*tabs, eval_const))
        return lambda args, const: plan(*args[:8])
    fn = lib.eval_pack_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(args, eval_const):
        wq_max, B, w1 = args[0].shape
        out = torch.empty((B, 5), dtype=torch.int32, device=args[0].device)
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, wq_max,
                w1 - 1, args[8].shape[0], args[9].shape[0],
                *(float(c) for c in eval_const),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"eval_pack (earlier build): CUDA error {rc}")
        return out
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-csrc", default=None)
    ap.add_argument("--design-csrc", default=None)
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("eval_steps: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import bench_data
    from tntblast_tpu_torch.parallel.device_search import SCREEN_CHUNK

    card = card_name()
    print(card)
    jobs = [("eval_pack", "_shipped", [], None)]
    if opts.parent_csrc:
        jobs.append(("eval_pack", "_parent", [], opts.parent_csrc))
    if opts.design_csrc:
        jobs += [("eval_pack", f"_{tag}", flags, opts.design_csrc)
                 for tag, flags in DESIGN_STEPS]
    libs = build_all(jobs)
    for name, tag, _, _ in jobs:
        for line in ptxas_summary(_kernels.build_log[name + tag],
                                  "eval_pack"):
            print(f"ptxas {name + tag} {line}")

    fna, panel = bench_data.build(os.path.join(os.getcwd(), "bench_work"))
    dp = bench_panel(fna, panel)
    st = dp.tabs["slots"]
    tabs = (st["qc"], dp.tabs["ev_tabs"], dp.tabs["ev_loop"])
    chunks = {
        key: eval_stage_args(bench_eval_chunk(dp, SCREEN_CHUNK,
                                              slot_major=sm),
                             *tabs, dp.tabs["tc_kernel"])
        for key, sm in (("", False), ("_slot_major", True))}
    wants = {key: ep.eval_pack_reference(*a, dp.eval_const)
             for key, a in chunks.items()}
    # the shipped kernel through its one launch path, a plan made on the
    # build above
    plan = with_library("eval_pack", libs["eval_pack_shipped"],
                        lambda: ep.EvalPackPlan(*tabs, dp.eval_const))
    lay = ep.layout(dp.config.wq_max + 8,
                    lib=ep.bind(ctypes.CDLL(libs["eval_pack_shipped"])))
    print(f"layout of the shipped kernel at the bench shapes: {lay}")
    runs = {"shipped": lambda a, const: plan(*a[:8])}
    for name, tag, _, _ in jobs[1:]:
        runs[tag[1:]] = earlier_launcher(libs[name + tag], tabs,
                                         dp.eval_const)
    times = {}

    def time_build(label):
        run = runs[label]
        res = {}
        for key, a in chunks.items():
            got = run(a, dp.eval_const)
            torch.cuda.synchronize()
            res["n_bad" + key] = int((got != wants[key]).any(dim=1).sum())
            res["ms" + key] = graph_ms(lambda: run(a, dp.eval_const),
                                       opts.reps)
        times.setdefault(label, []).append(res)
        print(f"eval_pack {label}: mixed slots {res['ms']:.4f} ms per "
              f"chunk, slot-major {res['ms_slot_major']:.4f} ms (kernel "
              f"alone, graph of {opts.reps}), entries differing "
              f"{res['n_bad']} / {res['n_bad_slot_major']} on {card}",
              flush=True)

    # the parent first and last, the shipped kernel in the middle
    order = [t[1:] for _, t, _, _ in jobs[1:]] + ["shipped"]
    for label in order + order[::-1]:   # there and back: drift shows
        time_build(label)
    print(json.dumps({"card": card, "times": times}))
    bad = [k for k, rs in times.items() if k not in UNCHECKED for v in rs
           if any(val for key, val in v.items() if key.startswith("n_bad"))]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
