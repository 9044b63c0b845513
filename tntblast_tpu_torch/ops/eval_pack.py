"""The evaluation stage of the device step: trust decision, exact gapless
evaluation and the five packed int32 words of every entry of a chunk.

`eval_pack` launches the hand-written Hopper kernel (csrc/eval_pack.cu) on
CUDA tensors; on CPU tensors it runs `eval_pack_reference`, the plain
PyTorch version and the kernel's spec: ops/eval_gapless.py::eval_flat
followed by the word packing.  Together they stand where the JAX package has
tntblast_tpu/ops/eval_gapless_jax.py::eval_flat and pack_eval
(tntblast_tpu/parallel/device_search.py), fused by XLA inside the jitted
step; there is no Pallas original.

Inputs (B entries of a chunk):
  M_rows  (wq_max, B, wt_max+1) int32  the eval condition's M rows from
                     screen_dp; rows >= ql[b] and columns > wt_s[b] are
                     unwritten and never read
  mg_max  (B,) int32   gapped-best channel max
  tcodes  (B, wt_max) int32  oriented window codes in {0..5}
  slot    (B,) int32   oligo-strand slot; clamped into qc / the tables
  ql      (B,) int32   oligo length, 0 <= ql <= wq_max
  wt_s    (B,) int32   window width
  needs_host, ent_valid  (B,) bool
  qc      (n_q, wq_max) int32  query melt codes per slot (0 beyond ql)
  ev_tabs (S, wq_max, 25, 4) f32, ev_loop2m (S, wq_max + 2) f32,
  eval_const (AT_H, AT_S, init_H, init_S)
Output: (B, 5) int32 words w0..w4 (w3/w4 the bit patterns of dH/dS, see
`pack_eval`).  An entry with ent_valid False gets five zeros: nothing reads
its words, the JAX step's skipped chunks hold zeros there, and its M rows
are unwritten.

The kernel has one launch path, `EvalPackPlan(qc, ev_tabs, ev_loop2m,
eval_const)`, counted in `eval_pack.launches`: it checks the panel's part
once, when the panel uploads its tables, and then takes a chunk's eight
tensors without a check (the lean call of the device step).
`eval_pack(...)`, the checked call, tests every argument on every call and
then launches through a plan of its own (the tests, chip_smoke.py and
entry.py use it).
"""

import ctypes

import torch

from tntblast_tpu_torch.ops.eval_gapless import eval_flat

_I32 = torch.int32
_I64 = torch.int64


def _wrap32(x):
    """int64 -> int32 keeping the low 32 bits (int32 wraparound)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(_I32)


def pack_eval(ev, needs_host, ent_valid):
    """The five packed int32 eval words per entry (JAX pack_eval)."""
    trusted = ev["trusted"] & ~needs_host & ent_valid
    w0 = (trusted.to(_I32)
          | (ev["tm_zero"].to(_I32) << 1)
          | (ev["num_base"].clamp(0, 255) << 2)
          | (ev["mm"].clamp(0, 63) << 10)
          | (ev["align_len"].clamp(0, 63) << 16))
    w1 = _wrap32((ev["fm_q"].to(_I64) & 0xFF)
                 | ((ev["fm_t"].to(_I64) & 0xFF) << 8)
                 | ((ev["lm_q"].to(_I64) & 0xFF) << 16)
                 | ((ev["lm_t"].to(_I64) & 0xFF) << 24))
    w2 = ((ev["anchor5"] & 0xFF) | ((ev["anchor3"] & 0xFF) << 8))
    w3 = ev["dH"].view(_I32)
    w4 = ev["dS"].view(_I32)
    return torch.stack([w0.to(_I32), w1, w2.to(_I32), w3, w4], dim=1)


def eval_pack_reference(M_rows, mg_max, tcodes, slot, ql, wt_s, needs_host,
                        ent_valid, qc, ev_tabs, ev_loop2m, eval_const):
    """Plain PyTorch version: eval_flat, pack_eval, zeros where the entry is
    not valid."""
    s = slot.long()
    ev = eval_flat(M_rows, mg_max, tcodes, qc[s.clamp(0, qc.shape[0] - 1)],
                   ql, wt_s, s.clamp(0, ev_tabs.shape[0] - 1), ev_tabs,
                   ev_loop2m, eval_const)
    words = pack_eval(ev, needs_host, ent_valid)
    return torch.where(ent_valid[:, None], words, 0)


def _library():
    """The kernel's ctypes library, its entry points typed."""
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("eval_pack")
    if lib.eval_pack_launch_plan.argtypes is None:
        bind(lib)
    return lib


def bind(lib):
    """Sets the argument types of the entry points of an eval_pack library
    (the package's, or the CPU tests' host build)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.eval_pack_plan.argtypes = [P] * 4 + [I] * 4 + [F] * 4 + [I]
    lib.eval_pack_launch_plan.argtypes = [P] * 10 + [I, P]
    lib.eval_pack_layout.argtypes = [I, I, P]
    lib.eval_pack_layout.restype = None
    for fn in (lib.eval_pack_plan, lib.eval_pack_launch_plan,
               lib.eval_pack_plan_bytes):
        fn.restype = ctypes.c_int
    return lib


LAYOUT_KEYS = ("pitch", "stage", "slots", "tpitch", "tb5", "warps", "smem",
               "carveout", "piece", "bits")


def layout(wt_max, blocks=2, lib=None):
    """The kernel's staging layout at window width `wt_max`: dict of pitch
    (words from a lane's M row to the next lane's in shared memory, odd),
    stage (words of a row buffer), slots (row buffers of a warp), tpitch and
    tb5 (the same for the warp's window codes, and their words; 0: the
    codes are read in place), warps (a block's; 0: the width is refused),
    smem (dynamic shared memory of a block, bytes), carveout (the percent
    of an SM's shared memory the kernel asks for when `blocks` blocks share
    an SM, as a 32768-entry chunk's do on 132 SMs; the rest is L1) and
    piece (the columns of each lane's row a buffer holds: wt_max + 1 up to
    a window of 128, then pieces) and bits (the words of a warp's pair bits
    in shared memory: 0 up to wq_max 128, where they fit registers)."""
    out = (ctypes.c_int * len(LAYOUT_KEYS))()
    (lib or _library()).eval_pack_layout(wt_max, blocks, out)
    return dict(zip(LAYOUT_KEYS, out))


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"eval_pack: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"eval_pack: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"eval_pack: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"eval_pack: {name} must be contiguous")


def eval_pack(M_rows, mg_max, tcodes, slot, ql, wt_s, needs_host, ent_valid,
              qc, ev_tabs, ev_loop2m, eval_const):
    """The evaluation stage: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring for the contract)."""
    dev = M_rows.device
    chunk = (M_rows, mg_max, tcodes, slot, ql, wt_s, needs_host, ent_valid)
    if dev.type == "cpu":
        return eval_pack_reference(*chunk, qc, ev_tabs, ev_loop2m, eval_const)
    if dev.type != "cuda":
        raise ValueError(f"eval_pack: unsupported device {dev}")
    plan = EvalPackPlan(qc, ev_tabs, ev_loop2m, eval_const)
    if M_rows.dim() != 3:
        raise ValueError("eval_pack: M_rows must be 3-D")
    if plan.device != dev:
        raise ValueError(f"eval_pack: tables on {plan.device}, M_rows on "
                         f"{dev}")
    B, w1 = M_rows.shape[1:]
    if w1 < 2:
        raise ValueError(f"eval_pack: M_rows shape {tuple(M_rows.shape)}")
    for name, t, dtype, shape in (
            ("M_rows", M_rows, _I32, (plan.wq_max, B, w1)),
            ("mg_max", mg_max, _I32, (B,)),
            ("tcodes", tcodes, _I32, (B, w1 - 1)),
            ("slot", slot, _I32, (B,)), ("ql", ql, _I32, (B,)),
            ("wt_s", wt_s, _I32, (B,)),
            ("needs_host", needs_host, torch.bool, (B,)),
            ("ent_valid", ent_valid, torch.bool, (B,))):
        _check(name, t, dev, dtype, shape)
    return plan(*chunk)


eval_pack.launches = 0


class EvalPackPlan:
    """The kernel's one launch path: a panel's tables (`qc`, `ev_tabs`,
    `ev_loop2m` on one card) and its constants, checked once, here, and
    laid out once for each window width on its first call.  A call then
    takes one chunk's

        M_rows (wq_max, B, wt_max+1), mg_max, tcodes (B, wt_max), slot, ql,
        wt_s, needs_host, ent_valid

    on the plan's card, contiguous, in the dtypes of `eval_pack`, and reads
    only their pointers and M_rows' shape: the device step (panel_step_core)
    guarantees the rest, `eval_pack` checks it.  It launches on the current
    stream, read each call (a stream a caller or a graph capture sets is
    honoured), and raises when the launch fails; there is no plain
    fallback, and CPU tensors are refused (a CPU panel calls `eval_pack`,
    which runs the plain version)."""

    def __init__(self, qc, ev_tabs, ev_loop2m, eval_const):
        dev = qc.device
        if dev.type != "cuda":
            raise ValueError(f"EvalPackPlan: tables on {dev}; the plan "
                             "serves a card")
        if qc.dim() != 2 or ev_tabs.dim() != 4:
            raise ValueError("EvalPackPlan: qc, ev_tabs must be 2-D, 4-D")
        wq_max, n_q, n_slots = qc.shape[1], qc.shape[0], ev_tabs.shape[0]
        for name, t, dtype, shape in (
                ("qc", qc, _I32, (n_q, wq_max)),
                ("ev_tabs", ev_tabs, torch.float32, (n_slots, wq_max, 25, 4)),
                ("ev_loop2m", ev_loop2m, torch.float32,
                 (n_slots, wq_max + 2))):
            _check(name, t, dev, dtype, shape)
        if wq_max < 1 or n_q < 1 or n_slots < 1:
            raise ValueError(f"eval_pack: empty tables: wq_max {wq_max}, "
                             f"{n_q} query rows, {n_slots} slots")
        if ev_tabs.data_ptr() % 16:
            raise ValueError("eval_pack: ev_tabs must be 16-byte aligned")
        lib = _library()
        self.device, self.index = dev, dev.index    # a tensor's: indexed
        self.wq_max = wq_max
        self._tables = (qc, ev_tabs, ev_loop2m)    # kept alive with the plan
        self._const = tuple(float(c) for c in eval_const)
        self._plans = {}                            # w1 -> the C plan
        self._lib = lib
        self._launch = lib.eval_pack_launch_plan
        self._stream = torch._C._cuda_getCurrentRawStream

    def _lay_out(self, wq_max, w1):
        """The C plan of window width w1 - 1 (built on its first call)."""
        if wq_max != self.wq_max:
            raise ValueError(f"EvalPackPlan: M_rows of {wq_max} rows, the "
                             f"tables' wq_max is {self.wq_max}")
        qc, ev_tabs, ev_loop2m = self._tables
        lib = self._lib
        plan = (ctypes.c_uint64 * -(-lib.eval_pack_plan_bytes() // 8))()
        rc = lib.eval_pack_plan(plan, qc.data_ptr(), ev_tabs.data_ptr(),
                                ev_loop2m.data_ptr(), wq_max, w1 - 1,
                                qc.shape[0], ev_tabs.shape[0], *self._const,
                                self.index)
        if rc != 0:
            raise ValueError(f"EvalPackPlan: the kernel refuses wq_max "
                             f"{wq_max}, wt_max {w1 - 1}: CUDA error {rc}")
        self._plans[w1] = plan
        return plan

    def __call__(self, M_rows, mg_max, tcodes, slot, ql, wt_s, needs_host,
                 ent_valid):
        if not M_rows.is_cuda:
            raise ValueError("EvalPackPlan: CPU tensors (call eval_pack)")
        wq_max, B, w1 = M_rows.shape
        plan = self._plans.get(w1)
        if plan is None or wq_max != self.wq_max:
            plan = self._lay_out(wq_max, w1)
        out = torch.empty((B, 5), dtype=_I32, device=self.device)
        if B == 0:
            return out
        rc = self._launch(
            plan, M_rows.data_ptr(), mg_max.data_ptr(),
            tcodes.data_ptr(), slot.data_ptr(), ql.data_ptr(),
            wt_s.data_ptr(), needs_host.data_ptr(), ent_valid.data_ptr(),
            out.data_ptr(), B, self._stream(self.index))
        if rc != 0:
            raise RuntimeError(
                f"eval_pack kernel launch failed: CUDA error {rc}")
        eval_pack.launches += 1
        return out
