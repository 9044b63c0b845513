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


def _launcher():
    from tntblast_tpu_torch import _kernels
    fn = _kernels.load("eval_pack").eval_pack_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
    args = (M_rows, mg_max, tcodes, slot, ql, wt_s, needs_host, ent_valid,
            qc, ev_tabs, ev_loop2m)
    if dev.type == "cpu":
        return eval_pack_reference(*args, eval_const)
    if dev.type != "cuda":
        raise ValueError(f"eval_pack: unsupported device {dev}")
    if M_rows.dim() != 3 or qc.dim() != 2 or ev_tabs.dim() != 4:
        raise ValueError("eval_pack: M_rows, qc, ev_tabs must be 3-D, 2-D, "
                         "4-D")
    wq_max, B, w1 = M_rows.shape
    n_q, n_slots = qc.shape[0], ev_tabs.shape[0]
    f32 = torch.float32
    for name, t, dtype, shape in (
            ("M_rows", M_rows, _I32, (wq_max, B, w1)),
            ("mg_max", mg_max, _I32, (B,)),
            ("tcodes", tcodes, _I32, (B, w1 - 1)),
            ("slot", slot, _I32, (B,)), ("ql", ql, _I32, (B,)),
            ("wt_s", wt_s, _I32, (B,)),
            ("needs_host", needs_host, torch.bool, (B,)),
            ("ent_valid", ent_valid, torch.bool, (B,)),
            ("qc", qc, _I32, (n_q, wq_max)),
            ("ev_tabs", ev_tabs, f32, (n_slots, wq_max, 25, 4)),
            ("ev_loop2m", ev_loop2m, f32, (n_slots, wq_max + 2))):
        _check(name, t, dev, dtype, shape)
    if w1 < 2 or wq_max < 1 or n_q < 1 or n_slots < 1:
        raise ValueError(f"eval_pack: empty shape in {tuple(M_rows.shape)}, "
                         f"{n_q} query rows, {n_slots} slots")
    if ev_tabs.data_ptr() % 16:
        raise ValueError("eval_pack: ev_tabs must be 16-byte aligned")
    out = torch.empty((B, 5), dtype=_I32, device=dev)
    if B == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):     # the launch goes to the tensors' card
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, wq_max,
                w1 - 1, n_q, n_slots, *(float(c) for c in eval_const),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eval_pack kernel launch failed: CUDA error {rc}")
    eval_pack.launches += 1
    return out


eval_pack.launches = 0
