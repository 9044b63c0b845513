"""The screening DP over a flat mixed-slot window stream.

`screen_dp` launches the hand-written Hopper kernel (csrc/screen_dp.cu) on
CUDA tensors; on CPU tensors it runs `screen_dp_reference`, the plain
PyTorch version and the kernel's spec.  Both replace
tntblast_tpu/ops/pallas_screen.py::_screen_kernel and the XLA row scan of
tntblast_tpu/parallel/device_search.py run_chunk.

Inputs (B windows):
  ptb   (B, wt_max) int32  target-pair index pt6*5+tb5 per column, in [0, 30)
  slot  (B,) int32         oligo-strand slot; outside [0, n_real) = invalid
  ql    (B,) int32         oligo length (DP rows used)
  wt_e  (B,) int32         window width (columns that count for the maxima)
  qp    (n_real, wq_max) int32  per-slot qpair rows (build_qpair_rows)
  tcan  (nc_all, 30, 30, 7) int32  canonical tables of every condition,
                           the eval condition last when eval_on
Outputs (the run_chunk contract):
  best  (nc_all, B) int32  per-condition max M score (-1 if invalid)
  mgmax (B,) int32         max of the eval condition's gapped-best channel
                           (-(1 << 29) if invalid or eval_on is False)
  M_rows (wq_max, B, wt_max+1) int32 or None
                           the eval condition's M rows with the -1 boundary
                           column 0; rows >= ql are out of contract
"""

import ctypes

import torch

NEG_I32 = -(1 << 29)
NUM_PAIR = 30
MAX_WT = 128        # widest window the kernel holds (MAX_WT1 - 1 in the .cu)


def _relu(x):
    return torch.clamp_min(x, 0)


def _pad_left(x, fill):
    """`fill` as a new column 0 in front of x (last axis)."""
    return torch.cat([torch.full_like(x[..., :1], fill), x], dim=-1)


def screen_dp_reference(ptb, slot, ql, wt_e, qp, tcan, *, eval_on):
    """Plain PyTorch screen DP (the row scan of device_search.run_chunk,
    energies gathered from T_canon instead of one-hot matmuls)."""
    B, wt_max = ptb.shape
    n_real, wq_max = qp.shape
    nc_all = tcan.shape[0]
    dev = ptb.device
    i32 = torch.int32
    valid = (slot >= 0) & (slot < n_real)
    s = slot.clamp(0, max(n_real - 1, 0)).long()
    qpe = (qp[s] if n_real else torch.zeros((B, wq_max), dtype=i32,
                                            device=dev)).clamp(0, 29)
    tflat = tcan.reshape(nc_all, NUM_PAIR * NUM_PAIR, 7)
    pt30 = ptb.clamp(0, 29).long() * NUM_PAIR
    col_ok = (torch.arange(wt_max, device=dev)[None, :] < wt_e[:, None])

    prevM = torch.full((nc_all, B, wt_max + 1), -1, dtype=i32, device=dev)
    prevIq = prevM.clone()
    prevIt = prevM.clone()
    best = torch.full((nc_all, B), -1, dtype=i32, device=dev)
    prevMg = torch.full((B, wt_max + 1), NEG_I32, dtype=i32, device=dev)
    mgmax = torch.full((B,), NEG_I32, dtype=i32, device=dev)
    rows = []
    for r in range(wq_max):
        rv = r < ql
        mvalid = col_ok & rv[:, None]
        e = tflat[:, pt30 + qpe[:, r:r + 1].long()]       # (nc, B, wt, 7)
        dgmm, dgmq, dgmt = e[..., 0], e[..., 1], e[..., 2]
        dgqi, dgqe = e[..., 3], e[..., 4]
        dgti, dgte = e[..., 5], e[..., 6]
        m = torch.maximum(
            torch.maximum(_relu(prevM[..., :-1]) - dgmm,
                          _relu(prevIq[..., :-1]) - dgmq),
            _relu(prevIt[..., :-1]) - dgmt)
        it = torch.maximum(_relu(prevM[..., 1:]) - dgti,
                           _relu(prevIt[..., 1:]) - dgte)
        a = torch.maximum(_relu(_pad_left(m[..., :-1], -1)) - dgqi, -dgqe)
        # I_query prefix recurrence iq[j] = max(a[j], iq[j-1] - dgqe[j])
        # in its exact int32 cumsum/cummax form
        ssum = torch.cumsum(dgqe, dim=2, dtype=i32)
        iq = torch.cummax(a + ssum, dim=2).values - ssum
        best = torch.maximum(
            best, torch.where(mvalid[None], m, -1).amax(dim=2))
        if eval_on:
            pMg = prevMg[:, :-1]
            g1 = torch.where(pMg >= 0, pMg - dgmm[-1], NEG_I32)
            mg = torch.maximum(
                torch.maximum(g1, _relu(prevIq[-1, :, :-1]) - dgmq[-1]),
                _relu(prevIt[-1, :, :-1]) - dgmt[-1])
            mgmax = torch.maximum(
                mgmax, torch.where(mvalid, mg, NEG_I32).amax(dim=1))
            prevMg = _pad_left(mg, NEG_I32)
        prevM = _pad_left(m, -1)
        prevIq = _pad_left(iq, -1)
        prevIt = _pad_left(it, -1)
        if eval_on:
            rows.append(prevM[-1])
    best = torch.where(valid[None], best, -1)
    mgmax = torch.where(valid, mgmax, NEG_I32)
    M_rows = torch.stack(rows) if eval_on else None
    return best, mgmax, M_rows


def _launcher():
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("screen_dp")
    fn = lib.screen_dp_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, device, ndim):
    if t.device != device:
        raise ValueError(f"screen_dp: {name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"screen_dp: {name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"screen_dp: {name} must be {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"screen_dp: {name} must be contiguous")


def screen_dp(ptb, slot, ql, wt_e, qp, tcan, *, eval_on):
    """The screen DP: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see the module docstring for the contract)."""
    dev = ptb.device
    if dev.type == "cpu":
        return screen_dp_reference(ptb, slot, ql, wt_e, qp, tcan,
                                   eval_on=eval_on)
    if dev.type != "cuda":
        raise ValueError(f"screen_dp: unsupported device {dev}")
    for name, t, nd in (("ptb", ptb, 2), ("slot", slot, 1), ("ql", ql, 1),
                        ("wt_e", wt_e, 1), ("qp", qp, 2), ("tcan", tcan, 4)):
        _check(name, t, dev, nd)
    B, wt_max = ptb.shape
    n_real, wq_max = qp.shape
    nc_all = tcan.shape[0]
    if slot.shape[0] != B or ql.shape[0] != B or wt_e.shape[0] != B:
        raise ValueError("screen_dp: per-window inputs disagree on B")
    if tuple(tcan.shape[1:]) != (NUM_PAIR, NUM_PAIR, 7):
        raise ValueError(f"screen_dp: tcan shape {tuple(tcan.shape)}")
    if wt_max > MAX_WT:
        raise ValueError(f"screen_dp: wt_max {wt_max} > {MAX_WT}")
    best = torch.empty((nc_all, B), dtype=torch.int32, device=dev)
    mgmax = torch.empty((B,), dtype=torch.int32, device=dev)
    M_rows = (torch.empty((wq_max, B, wt_max + 1), dtype=torch.int32,
                          device=dev) if eval_on else None)
    if B == 0:
        return best, mgmax, M_rows
    fn = _launcher()
    with torch.cuda.device(dev):     # the launch goes to the tensors' card
        rc = fn(
            ptb.data_ptr(), slot.data_ptr(), ql.data_ptr(), wt_e.data_ptr(),
            qp.data_ptr(), tcan.data_ptr(), best.data_ptr(),
            mgmax.data_ptr(), M_rows.data_ptr() if eval_on else None,
            B, wt_max, wq_max, nc_all, n_real, int(bool(eval_on)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"screen_dp kernel launch failed: CUDA error {rc}")
    screen_dp.launches += 1
    return best, mgmax, M_rows


screen_dp.launches = 0
