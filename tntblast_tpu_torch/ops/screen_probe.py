"""Probe of the screening DP: the recurrence with synthetic energies.

`screen_probe` launches the hand-written Hopper kernel
(csrc/screen_probe.cu) on CUDA tensors; on CPU tensors it runs
`screen_probe_reference`, the plain PyTorch version and the kernel's spec.
Both replace tools/tpu_pallas_probe2.py::mk_kernel, whose three variants
time the DP recurrence apart from its energy reads:

  n_sel = 0   const_energy: every energy of every cell is 1234
  n_sel = 5   sel5:  energy k of a cell whose ptb value is v is
              (v * 7919 + k * 31) % 60000 - 30000 if v < n_sel, else 0
  n_sel = 30  sel30: the same with all 30 values live

Inputs:
  meta (n_blocks, 4) int32        [_, ql, wt_e, _] per block
  ptb  (n_blocks, wt_max, BB) int32  pair index per column and window
Output:
  best (n_blocks, nc_all, BB) int32  max of M over rows r < ql and columns
                                  j < wt_e (-1 floor), the same for each of
                                  the nc_all conditions
Every one of the wq_max rows is computed; rows r >= ql only leave `best`
alone.  There is no separate boundary column: the column left of the first
reads -1.
"""

import ctypes

import torch

NUM_PAIR = 30
MAX_WT = 128        # widest window the kernel holds (MAX_WT1 - 1 in the .cu)
CONST_ENERGY = 1234


def _relu(x):
    return torch.clamp_min(x, 0)


def _shift(x, fill):
    """x[..., j-1, :] with `fill` at j = 0 (axis 1 is the column axis)."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def probe_energy_table(n_sel, device=None):
    """(31, 7) int32: energy k of pair value v; row 30 (and every row
    v >= n_sel) is zero."""
    v = torch.arange(NUM_PAIR + 1, dtype=torch.int32, device=device)[:, None]
    k = torch.arange(7, dtype=torch.int32, device=device)[None, :]
    tab = (v * 7919 + k * 31) % 60000 - 30000
    return torch.where((v < n_sel) & (v < NUM_PAIR), tab, 0).to(torch.int32)


def screen_probe_reference(meta, ptb, n_sel, *, wq_max, nc_all):
    """Plain PyTorch probe DP: a row loop over (n_blocks, wt_max, BB)
    planes, the I_query prefix recurrence in its exact int32
    cumsum/cummax form.  The conditions share their values, so one plane
    is computed and written nc_all times."""
    n_blocks, wt_max, BB = ptb.shape
    dev = ptb.device
    i32 = torch.int32
    ql = meta[:, 1].reshape(n_blocks, 1, 1)
    wt_e = meta[:, 2].reshape(n_blocks, 1, 1)
    col_ok = torch.arange(wt_max, device=dev).reshape(1, wt_max, 1) < wt_e
    if n_sel:
        tab = probe_energy_table(n_sel, dev)
        v = torch.where((ptb < 0) | (ptb >= NUM_PAIR), NUM_PAIR, ptb).long()
        e = tab[v]                                   # (n_blocks, wt, BB, 7)
        dgmm, dgmq, dgmt, dgqi, dgqe, dgti, dgte = e.unbind(dim=-1)
    else:
        dgmm = dgmq = dgmt = dgqi = dgqe = dgti = dgte = torch.full(
            ptb.shape, CONST_ENERGY, dtype=i32, device=dev)
    ssum = torch.cumsum(dgqe, dim=1, dtype=i32)
    prevM = torch.full(ptb.shape, -1, dtype=i32, device=dev)
    prevIq = prevM.clone()
    prevIt = prevM.clone()
    best = torch.full((n_blocks, BB), -1, dtype=i32, device=dev)
    for r in range(wq_max):
        m = torch.maximum(
            torch.maximum(_relu(_shift(prevM, -1)) - dgmm,
                          _relu(_shift(prevIq, -1)) - dgmq),
            _relu(_shift(prevIt, -1)) - dgmt)
        it = torch.maximum(_relu(prevM) - dgti, _relu(prevIt) - dgte)
        a = torch.maximum(_relu(_shift(m, -1)) - dgqi, -dgqe)
        iq = torch.cummax(a + ssum, dim=1).values - ssum
        rb = torch.where(col_ok, m, -1).amax(dim=1)
        best = torch.where(r < ql[:, 0], torch.maximum(best, rb), best)
        prevM, prevIq, prevIt = m, iq, it
    return best[:, None, :].expand(n_blocks, nc_all, BB).contiguous()


def _launcher():
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("screen_probe")
    fn = lib.screen_probe_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def screen_probe(meta, ptb, n_sel, *, wq_max, nc_all):
    """The probe DP: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see the module docstring for the contract)."""
    dev = ptb.device
    n_sel = int(n_sel)
    if not 0 <= n_sel <= NUM_PAIR:
        raise ValueError(f"screen_probe: n_sel {n_sel} outside [0, 30]")
    if ptb.dim() != 3 or meta.dim() != 2 or meta.shape != (ptb.shape[0], 4):
        raise ValueError(
            f"screen_probe: meta {tuple(meta.shape)} / ptb "
            f"{tuple(ptb.shape)}, expected (n_blocks, 4) / "
            "(n_blocks, wt_max, BB)")
    for name, t in (("meta", meta), ("ptb", ptb)):
        if t.device != dev:
            raise ValueError(
                f"screen_probe: {name} on {t.device}, expected {dev}")
        if t.dtype != torch.int32:
            raise ValueError(
                f"screen_probe: {name} must be int32, got {t.dtype}")
    if dev.type == "cpu":
        return screen_probe_reference(meta, ptb, n_sel, wq_max=wq_max,
                                      nc_all=nc_all)
    if dev.type != "cuda":
        raise ValueError(f"screen_probe: unsupported device {dev}")
    if not (meta.is_contiguous() and ptb.is_contiguous()):
        raise ValueError("screen_probe: inputs must be contiguous")
    n_blocks, wt_max, BB = ptb.shape
    if wt_max > MAX_WT:
        raise ValueError(f"screen_probe: wt_max {wt_max} > {MAX_WT}")
    best = torch.empty((n_blocks, nc_all, BB), dtype=torch.int32, device=dev)
    if best.numel() == 0:
        return best
    fn = _launcher()
    with torch.cuda.device(dev):     # the launch goes to the tensors' card
        rc = fn(meta.data_ptr(), ptb.data_ptr(), best.data_ptr(),
                n_blocks, BB, wt_max, int(wq_max), int(nc_all), n_sel,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"screen_probe kernel launch failed: CUDA error {rc}")
    screen_probe.launches += 1
    return best


screen_probe.launches = 0
