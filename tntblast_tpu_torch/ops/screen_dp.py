"""The screening DP over a flat mixed-slot window stream.

`screen_dp` launches the hand-written Hopper kernel (csrc/screen_dp.cu) on
CUDA tensors; on CPU tensors it runs `screen_dp_reference`, the plain
PyTorch version and the kernel's spec.  The kernel reads its energies from
`kernel_tables(tcan)`, which a device panel makes once and passes as
`tables`, and keeps a window's DP row in registers at the width
`kernel_width(wt_max)` names; a window wider than the widest register
width runs in strips of registers with a carry between them.  Both replace
tntblast_tpu/ops/pallas_screen.py::_screen_kernel and the XLA row scan of
tntblast_tpu/parallel/device_search.py run_chunk.

The kernel has one launch path, `ScreenDpPlan(qp, tcan, eval_on=...,
tables=...)`, counted in `screen_dp.launches`: it checks a panel's tables
once, when the panel uploads them, and then takes a chunk's four tensors
without a check (the lean call of the device step).  `screen_dp(...)`, the
checked call, tests every argument and then launches through a plan of its
own.

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
# widest window the kernels take (MAX_WT in the .cu files): an oligo of
# MAX_SEQUENCE_LENGTH (1024) nucleotides and its flanks
MAX_WT = 1032
# widths the kernels hold a DP row in registers for (FOR_REG_WIDTHS in the
# .cu files); wider windows run in strips of registers (the strip path).
# The panels of tests/golden/e2e and the bench panel (wq_max 12, 22, 24)
# need 24 and 32.
REG_WIDTHS = (24, 32)
TAB_PAD = 32        # pair values of a table row, padded to the bank count
TAB_Q_WORDS = 7 * TAB_PAD + 1       # words from one query pair to the next
# one condition's table, padded to 16 bytes
TAB_WORDS = (NUM_PAIR * TAB_Q_WORDS + 3) // 4 * 4


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


def kernel_width(wt_max):
    """The register width a window of wt_max columns runs on: the smallest
    of REG_WIDTHS that holds it, or 0 (the strip path) beyond the
    widest."""
    if not 1 <= wt_max <= MAX_WT:
        raise ValueError(f"wt_max {wt_max} outside [1, {MAX_WT}]")
    return next((w for w in REG_WIDTHS if wt_max <= w), 0)


def kernel_tables(tcan):
    """The canonical tables in the kernel's shared-memory layout:
    (nc_all, TAB_WORDS) int32, where word q * TAB_Q_WORDS + k * TAB_PAD + v
    of condition c is -tcan[c, v, q, k] and every other word is 0.  One
    query pair's seven energy rows lie 32 words apart, so lanes that differ
    in the target pair v hit different banks; query pairs lie an odd number
    of words apart, so lanes that differ in q do too; the energies are
    negated for the kernel's add-max."""
    nc_all = tcan.shape[0]
    tab = torch.zeros((nc_all, TAB_WORDS), dtype=torch.int32,
                      device=tcan.device)
    rows = tab[:, :NUM_PAIR * TAB_Q_WORDS].view(nc_all, NUM_PAIR, TAB_Q_WORDS)
    rows[:, :, :7 * TAB_PAD].view(nc_all, NUM_PAIR, 7, TAB_PAD)[
        ..., :NUM_PAIR] = -tcan.permute(0, 2, 3, 1)
    return tab


def bind(lib):
    """The C entries of a build of csrc/screen_dp.cu (the card's, or the
    CPU tests' host build) with their argument types: (launch,
    carry_words)."""
    fn, cw = lib.screen_dp_launch, lib.screen_dp_carry_words
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        cw.argtypes = [ctypes.c_int] * 4
        cw.restype = ctypes.c_longlong
    return fn, cw


def _launcher():
    from tntblast_tpu_torch import _kernels
    return bind(_kernels.load("screen_dp"))


def _check(name, t, device, ndim):
    if t.device != device:
        raise ValueError(f"screen_dp: {name} on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"screen_dp: {name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"screen_dp: {name} must be {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"screen_dp: {name} must be contiguous")


def screen_dp(ptb, slot, ql, wt_e, qp, tcan, *, eval_on, tables=None):
    """The screen DP: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see the module docstring for the contract).  `tables`
    is kernel_tables(tcan) where the caller keeps it (a panel does, for its
    lifetime); without it the kernel's tables are laid out for this call.
    On a card it checks every argument and launches through a plan of its
    own (ScreenDpPlan)."""
    dev = ptb.device
    if dev.type == "cpu":
        return screen_dp_reference(ptb, slot, ql, wt_e, qp, tcan,
                                   eval_on=eval_on)
    if dev.type != "cuda":
        raise ValueError(f"screen_dp: unsupported device {dev}")
    for name, t, nd in (("ptb", ptb, 2), ("slot", slot, 1), ("ql", ql, 1),
                        ("wt_e", wt_e, 1)):
        _check(name, t, dev, nd)
    B = ptb.shape[0]
    if slot.shape[0] != B or ql.shape[0] != B or wt_e.shape[0] != B:
        raise ValueError("screen_dp: per-window inputs disagree on B")
    plan = ScreenDpPlan(qp, tcan, eval_on=eval_on, tables=tables)
    if plan.device != dev:
        raise ValueError(f"screen_dp: tables on {plan.device}, ptb on {dev}")
    return plan(ptb, slot, ql, wt_e)


screen_dp.launches = 0


class ScreenDpPlan:
    """The kernel's one launch path: a panel's qpair rows `qp`, canonical
    tables `tcan` and their kernel layout `tables` (made here when None) on
    one card, checked once, here.  A call then takes one chunk's

        ptb (B, wt_max), slot, ql, wt_e (B,)

    int32 and contiguous on the plan's card, and reads only their pointers
    and ptb's shape: the device step (panel_step_core) guarantees the rest,
    `screen_dp` checks it.  It returns (best, mgmax, M_rows) as screen_dp
    does, launches on the card's current stream, read each call, counts the
    launch in `screen_dp.launches`, and raises when the launch fails; there
    is no plain fallback, and CPU tensors are refused (a CPU panel calls
    `screen_dp`, which runs the plain version)."""

    def __init__(self, qp, tcan, *, eval_on, tables=None):
        dev = qp.device
        if dev.type != "cuda":
            raise ValueError(f"ScreenDpPlan: tables on {dev}; the plan "
                             "serves a card")
        _check("qp", qp, dev, 2)
        _check("tcan", tcan, dev, 4)
        if tuple(tcan.shape[1:]) != (NUM_PAIR, NUM_PAIR, 7):
            raise ValueError(f"screen_dp: tcan shape {tuple(tcan.shape)}")
        nc_all = tcan.shape[0]
        if tables is None:
            tables = kernel_tables(tcan)
        _check("tables", tables, dev, 2)
        if tuple(tables.shape) != (nc_all, TAB_WORDS):
            raise ValueError(f"screen_dp: tables shape {tuple(tables.shape)}")
        self.device, self.index = dev, dev.index    # a tensor's: indexed
        self.n_real, self.wq_max = qp.shape
        self.nc_all = nc_all
        self.eval_on = bool(eval_on)
        self._qp, self._tables = qp, tables         # kept alive with the plan
        self._widths = {}                           # wt_max -> kernel width
        self._launch, self._carry_words = _launcher()
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, ptb, slot, ql, wt_e):
        if not ptb.is_cuda:
            raise ValueError("ScreenDpPlan: CPU tensors (call screen_dp)")
        B, wt_max = ptb.shape
        width = self._widths.get(wt_max)
        if width is None:
            width = self._widths[wt_max] = kernel_width(wt_max)
        dev, i32 = self.device, torch.int32
        best = torch.empty((self.nc_all, B), dtype=i32, device=dev)
        mgmax = torch.empty((B,), dtype=i32, device=dev)
        M_rows = (torch.empty((self.wq_max, B, wt_max + 1), dtype=i32,
                              device=dev) if self.eval_on else None)
        if B == 0:
            return best, mgmax, M_rows
        carry = None
        if width == 0:          # the strip path's scratch, any values
            carry = torch.empty(
                (self._carry_words(B, self.wq_max, self.nc_all,
                                   int(self.eval_on)),),
                dtype=i32, device=dev)
        rc = self._launch(
            ptb.data_ptr(), slot.data_ptr(), ql.data_ptr(), wt_e.data_ptr(),
            self._qp.data_ptr(), self._tables.data_ptr(), best.data_ptr(),
            mgmax.data_ptr(), M_rows.data_ptr() if self.eval_on else None,
            None if carry is None else carry.data_ptr(), B, wt_max, self.wq_max, self.nc_all, self.n_real,
            int(self.eval_on), width, self.index, self._stream(self.index))
        if rc != 0:
            raise RuntimeError(
                f"screen_dp kernel launch failed: CUDA error {rc}")
        screen_dp.launches += 1
        return best, mgmax, M_rows
