"""The kept-seed compaction of the device step: the keep flags from the
screening scores, the first bkcap kept entries of the pooled stream with
their gathers and representative word index, and the step's header and
kept block.

`kept` launches the hand-written Hopper kernel (csrc/kept.cu) on CUDA
tensors; on CPU tensors it runs `kept_reference`, the plain PyTorch version
and the kernel's spec.  Together they stand where the JAX package has the
keep flags of run_chunk and the kept-seed compaction, kmin and header of
tntblast_tpu/parallel/device_search.py::panel_step_core (:727-731,
:854-884), fused by XLA inside the jitted step; there is no Pallas
original.  (The name keeps it apart from ops/seed.py::compact, the cumsum
compaction the dense seeding path uses.)

Inputs (the pooled stream of Bp = n * cap entries on n fragments of cap
candidates; num_os slots, num_cond screening conditions):
  best      (rows, Bp) int32  the screen's per-condition scores, rows >=
                              num_cond (the eval condition's row after them
                              is not read)
  slot_str, p_str, frag_str, order_str (Bp,) int32  the pool's streams
  needs_host, ent_valid (Bp,) bool  the decode's routing and validity
                              (ent_valid False past the pooled prefix of
                              sum(clamp(n_cand, 0, cap)) entries, as the
                              pool leaves the stream: the kernel reads
                              nothing past it)
  ev_all    (Bp, 5) int32 or None  the evaluator's words (None: zeros)
  word_f, word_valid_f (n * nw_pos,) int32 / bool  the target words
  ow        (num_os, max_words) int32  the oligos' words (-1 past them)
  thr       (num_cond, num_os + 1) int32  thresholds by slot (INT_MIN: off)
  overflow, input_over (n,) bool;  n_cand (n,), counts (n, num_os) int32
Outputs:
  header     (1 + 2n + num_os + n * num_os,) int32  [n_kept, overflow |
             input_over, zeros (num_os), n_cand, counts]
  kept_block (9, bkcap) int32  the first bkcap kept entries in stream
             order: order, slot, p, kmin, the five evaluator words; zeros
             past n_kept

The kernel has one launch path, `KeptPlan`: a panel's oligo words,
thresholds and static shapes, checked once (DevicePanel._tables_on makes
the plan, the step calls it), then one call a step that allocates the two
outputs and a scratch buffer and makes one ctypes call for the kernel's two
launches.  `kept`, the checked call, checks every argument and launches
through a plan of its own.  Every call that launches counts one in
`kept.launches`; a launch goes to the tensors' card and that card's
current stream and raises when it is refused or fails: there is no plain
fallback on a card.
"""

import ctypes

import torch

from tntblast_tpu_torch.ops.seed import compact

_I32 = torch.int32
INT_MIN = -(1 << 31) + 1    # a threshold that is off
MAX_SLOTS = 64              # csrc/kept.cu: the panel's slots, at most
EV_WORDS = 5


def keep_flags(best, slot_str, needs_host, ent_valid, thr, *, num_cond,
               num_os):
    """(Bp,) bool: an entry passes every screening condition (or the
    condition is off for its slot), or the host evaluates it; and it is a
    pooled candidate."""
    thr_e = thr[:, slot_str.clamp(0, num_os).long()]
    keep = torch.ones(slot_str.shape, dtype=torch.bool,
                      device=slot_str.device)
    for c in range(num_cond):
        keep = keep & ((best[c] >= thr_e[c]) | (thr_e[c] == INT_MIN))
    # needs_host is False past the pool already
    return (keep | needs_host) & ent_valid


def kept_reference(best, slot_str, p_str, frag_str, order_str, needs_host,
                   ent_valid, ev_all, word_f, word_valid_f, ow, thr,
                   overflow, input_over, n_cand, counts, *, num_cond, num_os,
                   max_words, nw_pos, bkcap):
    """Plain PyTorch version (the JAX step's keep flags, jnp.nonzero(size=
    bkcap) as a cumsum and a scatter, its gathers, kmin and header).
    Returns (header, kept_block)."""
    Bp = slot_str.shape[0]
    dev = slot_str.device
    keep_all = keep_flags(best, slot_str, needs_host, ent_valid, thr,
                          num_cond=num_cond, num_os=num_os)
    n_kept = keep_all.sum().to(_I32)
    kept_idx = compact(keep_all[None], bkcap, Bp)[0]
    kv = kept_idx < Bp
    ks = kept_idx.clamp(0, Bp - 1)
    os_k = torch.where(kv, slot_str[ks], 0)
    p_k = torch.where(kv, p_str[ks], 0)
    f_k = torch.where(kv, frag_str[ks], 0)
    pool_idx = torch.where(kv, order_str[ks], 0)

    # representative word index: smallest k with a word match on the
    # diagonal (reference first-occurrence dedup, bind_oligo.cpp:33-47)
    kk = torch.arange(max_words, dtype=_I32, device=dev)[None, :]
    tpos = p_k[:, None] + kk
    tin = (tpos >= 0) & (tpos < nw_pos)
    gidx = (f_k[:, None] * nw_pos + tpos.clamp(0, nw_pos - 1)).long()
    wv = word_f[gidx]
    wok = word_valid_f[gidx] & tin
    ow_sel = ow[os_k.clamp(0, num_os - 1).long()]
    match = wok & (ow_sel >= 0) & (wv == ow_sel)
    kmin_k = torch.where(match, kk, max_words).amin(dim=1).to(_I32)
    kmin_k = torch.where(kv, kmin_k, 0)

    ev_k = (torch.where(kv[:, None], ev_all[ks], 0) if ev_all is not None
            else torch.zeros((bkcap, EV_WORDS), dtype=_I32, device=dev))
    header = torch.cat([
        n_kept[None], (overflow | input_over).to(_I32),
        torch.zeros(num_os, dtype=_I32, device=dev),
        n_cand, counts.reshape(-1)])
    kept_block = torch.stack([
        pool_idx, os_k, p_k, kmin_k,
        ev_k[:, 0], ev_k[:, 1], ev_k[:, 2], ev_k[:, 3], ev_k[:, 4]])
    return header, kept_block


def _library():
    """The kernel's ctypes library, its entry points typed."""
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("kept")
    if lib.kept_launch_plan.argtypes is None:
        bind(lib)
    return lib


def bind(lib):
    """Sets the argument types of the entry points of a kept library (the
    package's, or the CPU tests' host build)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, types, res in (
            ("kept_plan_bytes", [], ctypes.c_int),
            ("kept_plan", [P] * 3 + [I] * 5, ctypes.c_int),
            ("kept_scratch_words", [I], ctypes.c_longlong),
            ("kept_launch_plan", [P] * 18 + [I] * 3 + [P], ctypes.c_int)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = res
    return lib


def make_plan(lib, ow, thr, *, num_os, num_cond, max_words, nw_pos, index):
    """A filled plan buffer of `lib` (holding ow and thr, which it keeps
    alive), or ValueError where the kernel refuses the shapes."""
    plan = (ctypes.c_uint64 * -(-lib.kept_plan_bytes() // 8))()
    plan.tables = (ow, thr)
    rc = lib.kept_plan(plan, ow.data_ptr(), thr.data_ptr(), num_os,
                       num_cond, max_words, nw_pos, index)
    if rc != 0:
        raise ValueError(f"kept: the kernel refuses num_os {num_os}, "
                         f"num_cond {num_cond}, max_words {max_words}, "
                         f"nw_pos {nw_pos}: CUDA error {rc}")
    return plan


def empty_outputs(n, num_os, bkcap, device):
    """header and kept_block, uninitialised (the kernel writes every
    element)."""
    return (torch.empty((1 + 2 * n + num_os + n * num_os,), dtype=_I32,
                        device=device),
            torch.empty((9, bkcap), dtype=_I32, device=device))


def launch_args(plan, best, stream_in, ev_all, words, frag_in, out, scratch,
                bkcap):
    """kept_launch_plan's arguments up to the stream: `stream_in` the six
    stream tensors (slot_str, p_str, frag_str, order_str, needs_host,
    ent_valid), `words` (word_f, word_valid_f), `frag_in` (overflow,
    input_over, n_cand, counts)."""
    Bp = stream_in[0].shape[0]
    return (plan, best.data_ptr(), *(t.data_ptr() for t in stream_in),
            ev_all.data_ptr() if ev_all is not None else None,
            *(t.data_ptr() for t in words),
            *(t.data_ptr() for t in frag_in),
            *(t.data_ptr() for t in out), scratch.data_ptr(), Bp,
            frag_in[2].shape[0], bkcap)


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"kept: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"kept: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"kept: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"kept: {name} must be contiguous")


class KeptPlan:
    """The kernel's one launch path: a panel's oligo words `ow` (num_os,
    max_words), thresholds `thr` (num_cond, num_os + 1), int32 on one card,
    and nw_pos, checked once, here.  A call then takes one step's

        best (rows, Bp) int32, rows >= num_cond, slot_str, p_str,
            frag_str, order_str (Bp,) int32, needs_host, ent_valid (Bp,)
            bool, ev_all (Bp, 5) int32 or None, word_f (n * nw_pos,)
            int32, word_valid_f bool, overflow, input_over (n,) bool,
            n_cand (n,) int32, counts (n, num_os) int32, and bkcap

    on the plan's card, contiguous, and reads only their pointers, Bp and
    n: the device step (panel_step_core) guarantees the rest, `kept` checks
    it.  It returns (header, kept_block), launches on the card's current
    stream, read each call, counts the call in `kept.launches`, and raises
    when a launch fails; there is no plain fallback, and CPU tensors are
    refused (a CPU panel runs the plain version)."""

    def __init__(self, ow, thr, *, nw_pos):
        dev = ow.device
        if dev.type != "cuda":
            raise ValueError(f"KeptPlan: tables on {dev}; the plan serves "
                             "a card")
        if ow.dim() != 2 or thr.dim() != 2:
            raise ValueError("KeptPlan: ow and thr must be 2-D")
        num_os, max_words = ow.shape
        num_cond = thr.shape[0]
        _check("ow", ow, dev, _I32, (num_os, max_words))
        _check("thr", thr, dev, _I32, (num_cond, num_os + 1))
        lib = _library()
        self._plan = make_plan(lib, ow, thr, num_os=num_os,
                               num_cond=num_cond, max_words=max_words,
                               nw_pos=int(nw_pos), index=dev.index)
        self.device, self.index = dev, dev.index
        self.num_os = num_os
        self._scratch = lib.kept_scratch_words
        self._launch = lib.kept_launch_plan
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, best, slot_str, p_str, frag_str, order_str,
                 needs_host, ent_valid, ev_all, word_f, word_valid_f,
                 overflow, input_over, n_cand, counts, *, bkcap):
        if not slot_str.is_cuda:
            raise ValueError("KeptPlan: CPU tensors (call kept)")
        Bp, n = slot_str.shape[0], n_cand.shape[0]
        out = empty_outputs(n, self.num_os, bkcap, self.device)
        scratch = torch.empty(self._scratch(Bp), dtype=_I32,
                              device=self.device)
        rc = self._launch(*launch_args(
            self._plan, best,
            (slot_str, p_str, frag_str, order_str, needs_host, ent_valid),
            ev_all, (word_f, word_valid_f),
            (overflow, input_over, n_cand, counts), out, scratch, bkcap),
            self._stream(self.index))
        if rc != 0:
            raise RuntimeError(f"kept kernel launch failed: CUDA error {rc}")
        kept.launches += 1
        return out


def kept(best, slot_str, p_str, frag_str, order_str, needs_host, ent_valid,
         ev_all, word_f, word_valid_f, ow, thr, overflow, input_over, n_cand,
         counts, *, num_cond, num_os, max_words, nw_pos, bkcap):
    """The kept-seed compaction: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring for the contract).
    Returns (header, kept_block)."""
    args = (best, slot_str, p_str, frag_str, order_str, needs_host,
            ent_valid, ev_all, word_f, word_valid_f, ow, thr, overflow,
            input_over, n_cand, counts)
    kw = dict(num_cond=int(num_cond), num_os=int(num_os),
              max_words=int(max_words), nw_pos=int(nw_pos), bkcap=int(bkcap))
    dev = slot_str.device
    if dev.type == "cpu":
        return kept_reference(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"kept: unsupported device {dev}")
    if slot_str.dim() != 1 or best.dim() != 2 or n_cand.dim() != 1:
        raise ValueError("kept: slot_str and n_cand must be 1-D, best 2-D")
    Bp, n, rows = slot_str.shape[0], n_cand.shape[0], best.shape[0]
    num_os, num_cond = kw["num_os"], kw["num_cond"]
    if not 1 <= kw["bkcap"] <= Bp or n < 1 or Bp % n or rows < num_cond:
        raise ValueError(f"kept: bkcap {bkcap}, n {n}, rows {rows} for "
                         f"{Bp} entries and {num_cond} conditions (the "
                         f"stream must be n fragments of one cap)")
    words = n * kw["nw_pos"]
    checks = [("best", best, _I32, (rows, Bp))]
    checks += [(name, t, _I32, (Bp,)) for name, t in (
        ("slot_str", slot_str), ("p_str", p_str), ("frag_str", frag_str),
        ("order_str", order_str))]
    checks += [("needs_host", needs_host, torch.bool, (Bp,)),
               ("ent_valid", ent_valid, torch.bool, (Bp,)),
               ("word_f", word_f, _I32, (words,)),
               ("word_valid_f", word_valid_f, torch.bool, (words,)),
               ("ow", ow, _I32, (num_os, kw["max_words"])),
               ("thr", thr, _I32, (num_cond, num_os + 1)),
               ("overflow", overflow, torch.bool, (n,)),
               ("input_over", input_over, torch.bool, (n,)),
               ("n_cand", n_cand, _I32, (n,)),
               ("counts", counts, _I32, (n, num_os))]
    if ev_all is not None:
        checks.append(("ev_all", ev_all, _I32, (Bp, EV_WORDS)))
    for name, t, dtype, shape in checks:
        _check(name, t, dev, dtype, shape)
    plan = KeptPlan(ow, thr, nw_pos=kw["nw_pos"])
    return plan(*args[:10], *args[12:], bkcap=kw["bkcap"])


kept.launches = 0
