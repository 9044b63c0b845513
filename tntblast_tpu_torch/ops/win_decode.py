"""The window decode of the device step: per pooled entry, the slot's
scalars and the window's codes from the fragment's 2-bit word stream.

`win_decode` launches the hand-written Hopper kernel (csrc/win_decode.cu) on
CUDA tensors; on CPU tensors it runs `win_decode_reference`, the plain
PyTorch version and the kernel's spec.  Together they stand where the JAX
package has `slot_scalars` and `win_decode`
(tntblast_tpu/parallel/device_search.py, closures of _panel_step), fused by
XLA inside the jitted step; there is no Pallas original.

Inputs (B entries of the pooled stream, n fragments):
  slot, p, frag  (B,) int32  oligo-strand slot (num_os past the pool),
                     diagonal, fragment index (clamped into [0, n))
  frag_lens      (n,) int32  fragment lengths
  word_f         (n*nw_pos,) int32  2-bit target words, word_len bases each
  word_valid_f   (n*nw_pos,) bool   the word is pure ACGT
  slot_ql        (num_os+1,) int32, slot_minus (num_os+1,) bool  per-slot
                     oligo length and strand; row num_os holds the defaults
                     (ql 1, plus strand), parallel/device_search.slot_tables
Outputs:
  needs_host (B,) bool   the window is cut by a fragment end or a covering
                         word is not pure ACGT: the host evaluates it
  tb5   (B, wt_max) int32  oriented window codes in {0..3}, 0 past wt_e
  ptb   (B, wt_max) int32  pair index (previous code, 5 before column 0)
                           * NUM_T5 + code, as screen_dp reads it
  ql, wt_e (B,) int32    the slot's oligo length and window width ql + 8
  ent_valid (B,) bool    0 <= slot < num_os
An entry with ent_valid False (the sorted tail of the stream, past the
pooled candidates) gets zeros in all six outputs: nothing reads them
unmasked (the step masks keep and needs_host by ent_valid, screen_dp and
eval_pack skip such entries), and the kernel leaves it after reading its
slot, as the JAX step skips a chunk past the pool.

The kernel has one launch path, `WinDecodePlan`: a panel's slot tables and
static shapes, checked once, then one call a step that allocates the six
outputs and makes one ctypes call (DevicePanel._tables_on makes the plan, the
step calls it).  `win_decode`, the checked call, checks every argument and
then launches through a plan of its own.  Every launch counts in
`win_decode.launches`; a launch goes to the tensors' card and that card's
current stream, and raises when the kernel refuses or fails: there is no
plain fallback on a card.
"""

import ctypes

import torch

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.ops.screen_dp import MAX_WT
from tntblast_tpu_torch.ops.thermo_dp import NUM_T5

_I32 = torch.int32
MAX_WORD_LEN = 15       # a word's 2 * word_len bits fit an int32


def win_decode_reference(slot, p, frag, frag_lens, word_f, word_valid_f,
                         slot_ql, slot_minus, *, n, L, wt_max, word_len,
                         nw_pos, num_os):
    """Plain PyTorch version (the JAX slot_scalars + win_decode): a window
    is device-usable only when every covering word is valid (pure ACGT);
    others are routed to the host."""
    B = slot.shape[0]
    dev = slot.device
    ent_valid = (slot >= 0) & (slot < num_os)
    s = slot.clamp(0, num_os).long()
    ql = slot_ql[s]
    minus = slot_minus[s]
    wt_e = ql + 2 * C.NUM_FLANK_BASE
    fi = frag.clamp(0, n - 1)
    flen = frag_lens[fi.long()]
    start = p - C.NUM_FLANK_BASE
    full_win = (start >= 0) & (start + wt_e <= flen)
    start_c = start.clamp(0, L - wt_max)
    n_words_win = -(-wt_max // word_len)
    kw = torch.arange(n_words_win, dtype=_I32, device=dev)[None, :]
    wpos_raw = start_c[:, None] + kw * word_len
    gidx = (fi[:, None] * nw_pos + wpos_raw.clamp(0, nw_pos - 1)).long()
    wvals = word_f[gidx]                                  # (B, n_words)
    # the clamp must never read a DIFFERENT position's validity: an
    # out-of-range covering word disqualifies the window
    wv_k = word_valid_f[gidx] & (wpos_raw <= nw_pos - 1)
    need_k = (kw * word_len) < wt_e[:, None]
    clean = (~need_k | wv_k).all(dim=1)
    jj = torch.arange(wt_max, device=dev)
    col_word = (jj // word_len).expand(B, wt_max)
    col_shift = (2 * (word_len - 1 - jj % word_len)).to(_I32)
    wcod = (torch.gather(wvals, 1, col_word) >> col_shift) & 3
    # minus strand: complement + reversal within the true width (the JAX
    # flip + per-width roll, as one gather)
    rev_idx = (wt_e[:, None] - 1 - jj[None, :]).clamp(0, wt_max - 1).long()
    wrev = 3 - torch.gather(wcod, 1, rev_idx)
    melt = torch.where(minus[:, None], wrev, wcod)
    col_ok = (jj[None, :] < wt_e[:, None]) & ent_valid[:, None]
    needs_host = ((~full_win) | ~clean) & ent_valid
    tb5 = torch.where(col_ok, melt, 0).to(_I32)
    pt6 = torch.cat([torch.full((B, 1), 5, dtype=_I32, device=dev),
                     tb5[:, :-1]], dim=1)
    ptb = torch.where(ent_valid[:, None], pt6 * NUM_T5 + tb5, 0)
    return (needs_host, tb5, ptb, torch.where(ent_valid, ql, 0),
            torch.where(ent_valid, wt_e, 0), ent_valid)


def _library():
    """The kernel's ctypes library, its entry points typed."""
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("win_decode")
    if lib.win_decode_launch_plan.argtypes is None:
        bind(lib)
    return lib


def bind(lib):
    """Sets the argument types of the entry points of a win_decode library
    (the package's, or the CPU tests' host build): the plan's pair and the
    one-call `win_decode_launch`."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, types in (
            ("win_decode_launch", [P] * 14 + [I] * 8 + [P]),
            ("win_decode_plan_bytes", []),
            ("win_decode_plan", [P] * 3 + [I] * 6),
            ("win_decode_launch_plan", [P] * 13 + [I] * 2 + [P])):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def launch_args(slot, p, frag, frag_lens, word_f, word_valid_f, slot_ql,
                slot_minus, out, *, n, L, wt_max, word_len, nw_pos, num_os):
    """The C entry point's arguments up to the stream: the inputs' and
    `out`'s (the six outputs') pointers, then the shapes."""
    return (*(t.data_ptr() for t in (slot, p, frag, frag_lens, word_f,
                                     word_valid_f, slot_ql, slot_minus)),
            *(t.data_ptr() for t in out), slot.shape[0], n, L, wt_max,
            word_len, nw_pos, num_os)


def empty_outputs(B, wt_max, device):
    """The six outputs, uninitialised (the kernel writes every element)."""
    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    return (e((B,), torch.bool), e((B, wt_max), _I32), e((B, wt_max), _I32),
            e((B,), _I32), e((B,), _I32), e((B,), torch.bool))


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"win_decode: {name} on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise ValueError(f"win_decode: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"win_decode: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"win_decode: {name} must be contiguous")


def _check_shapes(wt_max, word_len, nw_pos, num_os):
    if not 1 <= wt_max <= MAX_WT:
        raise ValueError(f"win_decode: wt_max {wt_max} outside "
                         f"[1, {MAX_WT}]")
    if not 1 <= word_len <= MAX_WORD_LEN:
        raise ValueError(f"win_decode: word_len {word_len} outside "
                         f"[1, {MAX_WORD_LEN}]")
    if nw_pos < 1 or num_os < 0:
        raise ValueError(f"win_decode: nw_pos {nw_pos}, num_os {num_os}")


class WinDecodePlan:
    """The kernel's one launch path: a panel's slot tables (`slot_ql`,
    `slot_minus`, on one card) and its static shapes, checked once, here.
    A call then takes one step's

        slot, p, frag (B,) int32, frag_lens (n,) int32,
        word_f (n * nw_pos,) int32, word_valid_f (n * nw_pos,) bool

    on the plan's card, contiguous, and reads only their pointers and the
    lengths of slot and frag_lens: the device step (panel_step_core)
    guarantees the rest, `win_decode` checks it.  n is the call's (a
    step's last batch may hold fewer fragments).  It returns the six
    outputs as `win_decode` does, launches on the card's current stream,
    read each call, counts the launch in `win_decode.launches`, and raises
    when the launch fails; there is no plain fallback, and CPU tensors are
    refused (a CPU panel calls `win_decode`, which runs the plain
    version)."""

    def __init__(self, slot_ql, slot_minus, *, L, wt_max, word_len, nw_pos,
                 num_os):
        dev = slot_ql.device
        if dev.type != "cuda":
            raise ValueError(f"WinDecodePlan: tables on {dev}; the plan "
                             "serves a card")
        L, wt_max, word_len = int(L), int(wt_max), int(word_len)
        nw_pos, num_os = int(nw_pos), int(num_os)
        _check_shapes(wt_max, word_len, nw_pos, num_os)
        _check("slot_ql", slot_ql, dev, _I32, (num_os + 1,))
        _check("slot_minus", slot_minus, dev, torch.bool, (num_os + 1,))
        lib = _library()
        self._plan = (ctypes.c_uint64 * -(-lib.win_decode_plan_bytes()
                                          // 8))()
        rc = lib.win_decode_plan(self._plan, slot_ql.data_ptr(),
                                 slot_minus.data_ptr(), L, wt_max, word_len,
                                 nw_pos, num_os, dev.index)
        if rc != 0:
            raise ValueError(f"WinDecodePlan: the kernel refuses wt_max "
                             f"{wt_max}, word_len {word_len}: CUDA error "
                             f"{rc}")
        self.device, self.index = dev, dev.index    # a tensor's: indexed
        self.wt_max = wt_max
        self._tables = (slot_ql, slot_minus)        # kept alive with the plan
        self._launch = lib.win_decode_launch_plan
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, slot, p, frag, frag_lens, word_f, word_valid_f):
        if not slot.is_cuda:
            raise ValueError("WinDecodePlan: CPU tensors (call win_decode)")
        B = slot.shape[0]
        out = empty_outputs(B, self.wt_max, self.device)
        if B == 0:
            return out
        rc = self._launch(
            self._plan, slot.data_ptr(), p.data_ptr(), frag.data_ptr(),
            frag_lens.data_ptr(), word_f.data_ptr(), word_valid_f.data_ptr(),
            *(t.data_ptr() for t in out), B, frag_lens.shape[0],
            self._stream(self.index))
        if rc != 0:
            raise RuntimeError(
                f"win_decode kernel launch failed: CUDA error {rc}")
        win_decode.launches += 1
        return out


def win_decode(slot, p, frag, frag_lens, word_f, word_valid_f, slot_ql,
               slot_minus, *, n, L, wt_max, word_len, nw_pos, num_os):
    """The window decode: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring for the contract).
    Returns (needs_host, tb5, ptb, ql, wt_e, ent_valid)."""
    args = (slot, p, frag, frag_lens, word_f, word_valid_f, slot_ql,
            slot_minus)
    kw = dict(n=int(n), L=int(L), wt_max=int(wt_max),
              word_len=int(word_len), nw_pos=int(nw_pos),
              num_os=int(num_os))
    dev = slot.device
    if dev.type == "cpu":
        return win_decode_reference(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"win_decode: unsupported device {dev}")
    _check_shapes(kw["wt_max"], kw["word_len"], kw["nw_pos"], kw["num_os"])
    if kw["n"] < 1:
        raise ValueError(f"win_decode: n {n}")
    if slot.dim() != 1:
        raise ValueError("win_decode: slot must be 1-D")
    B = slot.shape[0]
    words = kw["n"] * kw["nw_pos"]
    for name, t, dtype, shape in (
            ("slot", slot, _I32, (B,)), ("p", p, _I32, (B,)),
            ("frag", frag, _I32, (B,)),
            ("frag_lens", frag_lens, _I32, (kw["n"],)),
            ("word_f", word_f, _I32, (words,)),
            ("word_valid_f", word_valid_f, torch.bool, (words,)),
            ("slot_ql", slot_ql, _I32, (kw["num_os"] + 1,)),
            ("slot_minus", slot_minus, torch.bool, (kw["num_os"] + 1,))):
        _check(name, t, dev, dtype, shape)
    plan = WinDecodePlan(slot_ql, slot_minus, **{
        k: kw[k] for k in ("L", "wt_max", "word_len", "nw_pos", "num_os")})
    return plan(*args[:6])


win_decode.launches = 0
