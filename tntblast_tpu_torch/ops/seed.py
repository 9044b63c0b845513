"""The seeding stage of the device step: from one step's packed payload,
every fragment's target words and its seed candidates, on the word-table
path or on the dense path.

`seed` launches the hand-written Hopper kernel of the table path
(csrc/seed.cu) on CUDA tensors; on CPU tensors it runs `seed_reference`,
the plain PyTorch version and the kernel's spec: `unpack_fragments`
followed by `seed_table_path`.  Together they stand where the JAX package
has the payload unpack of
tntblast_tpu/parallel/device_search.py::panel_step_core and the table path
of `_seed_fragment` under its fragment vmap, fused by XLA inside the jitted
step; there is no Pallas original.  `seed_dense` does the same for the
dense path (a (1, num_os) dummy w_table: long oligos or heavily shared
words): the kernel csrc/seed_dense.cu on CUDA tensors, `seed_dense_reference`
(`unpack_fragments` followed by `seed_dense_path`, the JAX dense bitmap and
its two-stage compaction) on CPU tensors.  The panel's static shapes choose
the path, as the JAX step chooses it at trace time.

Inputs (n fragments in a tile of L positions, L a multiple of 4):
  frags_packed (n, L / 4) uint8   2 bits a base, base x at bits 2 * (x % 4)
  frag_lens    (n,) int32
  nrun_s, nrun_e (n, R) int32     N-run starts and ends, padded with L
  exc_p (n, E) int32, exc_c (n, E) uint8   exceptions, pads at L
  w_table      (4^w, num_os) int32  word value -> per-slot k-bitmask (table
                                    path); the dense path reads ow
                                    (num_os, max_words) int32, -1 pads
Outputs:
  slot, p   (n, cap) int32   table path: the first cap unique (diagonal,
                             slot) keys in (diagonal, slot) order; dense
                             path: the first cap (diagonal, slot) pairs of
                             the first cap non-empty diagonals; 0 past them
  n_cand    (n,) int32       the number of keys (dense: of pairs in the
                             first cap diagonals); may exceed cap
  counts    (n, num_os) int32  keys per slot (dense: non-empty diagonals
                             per slot), over all of them
  overflow  (n,) bool        table path: more than cap any-match positions,
                             a slot or k residue, or n_cand > cap; dense
                             path: more than cap non-empty diagonals or
                             sum(counts) > cap
  word      (n, nw_pos) int32  the 2-bit words at every position
  word_valid (n, nw_pos) bool

The table kernel reads the panel's w_table as two tables built once on the
host (`seed_tables`): KS (4^w, max_words) uint64, the slots whose lane
(slot, k) exists for each word value, and VF (4^w,) uint8, whether some
oligo holds the word (bit 0) and whether it leaves a slot or k residue
(bit 1); and as `aux_tables(KS, VF)`, derived on the tables' device when a
plan is made.  The dense kernel reads the panel's ow as `dense_tables`: a
hash of the word values some oligo holds to their entries (k, the 64-bit
set of slots whose word k it is) and filter bits of those hashes.
The lean calls are `SeedPlan` and `DenseSeedPlan` (the tables and static
shapes checked once, then one call a step that allocates the outputs and a
scratch buffer and makes one ctypes call for the kernel's launches: two
for seed, four for seed_dense);
`seed(...)` and `seed_dense(...)`, the checked calls, check every argument,
build the tables and launch through a plan of their own.  Every call that
launches counts one in `seed.launches` or `seed_dense.launches`; a launch
goes to the tensors' card and that card's current stream and raises when
it is refused or fails: there is no plain fallback on a card.
"""

import ctypes

import numpy as np
import torch

from tntblast_tpu_torch import constants as C

_I32 = torch.int32
_I64 = torch.int64
MAX_WORD_LEN = 8        # csrc/seed.cu: 4^w word values, the KS table's rows
MAX_WORDS = 31          # k-bitmasks of 31 bits (the panel's gate)
MAX_SLOTS = 64          # a diagonal's slots in one 64-bit set
DENSE_MAX_WORD_LEN = 15     # csrc/seed_dense.cu MAX_WORD_LEN: 30-bit words
DENSE_MAX_WORDS = 1024      # csrc/seed_dense.cu MAX_WORDS: a 1024-nt oligo
DENSE_FILTER_BITS = 15      # csrc/seed_dense.cu FILTER_BITS
DENSE_HASH_MUL = 2654435761     # csrc/seed_dense.cu HASH_MUL


def compact(mask, size, fill):
    """Per row of a (n, M) bool mask: the indices of the first `size` True
    entries, `fill` past the last (== jnp.nonzero(row, size, fill_value))."""
    n, M = mask.shape
    rank = torch.cumsum(mask, dim=1, dtype=_I64) - 1
    dst = torch.where(mask & (rank < size), rank, size)
    out = torch.full((n, size + 1), fill, dtype=_I64, device=mask.device)
    src = torch.arange(M, dtype=_I64, device=mask.device).expand(n, M)
    out.scatter_(1, dst, src)          # column `size` collects the rest
    return out[:, :size]


def _popcount(x):
    """Bit count of non-negative int64 values below 2**32 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _low_bit_index(m):
    """Index of the lowest set bit of non-zero int64 lanes (< 2**32); the
    lowest bit of bit 31 is 31."""
    return _popcount((m & -m) - 1)


def unpack_fragments(frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c,
                     tile_len):
    """Fragment codes (n, L) uint8 from the packed payload: 2-bit stream,
    padding synthesized from frag_len, N runs (+1 at starts, -1 at ends,
    prefix sum > 0) and scattered exceptions (pad rows point at L)."""
    n = frags_packed.shape[0]
    L = tile_len
    dev = frags_packed.device
    shifts = torch.arange(4, dtype=torch.uint8, device=dev) * 2
    frags = ((frags_packed[:, :, None] >> shifts[None, None, :]) & 3
             ).reshape(n, L)
    pos = torch.arange(L, device=dev)[None, :]
    frags = torch.where(pos >= frag_lens[:, None], C.DB_UNKNOWN, frags)
    delta = torch.zeros((n, L + 1), dtype=_I32, device=dev)
    ones = torch.ones(nrun_s.shape, dtype=_I32, device=dev)
    delta.scatter_add_(1, nrun_s.clamp(0, L).long(), ones)
    delta.scatter_add_(1, nrun_e.clamp(0, L).long(), -ones)
    in_n = torch.cumsum(delta[:, :L], dim=1) > 0
    frags = torch.where(in_n, C.DB_N, frags)
    frags = torch.cat(
        [frags, torch.zeros((n, 1), dtype=torch.uint8, device=dev)], dim=1)
    frags.scatter_(1, exc_p.clamp(0, L).long(), exc_c)
    return frags[:, :L]


def target_words(frags, frag_lens, word_len, tile_len):
    """(word, word_valid), (n, nw_pos) each: the 2-bit words at every
    position of the fragment codes, and whether the word is pure ACGT
    inside the fragment."""
    n = frags.shape[0]
    w = word_len
    L = tile_len
    nw_pos = L - w + 1
    dev = frags.device
    codes = frags.to(_I32)
    two_bit = codes & 3
    valid_base = ((codes <= C.DB_MAX_ATGC)
                  & (torch.arange(L, device=dev)[None, :]
                     < frag_lens[:, None]))
    word = torch.zeros((n, nw_pos), dtype=_I32, device=dev)
    for k in range(w):
        word = word | (two_bit[:, k:nw_pos + k] << (2 * (w - 1 - k)))
    vc = torch.cat([torch.zeros((n, 1), dtype=_I32, device=dev),
                    torch.cumsum(valid_base, dim=1, dtype=_I32)], dim=1)
    word_valid = (vc[:, w:] - vc[:, :-w]) == w
    word_valid = word_valid & (torch.arange(nw_pos, device=dev)[None, :]
                               < (frag_lens - w + 1)[:, None])
    return word, word_valid


def seed_table_path(frags, frag_lens, w_table, *, word_len, num_os,
                    max_words, tile_len, cap, s_max=1, k_max=1):
    """The word-table path of the JAX _seed_fragment for a batch of
    fragment codes (n, L) uint8: lanes of the first `cap` any-match
    positions, deduped by one sort.  Returns (slot, p, n_cand, counts,
    overflow, word, word_valid) as the module docstring says."""
    n = frags.shape[0]
    L = tile_len
    nw_pos = L - word_len + 1
    dev = frags.device
    word, word_valid = target_words(frags, frag_lens, word_len, tile_len)
    # diagonal index space: p in [-(max_words-1), L) -> idx = p + max_words
    PL = L + max_words
    a_any = (w_table != 0).any(dim=1)
    any_m = a_any[word.long()] & word_valid
    widx = compact(any_m, cap, nw_pos)                 # (n, cap)
    w_ok = widx < nw_pos
    wsel = widx.clamp(0, nw_pos - 1)
    wv_sel = torch.gather(word, 1, wsel).long()
    masks = torch.where(w_ok[..., None], w_table[wv_sel], 0).to(_I64)

    # slot occupancy in two 32-bit lanes (num_os <= 64), held in int64
    occ = (masks != 0).to(_I64)
    lo_n = min(num_os, 32)
    sh = torch.arange(num_os, dtype=_I64, device=dev) % 32
    m0 = (occ[..., :lo_n] << sh[:lo_n]).sum(dim=-1)
    m1 = ((occ[..., 32:] << sh[32:]).sum(dim=-1) if num_os > 32
          else torch.zeros_like(m0))
    # extract up to s_max matching slots per position
    slot_lanes = []
    for _ in range(s_max):
        nz0 = m0 != 0
        nz1 = m1 != 0
        i0 = _low_bit_index(m0)
        i1 = _low_bit_index(m1) + 32
        slot_lanes.append(torch.where(
            nz0, i0, torch.where(nz1, i1, num_os)))
        m0 = torch.where(nz0, m0 & (m0 - 1), m0)
        m1 = torch.where(~nz0 & nz1, m1 & (m1 - 1), m1)
    s_resid = (m0 != 0) | (m1 != 0)
    slot_l = torch.stack(slot_lanes, dim=2)          # (n, cap, s_max)
    s_ok = slot_l < num_os
    kmask = torch.gather(masks, 2, slot_l.clamp(0, num_os - 1))
    kmask = torch.where(s_ok, kmask, 0)
    # extract up to k_max word indices per (position, slot)
    k_lanes = []
    for _ in range(k_max):
        nzk = kmask != 0
        k_lanes.append(torch.where(nzk, _low_bit_index(kmask), -1))
        kmask = torch.where(nzk, kmask & (kmask - 1), kmask)
    k_resid = kmask != 0
    k_l = torch.stack(k_lanes, dim=3)       # (n, cap, s_max, k_max)
    lane_ok = k_l >= 0
    p_l = wsel[:, :, None, None] - k_l.clamp_min(0)
    SENT = PL * num_os
    key = torch.where(lane_ok,
                      (p_l + max_words) * num_os + slot_l[..., None],
                      SENT).reshape(n, -1)
    key = torch.sort(key, dim=1).values
    K = key.shape[1]
    uniq = (key < SENT) & torch.cat(
        [torch.ones((n, 1), dtype=torch.bool, device=dev),
         key[:, 1:] != key[:, :-1]], dim=1)
    n_cand = uniq.sum(dim=1).to(_I32)
    cidx = compact(uniq, cap, K)
    cvalid = cidx < K
    ksel = torch.gather(key, 1, cidx.clamp(0, K - 1))
    slot = torch.where(cvalid, ksel % num_os, 0).to(_I32)
    p = torch.where(cvalid, ksel // num_os - max_words, 0).to(_I32)
    counts = torch.zeros((n, num_os + 1), dtype=_I64, device=dev)
    counts.scatter_add_(1, torch.where(uniq, key % num_os, num_os),
                        torch.ones_like(key))
    counts = counts[:, :num_os].to(_I32)
    overflow = ((any_m.sum(dim=1) > cap) | s_resid.any(dim=1)
                | k_resid.flatten(1).any(dim=1) | (n_cand > cap))
    return slot, p, n_cand, counts, overflow, word, word_valid


def seed_reference(frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c,
                   w_table, *, word_len, num_os, max_words, tile_len, cap,
                   s_max=1, k_max=1):
    """Plain PyTorch version: the payload unpack, then the table path."""
    frags = unpack_fragments(frags_packed, frag_lens, nrun_s, nrun_e, exc_p,
                             exc_c, tile_len)
    return seed_table_path(frags, frag_lens, w_table, word_len=word_len,
                           num_os=num_os, max_words=max_words,
                           tile_len=tile_len, cap=cap, s_max=s_max,
                           k_max=k_max)


def seed_lanes(w_table):
    """(s_max, k_max) of a (4^w, num_os) int32 w_table (numpy): the most
    slots holding one word and the most indices of one word in one oligo,
    each at least 1; the table path's lanes, so that nothing is left as a
    residue."""
    u = np.asarray(w_table).astype(np.int64) & 0xFFFFFFFF
    pop = np.zeros(u.shape, np.int64)
    for b in range(32):
        pop += (u >> b) & 1
    return (max(1, int((u != 0).sum(axis=1).max(initial=0))),
            max(1, int(pop.max(initial=0))))


def seed_tables(w_table, *, num_os, max_words, s_max, k_max):
    """The kernel's tables of a (4^w, num_os) int32 w_table (numpy), built
    once a panel: KS (4^w, max_words) uint64, bit s of KS[v, k] set iff
    slot s is among the s_max lowest slots holding word v and k among the
    k_max lowest set bits of w_table[v, s]; VF (4^w,) uint8, bit 0 iff some
    slot holds v, bit 1 iff v leaves a slot residue (more than s_max slots)
    or a k residue (an extracted slot with more than k_max bits).  Raises
    where the kernel cannot take the table."""
    wt = np.asarray(w_table)
    if wt.ndim != 2 or wt.shape[1] != num_os or wt.dtype != np.int32:
        raise ValueError(f"seed_tables: w_table {wt.dtype} {wt.shape}, "
                         f"expected int32 (4^w, {num_os})")
    if not 1 <= num_os <= MAX_SLOTS:
        raise ValueError(f"seed_tables: num_os {num_os} outside "
                         f"[1, {MAX_SLOTS}]")
    if not 1 <= max_words <= MAX_WORDS:
        raise ValueError(f"seed_tables: max_words {max_words} outside "
                         f"[1, {MAX_WORDS}]")
    if s_max < 1 or k_max < 1:
        raise ValueError(f"seed_tables: s_max {s_max}, k_max {k_max}")
    u = wt.astype(np.int64) & 0xFFFFFFFF
    if (u >> max_words).any():
        raise ValueError(f"seed_tables: a k-bitmask has a bit at or above "
                         f"max_words {max_words}")
    # the held (word, slot) entries, word-major and slots ascending, and
    # each one's rank among its word's slots
    v, sl = np.nonzero(u)
    m = u[v, sl]
    rank = np.arange(len(v)) - np.searchsorted(v, v)
    lane_s = rank < s_max
    ks = np.zeros((wt.shape[0], max_words), np.uint64)
    below = np.zeros(len(v), np.int64)          # set bits below k
    for k in range(max_words):
        on = ((m >> k) & 1).astype(bool)
        lane = on & lane_s & (below < k_max)
        np.bitwise_or.at(ks[:, k], v[lane],
                         np.uint64(1) << sl[lane].astype(np.uint64))
        below += on
    resid = np.zeros(wt.shape[0], bool)
    resid[v[(rank >= s_max) | (lane_s & (below > k_max))]] = True
    vf = ((u != 0).any(axis=1) | (resid << 1)).astype(np.uint8)
    return ks, vf


def _library():
    """The kernel's ctypes library, its entry points typed."""
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("seed")
    if lib.seed_launch_plan.argtypes is None:
        bind(lib)
    return lib


def bind(lib):
    """Sets the argument types of the entry points of a seed library (the
    package's, or the CPU tests' host build)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, types, res in (
            ("seed_plan_bytes", [], ctypes.c_int),
            ("seed_plan", [P] * 3 + [I] * 6, ctypes.c_int),
            ("seed_scratch_words", [P, I], ctypes.c_longlong),
            ("seed_launch_plan", [P] * 15 + [I] * 3 + [P], ctypes.c_int)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = res
    return lib


def empty_outputs(n, cap, num_os, nw_pos, device):
    """The seven outputs, uninitialised (the kernel writes every element)."""
    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    return (e((n, cap), _I32), e((n, cap), _I32), e((n,), _I32),
            e((n, num_os), _I32), e((n,), torch.bool), e((n, nw_pos), _I32),
            e((n, nw_pos), torch.bool))


def _int32(bits):
    """int64 values below 2**32 as the int32 of the same 32 bits."""
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(_I32)


def aux_tables(ks, vf):
    """The kernel's two tables derived from KS and VF, in one int32 tensor
    on their device: first VF's bit 0 (some oligo holds the word) a bit a
    word value, bit v % 32 of word v // 32 (the words launch keeps it in
    shared memory), then a word a word value: bit k set iff KS[v, k] is not
    empty, bit 31 VF's bit 1 (the keys launch reads only the KS entries
    that hold slots)."""
    held = (vf & 1).to(_I64)
    held = torch.cat([held, held.new_zeros(-held.numel() % 32)])
    shifts = torch.arange(32, dtype=_I64, device=vf.device)
    held = (held.view(-1, 32) << shifts).sum(dim=1)
    k = torch.arange(ks.shape[1], dtype=_I64, device=ks.device)
    kmask = (((ks != 0).to(_I64) << k).sum(dim=1)
             | ((vf.to(_I64) >> 1) & 1) << 31)
    return _int32(torch.cat([held, kmask]))


def make_plan(lib, ks, vf, *, L, word_len, num_os, max_words, cap, index):
    """A filled plan buffer of `lib` (holding its tables: KS, VF and
    aux_tables(KS, VF), which it keeps alive) and its scratch words a
    fragment, or ValueError where the kernel refuses the shapes."""
    plan = (ctypes.c_uint64 * -(-lib.seed_plan_bytes() // 8))()
    plan.tables = (ks, vf, aux_tables(ks, vf))
    rc = lib.seed_plan(plan, ks.data_ptr(), plan.tables[2].data_ptr(), L,
                       word_len, num_os, max_words, cap, index)
    if rc != 0:
        raise ValueError(f"seed: the kernel refuses L {L}, word_len "
                         f"{word_len}, num_os {num_os}, max_words "
                         f"{max_words}, cap {cap}: CUDA error {rc}")
    return plan, lib.seed_scratch_words(plan, 1)


def launch_args(plan, payload, out, scratch):
    """seed_launch_plan's arguments up to the stream."""
    packed, _, nrun_s, _, exc_p, _ = payload
    return (plan, *(t.data_ptr() for t in payload),
            *(t.data_ptr() for t in out), scratch.data_ptr(),
            packed.shape[0], nrun_s.shape[1], exc_p.shape[1])


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"seed: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"seed: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"seed: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"seed: {name} must be contiguous")


def _check_payload(who, payload, dev, L):
    """Raises unless the six payload tensors are a step's payload of at
    least one fragment in a tile of L on `dev`, contiguous."""
    frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c = payload
    if L % 4 != 0 or frags_packed.dim() != 2 or nrun_s.dim() != 2 \
            or exc_p.dim() != 2:
        raise ValueError(f"{who}: L must be a multiple of 4 and the payload "
                         "2-D")
    n, R, E = frags_packed.shape[0], nrun_s.shape[1], exc_p.shape[1]
    for name, t, dtype, shape in (
            ("frags_packed", frags_packed, torch.uint8, (n, L // 4)),
            ("frag_lens", frag_lens, _I32, (n,)),
            ("nrun_s", nrun_s, _I32, (n, R)), ("nrun_e", nrun_e, _I32, (n, R)),
            ("exc_p", exc_p, _I32, (n, E)),
            ("exc_c", exc_c, torch.uint8, (n, E))):
        _check(name, t, dev, dtype, shape)
    if n < 1:
        raise ValueError(f"{who}: no fragment")


class SeedPlan:
    """The kernel's one launch path: a panel's seed tables (`ks`, `vf` of
    `seed_tables`, on one card) and its static shapes, checked once, here.
    A call then takes one step's payload

        frags_packed (n, L / 4) uint8, frag_lens (n,) int32,
        nrun_s, nrun_e (n, R) int32, exc_p (n, E) int32, exc_c (n, E) uint8

    on the plan's card, contiguous, and reads only their pointers and n, R
    and E: the device step (panel_step_core) guarantees the rest, `seed`
    checks it.  It returns the seven outputs, launches on the card's
    current stream, read each call, counts the call in `seed.launches`,
    and raises when a launch fails; there is no plain fallback, and CPU
    tensors are refused (a CPU panel runs the plain version)."""

    def __init__(self, ks, vf, *, L, word_len, num_os, max_words, cap):
        dev = ks.device
        if dev.type != "cuda":
            raise ValueError(f"SeedPlan: tables on {dev}; the plan serves "
                             "a card")
        L, word_len, num_os = int(L), int(word_len), int(num_os)
        max_words, cap = int(max_words), int(cap)
        if not 1 <= word_len <= MAX_WORD_LEN:
            raise ValueError(f"SeedPlan: word_len {word_len} outside "
                             f"[1, {MAX_WORD_LEN}]")
        _check("ks", ks, dev, _I64, (4 ** word_len, max_words))
        _check("vf", vf, dev, torch.uint8, (4 ** word_len,))
        self._plan, self._scratch = make_plan(
            _library(), ks, vf, L=L, word_len=word_len, num_os=num_os,
            max_words=max_words, cap=cap, index=dev.index)
        self.device, self.index = dev, dev.index
        self.shape = (cap, num_os, L - word_len + 1)
        self._tables = (ks, vf)                   # kept alive with the plan
        self._launch = _library().seed_launch_plan
        self._stream = torch._C._cuda_getCurrentRawStream

    @classmethod
    def from_table(cls, w_table, device, *, L, word_len, num_os, max_words,
                   cap, s_max, k_max):
        """The plan of a panel's host w_table (numpy): its seed tables
        built and uploaded to `device`."""
        ks, vf = seed_tables(w_table, num_os=num_os, max_words=max_words,
                             s_max=s_max, k_max=k_max)
        return cls(torch.from_numpy(ks.view(np.int64)).to(device),
                   torch.from_numpy(vf).to(device), L=L, word_len=word_len,
                   num_os=num_os, max_words=max_words, cap=cap)

    def __call__(self, frags_packed, frag_lens, nrun_s, nrun_e, exc_p,
                 exc_c):
        if not frags_packed.is_cuda:
            raise ValueError("SeedPlan: CPU tensors (call seed)")
        n = frags_packed.shape[0]
        out = empty_outputs(n, *self.shape, self.device)
        scratch = torch.empty(n * self._scratch, dtype=_I32,
                              device=self.device)
        payload = (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c)
        rc = self._launch(*launch_args(self._plan, payload, out, scratch),
                          self._stream(self.index))
        if rc != 0:
            raise RuntimeError(f"seed kernel launch failed: CUDA error {rc}")
        seed.launches += 1
        return out


def seed(frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c, w_table, *,
         word_len, num_os, max_words, tile_len, cap, s_max=1, k_max=1):
    """The seeding stage's table path: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring for the
    contract).  Returns (slot, p, n_cand, counts, overflow, word,
    word_valid)."""
    args = (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c)
    kw = dict(word_len=int(word_len), num_os=int(num_os),
              max_words=int(max_words), tile_len=int(tile_len), cap=int(cap),
              s_max=int(s_max), k_max=int(k_max))
    dev = frags_packed.device
    if dev.type == "cpu":
        return seed_reference(*args, w_table, **kw)
    if dev.type != "cuda":
        raise ValueError(f"seed: unsupported device {dev}")
    L = kw["tile_len"]
    _check_payload("seed", args, dev, L)
    _check("w_table", w_table, dev, _I32, (4 ** kw["word_len"], kw["num_os"]))
    kw.pop("tile_len")
    return SeedPlan.from_table(w_table.cpu().numpy(), dev, L=L, **kw)(*args)


seed.launches = 0


# ---- the dense path ---------------------------------------------------------

def seed_dense_path(frags, frag_lens, oligo_words, *, word_len, num_os,
                    max_words, tile_len, cap):
    """The dense path of the JAX _seed_fragment for a batch of fragment
    codes (n, L) uint8: a (n, L + max_words, num_os) seed bitmap from every
    target word against every oligo word of ow (num_os, max_words), then
    the two-stage compaction (the first cap non-empty diagonals, then the
    first cap (diagonal, slot) pairs inside them).  Returns (slot, p,
    n_cand, counts, overflow, word, word_valid) as the module docstring
    says."""
    n = frags.shape[0]
    L = tile_len
    nw_pos = L - word_len + 1
    dev = frags.device
    word, word_valid = target_words(frags, frag_lens, word_len, tile_len)
    # diagonal index space: p in [-(max_words-1), L) -> idx = p + max_words
    PL = L + max_words
    seeds = torch.zeros((n, PL, num_os), dtype=torch.bool, device=dev)
    for k in range(max_words):
        ow = oligo_words[:, k]                   # (num_os,)
        m = (word_valid[..., None] & (word[..., None] == ow[None, None, :])
             & (ow >= 0)[None, None, :])         # (n, nw_pos, num_os)
        off = max_words - k
        seeds[:, off:off + nw_pos] |= m

    counts = seeds.sum(dim=1).to(_I32)

    # --- two-stage compaction --------------------------------------------
    any_pos = seeds.any(dim=2)                   # (n, PL)
    n_pos = any_pos.sum(dim=1)
    pos_idx = compact(any_pos, cap, PL)
    pos_ok = pos_idx < PL
    sub = torch.gather(
        seeds, 1, pos_idx.clamp(0, PL - 1)[..., None].expand(n, cap, num_os)
    ) & pos_ok[..., None]
    cidx = compact(sub.reshape(n, cap * num_os), cap, cap * num_os)
    cvalid = cidx < cap * num_os
    pos_rank = torch.where(cvalid, cidx // num_os, 0)
    slot = torch.where(cvalid, cidx % num_os, 0).to(_I32)
    p = (torch.gather(pos_idx, 1, pos_rank.clamp(0, cap - 1))
         - max_words).to(_I32)
    p = torch.where(cvalid, p, 0)
    n_cand = sub.flatten(1).sum(dim=1).to(_I32)
    overflow = (n_pos > cap) | (counts.sum(dim=1) > cap)
    return slot, p, n_cand, counts, overflow, word, word_valid


def seed_dense_reference(frags_packed, frag_lens, nrun_s, nrun_e, exc_p,
                         exc_c, oligo_words, *, word_len, num_os, max_words,
                         tile_len, cap):
    """Plain PyTorch version: the payload unpack, then the dense path."""
    frags = unpack_fragments(frags_packed, frag_lens, nrun_s, nrun_e, exc_p,
                             exc_c, tile_len)
    return seed_dense_path(frags, frag_lens, oligo_words, word_len=word_len,
                           num_os=num_os, max_words=max_words,
                           tile_len=tile_len, cap=cap)


def _hash(v, bits):
    """csrc/seed_dense.cu's hash of word values v (int64 array): the top
    `bits` bits of v * DENSE_HASH_MUL mod 2^32."""
    return ((v.astype(np.uint64) * DENSE_HASH_MUL) & 0xFFFFFFFF) >> (32 - bits)


def dense_tables(ow, *, num_os, max_words):
    """The dense kernel's tables of a panel's ow (num_os, max_words) int32
    (numpy, -1 past a slot's words), built once a panel: `entries` (E, 4)
    int32, one row (k, low and high 32 bits of the slot set, 0) for each
    distinct (word value, k) some slot holds, by value then k; `hash`
    (2^bits, 4) int32, open addressing with linear probing from the top
    `bits` bits of v * DENSE_HASH_MUL: a value's row (v, its first entry,
    its entries, 0), empty rows (-1, 0, 0, 0), at most a quarter full;
    `filter` (2^DENSE_FILTER_BITS / 32,) int32, bit h of the top
    DENSE_FILTER_BITS bits of each held value's product.  Returns (hash,
    entries, filter, bits); raises where the kernel cannot take ow."""
    ow = np.asarray(ow)
    if ow.ndim != 2 or ow.shape != (num_os, max_words) \
            or ow.dtype != np.int32:
        raise ValueError(f"dense_tables: ow {ow.dtype} {ow.shape}, expected "
                         f"int32 ({num_os}, {max_words})")
    if not 1 <= num_os <= MAX_SLOTS:
        raise ValueError(f"dense_tables: num_os {num_os} outside "
                         f"[1, {MAX_SLOTS}]")
    if not 1 <= max_words <= DENSE_MAX_WORDS:
        raise ValueError(f"dense_tables: max_words {max_words} outside "
                         f"[1, {DENSE_MAX_WORDS}]")
    s_idx, k_idx = np.nonzero(ow >= 0)
    v = ow[s_idx, k_idx].astype(np.int64)
    if (v >= 1 << (2 * DENSE_MAX_WORD_LEN)).any():
        raise ValueError("dense_tables: a word above 30 bits")
    key = v * max_words + k_idx
    uk, inv = np.unique(key, return_inverse=True)
    sets = np.zeros(len(uk), np.uint64)
    np.bitwise_or.at(sets, inv, np.uint64(1) << s_idx.astype(np.uint64))
    uv, uk_k = uk // max_words, uk % max_words
    entries = np.zeros((max(len(uk), 1), 4), np.int64)
    entries[:len(uk), 0] = uk_k
    entries[:len(uk), 1] = (sets & 0xFFFFFFFF).astype(np.int64)
    entries[:len(uk), 2] = (sets >> np.uint64(32)).astype(np.int64)
    values, first, count = np.unique(uv, return_index=True,
                                     return_counts=True)
    bits = max(6, int(np.ceil(np.log2(max(4 * len(values), 1)))))
    hash_ = np.zeros((1 << bits, 4), np.int64)
    hash_[:, 0] = -1
    mask = (1 << bits) - 1
    for val, h, f, c in zip(values.tolist(), _hash(values, bits).tolist(),
                            first.tolist(), count.tolist()):
        while hash_[h, 0] >= 0:
            h = (h + 1) & mask
        hash_[h] = (val, f, c, 0)
    filt = np.zeros(1 << (DENSE_FILTER_BITS - 5), np.int64)
    for fb in _hash(values, DENSE_FILTER_BITS).tolist():
        filt[fb >> 5] |= 1 << (fb & 31)

    def i32(a):
        return (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)

    return i32(hash_), i32(entries), i32(filt), bits


def _dense_library():
    """The dense kernel's ctypes library, its entry points typed."""
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("seed_dense")
    if lib.seed_dense_launch_plan.argtypes is None:
        bind_dense(lib)
    return lib


def bind_dense(lib):
    """Sets the argument types of the entry points of a seed_dense library
    (the package's, or the CPU tests' host build)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, types, res in (
            ("seed_dense_plan_bytes", [], ctypes.c_int),
            ("seed_dense_plan", [P] * 4 + [I] * 7, ctypes.c_int),
            ("seed_dense_scratch_words", [P, I], ctypes.c_longlong),
            ("seed_dense_plan_tiling", [P, P], None),
            ("seed_dense_launch_plan", [P] * 15 + [I] * 3 + [P],
             ctypes.c_int)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = res
    return lib


def make_dense_plan(lib, tables, *, L, word_len, num_os, max_words, cap,
                    index):
    """A filled plan buffer of `lib` (holding `tables`, the tensors of
    dense_tables' hash, entries and filter and its bits, which it keeps
    alive) and its scratch words a fragment, or ValueError where the kernel
    refuses the shapes."""
    plan = (ctypes.c_uint64 * -(-lib.seed_dense_plan_bytes() // 8))()
    plan.tables = tables
    hash_, entries, filt, bits = tables
    rc = lib.seed_dense_plan(plan, hash_.data_ptr(), entries.data_ptr(),
                             filt.data_ptr(), bits, L, word_len, num_os,
                             max_words, cap, index)
    if rc != 0:
        raise ValueError(f"seed_dense: the kernel refuses L {L}, word_len "
                         f"{word_len}, num_os {num_os}, max_words "
                         f"{max_words}, cap {cap}: CUDA error {rc}")
    return plan, lib.seed_dense_scratch_words(plan, 1)


class DenseSeedPlan:
    """The dense kernel's one launch path: a panel's ow (num_os, max_words)
    int32 on one card, its tables (dense_tables) and its static shapes,
    checked once, here.  A call takes one step's payload as SeedPlan's
    does, reads only its pointers and n, R and E (the device step
    guarantees the rest, `seed_dense` checks it), returns the seven
    outputs, launches on the card's current stream, counts the call in
    `seed_dense.launches`, and raises when a launch fails; CPU tensors are
    refused (a CPU panel runs the plain version)."""

    def __init__(self, ow, *, L, word_len, num_os, max_words, cap):
        dev = ow.device
        if dev.type != "cuda":
            raise ValueError(f"DenseSeedPlan: ow on {dev}; the plan serves "
                             "a card")
        L, word_len, num_os = int(L), int(word_len), int(num_os)
        max_words, cap = int(max_words), int(cap)
        if not 1 <= word_len <= DENSE_MAX_WORD_LEN:
            raise ValueError(f"DenseSeedPlan: word_len {word_len} outside "
                             f"[1, {DENSE_MAX_WORD_LEN}]")
        _check("ow", ow, dev, _I32, (num_os, max_words))
        hash_, entries, filt, bits = dense_tables(
            ow.cpu().numpy(), num_os=num_os, max_words=max_words)
        tables = (*(torch.from_numpy(a).to(dev)
                    for a in (hash_, entries, filt)), bits)
        lib = _dense_library()
        self._plan, self._scratch = make_dense_plan(
            lib, tables, L=L, word_len=word_len, num_os=num_os,
            max_words=max_words, cap=cap, index=dev.index)
        self.device, self.index = dev, dev.index
        self.shape = (cap, num_os, L - word_len + 1)
        self._tables = tables
        self._launch = lib.seed_dense_launch_plan
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, frags_packed, frag_lens, nrun_s, nrun_e, exc_p,
                 exc_c):
        if not frags_packed.is_cuda:
            raise ValueError("DenseSeedPlan: CPU tensors (call seed_dense)")
        n = frags_packed.shape[0]
        out = empty_outputs(n, *self.shape, self.device)
        scratch = torch.empty(n * self._scratch, dtype=_I32,
                              device=self.device)
        payload = (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c)
        rc = self._launch(*launch_args(self._plan, payload, out, scratch),
                          self._stream(self.index))
        if rc != 0:
            raise RuntimeError(f"seed_dense kernel launch failed: CUDA error "
                               f"{rc}")
        seed_dense.launches += 1
        return out


def seed_dense(frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c, ow, *,
               word_len, num_os, max_words, tile_len, cap):
    """The seeding stage's dense path: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring for the
    contract).  Returns (slot, p, n_cand, counts, overflow, word,
    word_valid)."""
    args = (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c)
    kw = dict(word_len=int(word_len), num_os=int(num_os),
              max_words=int(max_words), tile_len=int(tile_len), cap=int(cap))
    dev = frags_packed.device
    if dev.type == "cpu":
        return seed_dense_reference(*args, ow, **kw)
    if dev.type != "cuda":
        raise ValueError(f"seed_dense: unsupported device {dev}")
    _check_payload("seed_dense", args, dev, kw["tile_len"])
    _check("ow", ow, dev, _I32, (kw["num_os"], kw["max_words"]))
    L = kw.pop("tile_len")
    return DenseSeedPlan(ow, L=L, **kw)(*args)


seed_dense.launches = 0
