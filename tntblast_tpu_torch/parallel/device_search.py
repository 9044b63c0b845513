"""Full-fragment device search step in PyTorch.

Port of tntblast_tpu/parallel/device_search.py (flat screen path).  One
step per fragment batch, for all oligos of the panel at once:

  1. payload unpack: 2-bit base stream + N-run prefix sum + exception
     scatter back to fragment codes,
  2. k-mer seeding per fragment (word-table path, or the dense compare
     path for long oligos / heavily shared words),
  3. pooling of every fragment's candidates into one slot-major stream by
     a stable sort on slot (invalid entries sort last),
  4. per 32768-window chunk: window decode from the word stream, the
     screening DP at every screening temperature plus the eval temperature
     (ops/screen_dp.py, the hand-written CUDA kernel on a card), and the
     gapless exact evaluator (ops/eval_gapless.py),
  5. kept-seed compaction + kmin recomputation into one packed int32
     header and one (9, bkcap) kept block.

Every fixed-size `jnp.nonzero(size=...)` of the JAX step is a cumsum +
scatter compaction here (`_compact`), and every gather that relied on JAX's
silent index clamping clips explicitly.  The step issues no host sync:
`DevicePanel.submit_fragments` returns as soon as the work is queued on the
device, and the resolve (on another thread) copies back the header and the
used prefix of the kept block.  All work runs on the device's current
stream (the default stream unless the caller set another one), so the
resolve thread's copies are ordered after it.
"""

import numpy as np
import torch
from torch.profiler import record_function as _span

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.ops.eval_gapless import (
    build_slot_eval_arrays, eval_flat)
from tntblast_tpu_torch.ops.screen_dp import screen_dp
from tntblast_tpu_torch.ops.thermo_dp import (
    NUM_T5, build_qpair_rows, build_t_canon)

# pooled-stream chunk size of the screening DP (entries per chunk)
SCREEN_CHUNK = 32768

INT_MIN = -(1 << 31) + 1

_I32 = torch.int32
_I64 = torch.int64


# copy of tntblast_tpu/parallel/device_search.py:63-99 PanelConfig
class PanelConfig:
    """Static shape configuration for a run."""

    # windows per DP launch: bounds the per-chunk window tensors
    DP_CHUNK = 4096

    def __init__(self, word_len, num_os, max_words, wq_max, tile_len,
                 cap, num_cond, kcap=None):
        self.word_len = int(word_len)
        self.num_os = int(num_os)          # oligo-strand slots (padded)
        self.max_words = int(max_words)    # compacted word-list capacity
        self.wq_max = int(wq_max)
        self.wt = int(wq_max) + 2 * C.NUM_FLANK_BASE
        self.tile_len = int(tile_len)      # fragment buffer length (padded)
        cap = int(cap)
        if cap > self.DP_CHUNK:            # chunked DP needs even division
            cap = -(-cap // self.DP_CHUNK) * self.DP_CHUNK
        self.cap = cap                     # candidate capacity per fragment
        # per-fragment capacity of the device-compacted KEPT-seed list
        # (scaled by the batch size and pooled); callers with screening
        # disabled pass kcap=cap
        self.kcap = int(kcap) if kcap is not None else max(
            (3 * cap) // 4, 512)
        self.kcap = min(self.kcap, cap)
        self.num_cond = int(num_cond)

    def batch_kcap(self, n_frags):
        if self.kcap:
            return min(self.kcap * n_frags, n_frags * self.cap)
        return n_frags * self.cap


def _compact(mask, size, fill):
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


def seed_fragments(frags, frag_lens, oligo_words, w_table, *, word_len,
                   num_os, max_words, tile_len, cap, s_max=1, k_max=1):
    """Seeding + compaction for a batch of fragments (the JAX
    _seed_fragment under its fragment vmap).

    frags (n, L) uint8 codes, frag_lens (n,) int32; w_table is the
    (4^w, num_os) word -> per-slot k-bitmask table, or a (1, num_os) dummy
    that selects the dense compare path.

    Returns (slot, p, n_cand, counts, overflow, word, word_valid):
      slot/p (n, cap) int32 compacted ((diagonal, slot) lexicographic),
      n_cand (n,) int32 true candidate counts, counts (n, num_os) int32,
      overflow (n,) bool, word/word_valid (n, nw_pos) target words.
    """
    n = frags.shape[0]
    w = word_len
    L = tile_len
    nw_pos = L - w + 1
    dev = frags.device
    codes = frags.to(_I32)

    # --- target words -----------------------------------------------------
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

    # diagonal index space: p in [-(max_words-1), L) -> idx = p + max_words
    PL = L + max_words
    if w_table.shape[0] > 1:
        a_any = (w_table != 0).any(dim=1)
        any_m = a_any[word.long()] & word_valid
        widx = _compact(any_m, cap, nw_pos)                 # (n, cap)
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
        cidx = _compact(uniq, cap, K)
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

    # --- dense fallback (long oligos / heavily shared words) -------------
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
    pos_idx = _compact(any_pos, cap, PL)
    pos_ok = pos_idx < PL
    sub = torch.gather(
        seeds, 1, pos_idx.clamp(0, PL - 1)[..., None].expand(n, cap, num_os)
    ) & pos_ok[..., None]
    cidx = _compact(sub.reshape(n, cap * num_os), cap, cap * num_os)
    cvalid = cidx < cap * num_os
    pos_rank = torch.where(cvalid, cidx // num_os, 0)
    slot = torch.where(cvalid, cidx % num_os, 0).to(_I32)
    p = (torch.gather(pos_idx, 1, pos_rank.clamp(0, cap - 1))
         - max_words).to(_I32)
    p = torch.where(cvalid, p, 0)
    n_cand = sub.flatten(1).sum(dim=1).to(_I32)
    overflow = (n_pos > cap) | (counts.sum(dim=1) > cap)
    return slot, p, n_cand, counts, overflow, word, word_valid


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


def slot_tables(slot_meta, num_os, wq_max, thresholds, device):
    """Per-slot tables indexed by slot id in [0, num_os]; ids >= n_real hold
    the JAX select-chain defaults (ql 1, plus strand, threshold off, zero
    query codes)."""
    n_real = len(slot_meta)
    ql = np.ones(num_os + 1, np.int32)
    minus = np.zeros(num_os + 1, bool)
    qp = np.zeros((max(n_real, 1), wq_max), np.int32)
    qc = np.zeros((num_os + 1, wq_max), np.int32)
    for s, m in enumerate(slot_meta):
        ql[s] = m[0]
        minus[s] = m[1]
        qp[s, :m[0]] = m[2]
        qc[s, :m[0]] = m[4]
    thr = np.full((thresholds.shape[0], num_os + 1), INT_MIN, np.int32)
    thr[:, :thresholds.shape[1]] = thresholds

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"ql": t(ql), "minus": t(minus), "qp": t(qp[:n_real]),
            "qc": t(qc), "thr": t(thr)}


def _win_decode(pp, fi, minus, wt_e, frag_lens, word_f, word_valid_f, *,
                n, L, wt_max, word_len, nw_pos):
    """Window codes from the WORD stream (JAX win_decode): a window is
    device-usable only when every covering word is valid (pure ACGT);
    others are routed to the host.  Returns (needs_host, tb5, ptb)."""
    B = pp.shape[0]
    dev = pp.device
    flen = frag_lens[fi.clamp(0, n - 1).long()]
    start = pp - C.NUM_FLANK_BASE
    full_win = (start >= 0) & (start + wt_e <= flen)
    start_c = start.clamp(0, L - wt_max)
    n_words_win = -(-wt_max // word_len)
    base_g = fi * nw_pos
    kw = torch.arange(n_words_win, dtype=_I32, device=dev)[None, :]
    wpos_raw = start_c[:, None] + kw * word_len
    gidx = (base_g[:, None] + wpos_raw.clamp(0, nw_pos - 1)).long()
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
    col_ok = jj[None, :] < wt_e[:, None]
    needs_host = (~full_win) | ~clean
    tb5 = torch.where(col_ok, melt, 0)
    pt6 = torch.cat([torch.full((B, 1), 5, dtype=_I32, device=dev),
                     tb5[:, :-1]], dim=1)
    return needs_host, tb5, pt6 * NUM_T5 + tb5


def _wrap32(x):
    """int64 -> int32 keeping the low 32 bits (int32 wraparound)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(_I32)


def _pack_eval(ev, needs_host, ent_valid):
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


def panel_step_core(payload, tabs, *, eval_const, word_len, num_os,
                    max_words, wq_max, tile_len, cap, kcap, num_cond,
                    n_frags, s_max=1, k_max=1, eval_on=False, full=False):
    """Device step: seeds + screening DP + gapless eval for a batch.

    payload: (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c,
      input_over) tensors on the device (DevicePanel._pack_host)
    tabs: DevicePanel device tables (ow, w_tab, tc_all, slot tables,
      ev_tabs, ev_loop)

    Returns (header, kept_block, slot, p, keep, needs_host, valid), the
    layout of the JAX panel_step_core (see its docstring).
    """
    (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c,
     input_over) = payload
    n = n_frags
    L = tile_len
    nw_pos = L - word_len + 1
    bkcap = min(kcap * n, n * cap) if kcap else n * cap
    wt_max = wq_max + 2 * C.NUM_FLANK_BASE
    dev = frags_packed.device
    st = tabs["slots"]

    # profiler spans name the step's stages (no cost without a profiler)
    with _span("tnt.seed"):
        frags = unpack_fragments(frags_packed, frag_lens, nrun_s, nrun_e,
                                 exc_p, exc_c, L)
        (slot, p, n_cand, counts, overflow, word,
         word_valid) = seed_fragments(
            frags, frag_lens, tabs["ow"], tabs["w_tab"], word_len=word_len,
            num_os=num_os, max_words=max_words, tile_len=tile_len, cap=cap,
            s_max=s_max, k_max=k_max)
        overflow = overflow | input_over

    # --- pooled candidate stream, slot-major via stable sort -------------
    with _span("tnt.pool"):
        Bp = n * cap
        slot_f = slot.reshape(Bp)
        p_f = p.reshape(Bp)
        ar = torch.arange(Bp, dtype=_I32, device=dev)
        rank = ar % cap
        frag_f = ar // cap
        # compacted entries per fragment: the compaction truncates at cap
        # while n_cand is the TRUE count (overflowing fragments go to the
        # host)
        n_comp = torch.clamp_max(n_cand, cap)
        valid = rank < n_comp[frag_f.long()]
        key = torch.where(valid, slot_f, num_os)
        order = torch.sort(key, stable=True).indices
        # invalid entries carry key num_os and land after every real slot:
        # within a slot the order is fragment-major, p-ascending (reference
        # seed order)
        slot_str = key[order]
        p_str = p_f[order]
        frag_str = frag_f[order]
        order_str = order.to(_I32)

    word_f = word.reshape(-1)
    word_valid_f = word_valid.reshape(-1)
    CH = min(SCREEN_CHUNK, Bp)
    keep_parts, nh_parts, ev_parts = [], [], []
    for c0 in range(0, Bp, CH):
        sl = slot_str[c0:c0 + CH]
        pp = p_str[c0:c0 + CH]
        fi = frag_str[c0:c0 + CH]
        B = sl.shape[0]
        ent_valid = sl < num_os
        sli = sl.clamp(0, num_os).long()
        ql = st["ql"][sli]
        minus = st["minus"][sli]
        wt_e = ql + 2 * C.NUM_FLANK_BASE
        thr_e = st["thr"][:, sli]
        with _span("tnt.decode"):
            needs_host, tb5, ptb = _win_decode(
                pp, fi, minus, wt_e, frag_lens, word_f, word_valid_f, n=n,
                L=L, wt_max=wt_max, word_len=word_len, nw_pos=nw_pos)
        with _span("tnt.screen_dp"):
            best, mgmax, M_rows = screen_dp(
                ptb.contiguous(), sl.contiguous(), ql.contiguous(),
                wt_e.contiguous(), st["qp"], tabs["tc_all"],
                eval_on=eval_on)
        keep = torch.ones(B, dtype=torch.bool, device=dev)
        for c in range(num_cond):
            keep = keep & ((best[c] >= thr_e[c]) | (thr_e[c] == INT_MIN))
        if eval_on:
            with _span("tnt.eval"):
                ev = eval_flat(M_rows, mgmax, tb5, st["qc"][sli], ql, wt_e,
                               sl.clamp(0, num_os - 1).long(),
                               tabs["ev_tabs"], tabs["ev_loop"], eval_const)
                evw = _pack_eval(ev, needs_host, ent_valid)
        else:
            evw = torch.zeros((B, 5), dtype=_I32, device=dev)
        keep_parts.append((keep | needs_host) & ent_valid)
        nh_parts.append(needs_host & ent_valid)
        ev_parts.append(evw)
    keep_all = torch.cat(keep_parts)
    nh_all = torch.cat(nh_parts)
    ev_all = torch.cat(ev_parts)

    # --- kept-seed compaction + kmin recomputation -----------------------
    with _span("tnt.compact"):
        n_kept = keep_all.sum().to(_I32)
        kept_idx = _compact(keep_all[None], bkcap, Bp)[0]
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
        ow_sel = tabs["ow"][os_k.clamp(0, num_os - 1).long()]
        match = wok & (ow_sel >= 0) & (wv == ow_sel)
        kmin_k = torch.where(match, kk, max_words).amin(dim=1).to(_I32)
        kmin_k = torch.where(kv, kmin_k, 0)

        ev_k = torch.where(kv[:, None], ev_all[ks], 0)
        header = torch.cat([
            n_kept[None], overflow.to(_I32),
            torch.zeros(num_os, dtype=_I32, device=dev),
            n_cand, counts.reshape(-1)])
        kept_block = torch.stack([
            pool_idx, os_k, p_k, kmin_k,
            ev_k[:, 0], ev_k[:, 1], ev_k[:, 2], ev_k[:, 3], ev_k[:, 4]])

    if full:
        # pool-order keep/needs_host (tests): scatter through the sort
        def to_pool(flag):
            out = torch.zeros(Bp + 1, dtype=torch.bool, device=dev)
            out[torch.where(flag, order_str, Bp).long()] = True
            return out[:Bp].reshape(n, cap)
        keep_out = to_pool(keep_all)
        nh_out = to_pool(nh_all)
    else:
        keep_out = torch.zeros((n, cap), dtype=torch.bool, device=dev)
        nh_out = torch.zeros((n, cap), dtype=torch.bool, device=dev)

    return (header, kept_block, slot, p, keep_out, nh_out,
            valid.reshape(n, cap))


class DevicePanel:
    """Host-side wrapper: packs an oligo panel once, runs fragment batches
    on `device`."""

    # host->device payload sideband capacities (see _pack_host)
    RUN_CAP = 256          # N-run capacity per fragment
    EXC_CAP = 2048         # scattered exception capacity per fragment

    def __init__(self, panel, config, dg_tables, thresholds, eval_dg=None,
                 thermo_tables=None, *, device):
        """panel: list of dicts with keys words (int64[], compacted, scan
             order), codes (uint8[] melt), minus (bool)
           dg_tables: (num_cond, 2401) int32
           thresholds: (num_cond, len(panel)) int32 (INT_MIN = off)
           eval_dg/thermo_tables: delta_g at the engine temperature and the
             santa_lucia parameter set — enable the gapless evaluator
        """
        # copy of tntblast_tpu/parallel/device_search.py:965-1035 (the
        # panel table build)
        cfg = config
        eval_on = eval_dg is not None and thermo_tables is not None
        ow = np.full((cfg.num_os, cfg.max_words), -1, dtype=np.int32)
        meta = []
        ev_tabs = np.zeros((cfg.num_os, cfg.wq_max, 25, 4),
                           dtype=np.float32)
        ev_loop = np.zeros((cfg.num_os, cfg.wq_max + 2), dtype=np.float32)
        eval_const = (0.0, 0.0, 0.0, 0.0)
        for i, o in enumerate(panel):
            nw = len(o["words"])
            ow[i, :nw] = o["words"]
            codes = np.asarray(o["codes"], dtype=np.int64)
            qpr = build_qpair_rows(codes[None, :], [len(codes)],
                                   wq=len(codes))[0]
            meta.append((int(len(codes)), bool(o["minus"]),
                         tuple(int(v) for v in qpr), nw,
                         tuple(int(v) for v in codes)))
            if eval_on:
                tabs = build_slot_eval_arrays(codes, thermo_tables)
                ql = len(codes)
                ev_tabs[i, :ql, :, 0] = tabs["Hstk"]
                ev_tabs[i, :ql, :, 1] = tabs["Sstk"]
                ev_tabs[i, :ql, :, 2] = tabs["Hlt"]
                ev_tabs[i, :ql, :, 3] = tabs["Slt"]
                ev_loop[i, :ql + 1] = tabs["loop2m"]
                eval_const = (float(tabs["AT_H"]), float(tabs["AT_S"]),
                              float(tabs["init_H"]), float(tabs["init_S"]))
        thr = np.full((cfg.num_cond, cfg.num_os), INT_MIN, dtype=np.int32)
        thr[:, :len(panel)] = thresholds
        tcan = np.stack([build_t_canon(dg_tables[c])
                         for c in range(cfg.num_cond)])
        tcan_eval = (build_t_canon(eval_dg) if eval_on
                     else np.zeros((30, 30, 7), np.int32))
        # word -> per-slot k-bitmask lookup (fast seeding path); gated by
        # table size, bitmask width, and the extraction lane product, with
        # a (1, num_os) dummy that selects the dense compare path
        tw = 4 ** cfg.word_len
        s_max = k_max = 1
        if tw * cfg.num_os <= (16 << 20) and cfg.max_words <= 31:
            w_tab = np.zeros((tw, cfg.num_os), np.int32)
            for i, o in enumerate(panel):
                for k, v in enumerate(o["words"]):
                    w_tab[int(v), i] |= (1 << k)
            occ_rows = (w_tab != 0).sum(axis=1)
            pop = np.zeros_like(w_tab)
            for b in range(31):
                pop += (w_tab >> b) & 1
            s_ = max(1, int(occ_rows.max(initial=0)))
            k_ = max(1, int(pop.max(initial=0)))
            if s_ * k_ <= 8:
                s_max, k_max = s_, k_
            else:
                w_tab = np.zeros((1, cfg.num_os), np.int32)
        else:
            w_tab = np.zeros((1, cfg.num_os), np.int32)
        self._setup(cfg, tuple(meta), eval_const, s_max, k_max,
                    (ow, w_tab, tcan, thr, tcan_eval, ev_tabs, ev_loop),
                    device, eval_on)

    @classmethod
    def from_tables(cls, config, slot_meta, eval_const, s_max, k_max,
                    tables, device, *, eval_on):
        """A panel from already-built tables: slot_meta/eval_const/s_max/
        k_max and the seven arrays (ow, w_tab, tcan, thr, tcan_eval,
        ev_tabs, ev_loop) of a JAX DevicePanel."""
        self = cls.__new__(cls)
        self._setup(config, tuple(slot_meta), tuple(eval_const), s_max,
                    k_max, tuple(np.asarray(a) for a in tables), device,
                    eval_on)
        return self

    def _setup(self, cfg, slot_meta, eval_const, s_max, k_max, tables,
               device, eval_on):
        self.config = cfg
        self.slot_meta = slot_meta
        self.eval_const = eval_const
        self.s_max = int(s_max)
        self.k_max = int(k_max)
        self.n_real = len(slot_meta)
        self.eval_on = bool(eval_on)
        self.device = torch.device(device)
        self.host_tables = tables
        self.tabs = self._tables_on(self.device)

    def _tables_on(self, device):
        """The panel's device tables, uploaded to `device`."""
        cfg = self.config
        ow, w_tab, tcan, thr, tcan_eval, ev_tabs, ev_loop = self.host_tables
        tc_all = (np.concatenate([tcan, tcan_eval[None]], axis=0)
                  if self.eval_on else tcan)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return {
            "ow": t(ow), "w_tab": t(w_tab), "tc_all": t(tc_all),
            "ev_tabs": t(ev_tabs), "ev_loop": t(ev_loop),
            "slots": slot_tables(self.slot_meta, cfg.num_os, cfg.wq_max,
                                 np.asarray(thr), device),
        }

    def _pack_host(self, frag_code_list):
        # copy of tntblast_tpu/parallel/device_search.py:1067-1108
        # (DevicePanel._pack_host): 2-bit base stream + N-run / exception
        # sideband; an overflowing sideband flags the fragment for the host
        cfg = self.config
        n = len(frag_code_list)
        L = cfg.tile_len
        packed = np.zeros((n, L // 4), dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        run_s = np.full((n, self.RUN_CAP), L, dtype=np.int32)
        run_e = np.full((n, self.RUN_CAP), L, dtype=np.int32)
        exc_p = np.full((n, self.EXC_CAP), L, dtype=np.int32)
        exc_c = np.zeros((n, self.EXC_CAP), dtype=np.uint8)
        in_over = np.zeros(n, dtype=bool)
        for i, fc in enumerate(frag_code_list):
            if len(fc) > L:
                raise ValueError("fragment exceeds tile_len")
            lens[i] = len(fc)
            buf = np.zeros(L, dtype=np.uint8)
            buf[:len(fc)] = fc
            two = (buf & 3).astype(np.uint8)
            packed[i] = (two[0::4] | (two[1::4] << 2) | (two[2::4] << 4)
                         | (two[3::4] << 6))
            odd = np.flatnonzero(buf[:len(fc)] > C.DB_MAX_ATGC)
            if odd.size == 0:
                continue
            is_n = buf[odd] == C.DB_N
            npos = odd[is_n]
            rest = odd[~is_n]
            # N positions -> maximal runs
            if npos.size:
                brk = np.flatnonzero(np.diff(npos) > 1)
                starts = np.concatenate([[npos[0]], npos[brk + 1]])
                ends = np.concatenate([npos[brk] + 1, [npos[-1] + 1]])
                if len(starts) > self.RUN_CAP:
                    in_over[i] = True
                    continue
                run_s[i, :len(starts)] = starts
                run_e[i, :len(starts)] = ends
            if rest.size > self.EXC_CAP:
                in_over[i] = True
                continue
            exc_p[i, :rest.size] = rest
            exc_c[i, :rest.size] = buf[rest]
        return packed, lens, run_s, run_e, exc_p, exc_c, in_over

    @staticmethod
    def _upload(a, device):
        """Host array -> device tensor without a host sync: on CUDA the
        copy is staged through pinned memory and queued on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def step(self, payload, full=False, device=None, tabs=None):
        """Queue the device step on a host payload (numpy arrays); on the
        panel's own device and tables unless a replica's are given."""
        cfg = self.config
        device = self.device if device is None else device
        dev_payload = tuple(self._upload(a, device) for a in payload)
        return panel_step_core(
            dev_payload, self.tabs if tabs is None else tabs,
            eval_const=self.eval_const,
            word_len=cfg.word_len, num_os=cfg.num_os,
            max_words=cfg.max_words, wq_max=cfg.wq_max,
            tile_len=cfg.tile_len, cap=cfg.cap, kcap=cfg.kcap,
            num_cond=cfg.num_cond, n_frags=len(payload[0]),
            s_max=self.s_max, k_max=self.k_max, eval_on=self.eval_on,
            full=full)

    def submit_fragments(self, frag_code_list, full=False):
        """Queue ONE device step covering all fragments in the list
        (asynchronous); resolve with `resolve_fragments`."""
        n = len(frag_code_list)
        return n, self.step(self._pack_host(frag_code_list), full=full)

    def run_fragments(self, frag_code_list):
        """Submit and fully resolve one batch (tests)."""
        return self.resolve_fragments_full(
            self.submit_fragments(frag_code_list, full=True))

    def _unpack_header(self, n, header):
        cfg = self.config
        n_kept = int(header[0])
        o = 1
        overflow = header[o:o + n] != 0
        o += n
        slot_over = header[o:o + cfg.num_os] != 0
        o += cfg.num_os
        n_cand = header[o:o + n]
        o += n
        counts = header[o:o + n * cfg.num_os].reshape(n, cfg.num_os)
        return n_kept, overflow, slot_over, n_cand, counts

    def resolve_fragments(self, pending):
        """Fast resolve: the header, then only the used prefix of the kept
        block, cross to the host; the candidate arrays stay on the device."""
        n, out = pending
        cfg = self.config
        header = out[0].cpu().numpy()
        (n_kept, overflow, slot_over, n_cand,
         counts) = self._unpack_header(n, header)
        bkcap = cfg.batch_kcap(n)
        m = min(n_kept, bkcap)
        kept = out[1][:, :m].cpu().numpy()
        flat_idx, os_k, p_k, kmin_k = (kept[0], kept[1],
                                       kept[2], kept[3])
        evw = kept[4:9]
        frag_of = flat_idx // cfg.cap
        kept_over = n_kept > bkcap
        results = []
        for i in range(n):
            sel = frag_of == i
            ci = counts[i][:self.n_real]
            results.append({
                "os_k": os_k[sel], "p_k": p_k[sel], "kmin_k": kmin_k[sel],
                "eval": evw[:, sel] if self.eval_on else None,
                "counts": ci, "n_kept": int(sel.sum()),
                "slot_overflow": slot_over[:self.n_real],
                "overflow": bool(overflow[i]) or kept_over,
            })
        return results

    def resolve_fragments_full(self, pending):
        """Full resolve (tests): every candidate with its keep/needs_host
        verdict; requires a submit with full=True.  kmin is materialized
        for KEPT candidates only (screened-out rows report 0)."""
        n, out = pending
        cfg = self.config
        header = out[0].cpu().numpy()
        (n_kept, overflow, slot_over, n_cand,
         counts) = self._unpack_header(n, header)
        slot, p, keep, needs_host, valid = (o.cpu().numpy()
                                            for o in out[2:7])
        kmin_full = np.zeros((n, cfg.cap), dtype=np.int32)
        m = min(n_kept, cfg.batch_kcap(n))
        kept = out[1][:, :m].cpu().numpy()
        kmin_full[kept[0] // cfg.cap, kept[0] % cfg.cap] = kept[3]
        results = []
        for i in range(n):
            mm = int(n_cand[i])
            results.append({
                "os_idx": slot[i][:mm], "p": p[i][:mm],
                "kmin": kmin_full[i][:mm],
                "keep": keep[i][:mm], "needs_host": needs_host[i][:mm],
                "counts": counts[i][:self.n_real],
                "slot_overflow": slot_over[:self.n_real],
                "overflow": bool(overflow[i]),
            })
        return results
