"""Gapless exact evaluation of screened windows (torch ops).

Port of tntblast_tpu/ops/eval_gapless_jax.py::eval_flat; see that module
and ops/eval_gapless.py for the trust conditions and the reduction of the
reference evaluate_alignment (nuc_cruc.cpp:973-2299).  Per-slot table rows
are selected by integer gathers instead of the JAX one-hot f32 matmuls,
which is exact by construction.  The f32 dH/dS accumulation issues its adds
in the same order as the JAX scan, one elementwise op at a time, so the
results are bit-identical (eager torch neither reassociates nor contracts
them).
"""

import numpy as np
import torch


NUM_BASE = 7
NUM_BP = 49
# the longest run of mismatches whose internal loop (2 m bases) the loop
# entropy table holds (santa_lucia.MAX_LOOP_LENGTH 512): an entry with a
# longer run closed inside its trimmed alignment is not trusted, and the
# host evaluates it (oligos over 258 nt only)
LOOP_MAX_MM = 256


# copy of tntblast_tpu/ops/eval_gapless.py:76-108 build_slot_eval_tables
def build_slot_eval_tables(q_codes, tables):
    """Per-slot eval lookup tables from the thermo parameter set.

    q_codes: (ql,) int query melt codes in {0..4} (5'->3')
    tables:  santa_lucia.ThermoParams
    Returns dict of numpy arrays:
      Hstk/Sstk:   (ql, 25) f32 — stack param for alignment position with
                   query base q[qi], prev query base q[qi-1], indexed by
                   tprev*5 + tcur (row 0 unused)
      Hlt/Slt:     (ql, 25) f32 — loop-terminal params, same indexing
    """
    H = np.asarray(tables.param_H, dtype=np.float32).reshape(-1)
    S = np.asarray(tables.param_S, dtype=np.float32).reshape(-1)
    LH = np.asarray(tables.param_loop_terminal_H,
                    dtype=np.float32).reshape(-1)
    LS = np.asarray(tables.param_loop_terminal_S,
                    dtype=np.float32).reshape(-1)
    ql = len(q_codes)
    out = {k: np.zeros((ql, 25), dtype=np.float32)
           for k in ("Hstk", "Sstk", "Hlt", "Slt")}
    for qi in range(1, ql):
        qb = int(q_codes[qi])
        pq = int(q_codes[qi - 1])
        for tp in range(5):
            for tc in range(5):
                last_bp = pq * NUM_BASE + tp
                cur_bp = qb * NUM_BASE + tc
                idx = last_bp * NUM_BP + cur_bp
                out["Hstk"][qi, tp * 5 + tc] = H[idx]
                out["Sstk"][qi, tp * 5 + tc] = S[idx]
                out["Hlt"][qi, tp * 5 + tc] = LH[idx]
                out["Slt"][qi, tp * 5 + tc] = LS[idx]
    return out


# port of tntblast_tpu/ops/eval_gapless_jax.py:42-58 build_slot_eval_arrays:
# loop2m[m] is filled up to LOOP_MAX_MM (the original reads past the loop
# entropy table for an oligo over 256 nt and raises)
def build_slot_eval_arrays(q_codes, tables):
    """Static per-slot arrays for the evaluator (numpy): loop2m[m], the
    entropy of an internal loop of m mismatches on each strand, up to
    LOOP_MAX_MM (0 beyond: eval_flat does not trust such an entry)."""
    tabs = build_slot_eval_tables(np.asarray(q_codes, dtype=np.int64),
                                  tables)
    ql = len(q_codes)
    loop2m = np.zeros(ql + 1, dtype=np.float32)
    ls = np.asarray(tables.param_loop_S, dtype=np.float32)
    assert len(ls) > 2 * LOOP_MAX_MM
    for m in range(2, min(ql, LOOP_MAX_MM) + 1):
        loop2m[m] = ls[2 * m]
    tabs["loop2m"] = loop2m
    tabs["AT_H"] = np.float32(tables.param_AT_closing_H)
    tabs["AT_S"] = np.float32(tables.param_AT_closing_S)
    tabs["init_H"] = np.float32(tables.param_init_H)
    tabs["init_S"] = np.float32(tables.param_init_S)
    tabs["q"] = tuple(int(c) for c in q_codes)
    return tabs


def _wc5(q, t):
    return (q == 4) | (t == 4) | (q + t == 3)


def _first_true(mask):
    """Index of the first True along dim 1; 0 where none (jnp.argmax)."""
    n = mask.shape[1]
    idx = torch.arange(n, device=mask.device)
    first = torch.where(mask, idx, n).amin(dim=1)
    return torch.where(first == n, 0, first)


def _last_true(mask):
    """Index of the last True along dim 1; n-1 where none (the JAX form
    n - 1 - argmax(mask[:, ::-1]))."""
    n = mask.shape[1]
    idx = torch.arange(n, device=mask.device)
    last = torch.where(mask, idx, -1).amax(dim=1)
    return torch.where(last < 0, n - 1, last)


def _take(x, idx):
    """x[b, idx[b, k]] with idx clipped into range (JAX gathers clamp)."""
    return torch.gather(x, 1, idx.clamp(0, x.shape[1] - 1).long())


def eval_flat(M_rows, mg_max, tcodes, q, ql, wt_s, slot, ev_tabs,
              ev_loop2m, eval_const):
    """Trust decision + exact gapless evaluation for a mixed-slot chunk.

    M_rows:  (wq_max, B, wt_max+1) int32 full-DP M rows at the engine
             temperature; rows >= ql[b] and columns > wt_s[b] are junk and
             masked here
    mg_max:  (B,) int32 gapped-best channel max
    tcodes:  (B, wt_max) int32 oriented window codes in {0..5}
    q:       (B, wq_max) int32 per-entry query codes (0 beyond ql)
    ql:      (B,) int32 oligo length;  wt_s: (B,) int32 window width
    slot:    (B,) int64 slot index into the tables (in range)
    ev_tabs: (S, wq_max, 25, 4) f32 stack/loop-term tables per slot
    ev_loop2m: (S, wq_max + 2) f32 loop entropies per slot
    eval_const: (AT_H, AT_S, init_H, init_S) floats

    Returns a dict of (B,) tensors with the fields of the JAX eval_flat.
    """
    wq_max, B, wtp1 = M_rows.shape
    wt_max = wtp1 - 1
    dev = M_rows.device
    i32 = torch.int32
    f32 = torch.float32
    qs = torch.arange(wq_max, dtype=i32, device=dev)[None, :]
    jcol = torch.arange(wtp1, dtype=i32, device=dev)[None, None, :]
    rr = torch.arange(wq_max, dtype=i32, device=dev)[:, None, None]
    qlc = ql[:, None]

    # mask padded rows/columns (column 0 is the -1 boundary, kept)
    M = torch.where((rr < ql[None, :, None]) & (jcol <= wt_s[None, :, None]),
                    M_rows, -1)
    Mb = M.permute(1, 0, 2)                            # (B, wq, wtp1)

    # ---- best cell (first index on ties) + uniqueness --------------------
    flatM = Mb.reshape(B, wq_max * wtp1)
    best = flatM.amax(dim=1)
    at_best = flatM == best[:, None]
    n_best = at_best.sum(dim=1)
    amax = _first_true(at_best).to(i32)
    r_star = amax // wtp1
    j_star = amax % wtp1
    i_star = r_star + 1
    no_align = best < 0
    unique = (n_best == 1) & ~no_align
    no_gap_tie = mg_max < best

    qi0 = ql - i_star
    A = qi0 + (j_star - 1)
    Ac = A[:, None]

    # ---- M values along the path diagonal, in qi-space ------------------
    # DP row r holds qi = ql - 1 - r at column j = A - ql + r + 2
    j_r = Ac - qlc + qs + 2                            # (B, wq)
    ok = (j_r >= 0) & (j_r < wtp1) & (qs < qlc)
    v = torch.gather(Mb, 2, j_r.clamp(0, wt_max).long()[:, :, None])[..., 0]
    Mbyr = torch.where(ok, v, -1)
    Mdiag = _take(Mbyr, qlc - 1 - qs)
    Mdiag = torch.where(qs < qlc, Mdiag, -1)

    walk_hi = torch.minimum(ql - 1, A)
    in_walk = (qs >= qi0[:, None]) & (qs <= walk_hi[:, None])
    neg_here = in_walk & (Mdiag < 0)
    qi_neg = torch.where(neg_here, qs, wq_max).amin(dim=1)
    has_neg = qi_neg < wq_max
    qi1 = torch.where(has_neg, qi_neg, walk_hi)
    row0_stale = (~has_neg) & (A > ql - 1)
    visited = (qs >= qi0[:, None]) & (qs <= qi1[:, None])
    no_zero = torch.where(visited & (Mdiag >= 0), Mdiag != 0,
                          True).all(dim=1)

    trusted = no_align | (unique & no_gap_tie & ~row0_stale & no_zero)

    # ---- window codes along the diagonal: tq[qi] = t[A - qi] ------------
    ti = Ac - qs
    ti_ok = (ti >= 0) & (ti < wt_s[:, None]) & (qs < qlc)
    tq = torch.where(ti_ok, _take(tcodes, ti), 5)    # 5: never WC/comp
    comp = _wc5(q, tq) & ti_ok

    # ---- frayed-end trim ------------------------------------------------
    wcp = comp & visited
    any_wc = wcp.any(dim=1)
    lo = _first_true(wcp).to(i32)
    hi = torch.where(any_wc, _last_true(wcp).to(i32), ql - 1)
    align_len = torch.where(any_wc, hi - lo + 1, 0)

    # ---- evaluation (ordered f32) ----------------------------------------
    tprev = torch.cat([torch.full((B, 1), 5, dtype=i32, device=dev),
                       tq[:, :-1]], dim=1)
    tpair = (tprev.clamp(0, 4) * 5 + tq.clamp(0, 4)).long()

    lo_c = lo[:, None]
    trimmed = (qs >= lo_c) & (qs <= hi[:, None])
    wct = comp & trimmed
    lastwc = torch.cummax(torch.where(wct, qs, -1), dim=1).values

    loop2m = ev_loop2m[slot]                           # (B, wq_max + 2)

    prev_wct = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                          wct[:, :-1]], dim=1)
    in_loop = (~comp) & torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev), ~comp[:, :-1]],
        dim=1)
    is_stack = trimmed & (qs > lo_c) & ~in_loop
    mm_run = torch.where(wct, qs - 1 - torch.roll(lastwc, 1, dims=1), 0)
    mm_run = torch.where(qs > lo_c, mm_run, 0)
    closing = wct & (mm_run >= 2)
    # a loop past the entropy table's: the host evaluates the entry
    trusted = trusted & ~(closing & (mm_run > LOOP_MAX_MM)).any(dim=1)
    first_mm = trimmed & (qs > lo_c) & (~comp) & prev_wct
    f0 = torch.zeros((), dtype=f32, device=dev)
    loopS = torch.zeros((B, wq_max), dtype=f32, device=dev)
    for m in range(wq_max + 1):
        loopS = loopS + torch.where(mm_run == m, loop2m[:, m:m + 1], f0)

    # AT closings at the trimmed terminals (both WC pairs)
    qlo = _take(q, lo[:, None])[:, 0]
    tlo = _take(tq, lo[:, None])[:, 0]
    at5 = ((qlo == 0) & (tlo == 3)) | ((qlo == 3) & (tlo == 0))
    qhi = _take(q, hi[:, None])[:, 0]
    thi = _take(tq, hi[:, None])[:, 0]
    at3 = ((qhi == 0) & (thi == 3)) | ((qhi == 3) & (thi == 0))

    # constants are filled on the device (a host tensor copy would sync)
    AT_H = torch.full((), eval_const[0], dtype=f32, device=dev)
    AT_S = torch.full((), eval_const[1], dtype=f32, device=dev)
    dH = torch.full((B,), eval_const[2], dtype=f32, device=dev)
    dS = torch.full((B,), eval_const[3], dtype=f32, device=dev)
    at5w = at5 & any_wc
    dH = dH + torch.where(at5w, AT_H, f0)
    dS = dS + torch.where(at5w, AT_S, f0)

    z = torch.zeros((B,), dtype=f32, device=dev)
    sv_h, sv_s, sv_lth, sv_lts = z, z, z, z
    for r in range(wq_max):
        vals = ev_tabs[slot, r, tpair[:, r]]           # (B, 4)
        stk_h, stk_s, lt_h, lt_s = vals.unbind(dim=1)
        is_stk = is_stack[:, r]
        is_close = closing[:, r]
        is_first = first_mm[:, r]
        loop_s = loopS[:, r]
        sv_h = torch.where(is_first, stk_h, sv_h)
        sv_s = torch.where(is_first, stk_s, sv_s)
        sv_lth = torch.where(is_first, lt_h, sv_lth)
        sv_lts = torch.where(is_first, lt_s, sv_lts)
        dH = dH + torch.where(is_stk, stk_h, f0)
        dS = dS + torch.where(is_stk, stk_s, f0)
        dS = dS + torch.where(is_close, loop_s, f0)
        dH = dH - torch.where(is_close, stk_h, f0)
        dS = dS - torch.where(is_close, stk_s, f0)
        dH = dH + torch.where(is_close, lt_h, f0)
        dS = dS + torch.where(is_close, lt_s, f0)
        dH = dH - torch.where(is_close, sv_h, f0)
        dS = dS - torch.where(is_close, sv_s, f0)
        dH = dH + torch.where(is_close, sv_lth, f0)
        dS = dS + torch.where(is_close, sv_lts, f0)
    at3w = at3 & any_wc
    dH = dH + torch.where(at3w, AT_H, f0)
    dS = dS + torch.where(at3w, AT_S, f0)

    num_base = (2 + 2 * is_stack.sum(dim=1)
                + 2 * closing.sum(dim=1)).to(i32)
    mm = (trimmed & ~comp).sum(dim=1).to(i32)

    fm_q = lo
    fm_t = A - lo
    lm_q = hi
    lm_t = A - hi

    # ---- anchors (reference nuc_cruc_anchor.cpp:143-345) ----------------
    anchor5 = torch.cumprod(comp.to(i32), dim=1).sum(dim=1).to(i32)
    t5_ok = (A >= 0) & (A < wt_s)
    anchor5 = torch.where(t5_ok, anchor5, 0)
    comp_rev = _take(comp, qlc - 1 - qs) & (qs < qlc)
    anchor3 = torch.cumprod(comp_rev.to(i32), dim=1).sum(dim=1).to(i32)
    t3_start = (lm_q + lm_t + 1) - ql
    t3_ok = (t3_start >= 0) & (t3_start < wt_s)
    anchor3 = torch.where(t3_ok, anchor3, 0)

    usable = (align_len >= 3) & (dH < 0)
    return {
        "trusted": trusted,
        "tm_zero": no_align | (trusted & ~usable),
        "dH": dH, "dS": dS, "num_base": num_base,
        "mm": mm, "align_len": align_len,
        "fm_q": fm_q, "fm_t": fm_t, "lm_q": lm_q, "lm_t": lm_t,
        "anchor5": anchor5, "anchor3": anchor3,
    }
