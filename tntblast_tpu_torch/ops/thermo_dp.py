"""Thermodynamic alignment DP: the batched per-window DP over the whole
degenerate alphabet, the canonical-pair tables, and the single-condition
screen.

Port of tntblast_tpu/ops/thermo_dp.py.  `dp_max_score` replicates the
reference NucCruc dynamic program exactly (reference nuc_cruc.cpp:492-696
`align_dimer`): a 3-state (M / I_query / I_target) local alignment over
nearest-neighbor pair-of-pairs stacking energies with fixed-point int32
scores (-dG * 10000), query reversed so rows run 5'query vs 3'target.  The
column-wise gap state recurrence

    Iq[j] = max(A[j], max(Iq[j-1], 0) - E[j])

with A'[j] = max(A[j], -E[j]) unrolls to

    Iq[j] = cummax(A' + cumsum(E))[j] - cumsum(E)[j]

so a DP row is vector operations over the (B, wt) batch.  It is plain
PyTorch tensor code on the device of its inputs (the JAX original is a
jitted XLA function, not a kernel).

The numpy table functions are copies of the original's (that module imports
jax at its top).  The canonical table

    T_canon[(pt6*5+tb), (pq6*5+qb), e]   (30, 30, 7) int32

holds the seven DP energies of a cell for every (previous, current) target
pair and query pair, built from the 49x49 delta_g of one temperature; the
qpair rows give each DP row's query pair (query reversed).
"""

import functools

import numpy as np
import torch

from tntblast_tpu_torch.ops.screen_dp import screen_dp

NUM_BASE = 7     # A,C,G,T,I + virtual E,GAP (reference nuc_cruc.h:37-39)
NUM_BP = 49
NUM_ALPHA = 18
GAP = 6

_A, _C, _G, _T, _I = 0, 1, 2, 3, 4
_M, _R, _S, _V, _W = 7, 8, 9, 10, 11
_Y, _H, _K, _D, _B, _N = 12, 13, 14, 15, 16, 17
NUM_T5 = 5       # target-domain letters on the device path: A,C,G,T,I
NUM_PREV = 6     # prev-target letters: A,C,G,T,I + GAP (column 0)
QP_GAP = 5       # 6th letter of the prev-base domain (GAP at row/col 0)


# copy of tntblast_tpu/ops/thermo_dp.py:44-78 (_resolve_one, best_pair_table)
def _resolve_one(base, q):
    """Optimistic degenerate-base resolution (reference nuc_cruc.cpp:14-201
    `resolve_degenerate`, including the B->N fall-through quirk)."""
    if base == _M:
        return _A if q == _T else (_C if q == _G else _A)
    if base == _R:
        return _A if q == _T else (_G if q == _C else _A)
    if base == _S:
        return _C if q == _G else (_G if q == _C else _G)
    if base == _V:
        return _C if q == _G else (_G if q == _C else (_A if q == _T else _A))
    if base == _W:
        return _T if q == _A else (_A if q == _T else _A)
    if base == _Y:
        return _C if q == _G else (_T if q == _A else _T)
    if base == _H:
        return _A if q == _T else (_C if q == _G else (_T if q == _A else _A))
    if base == _K:
        return _G if q == _C else (_T if q == _A else _T)
    if base == _D:
        return _G if q == _C else (_A if q == _T else (_T if q == _A else _A))
    if base in (_B, _N):
        return {_A: _T, _T: _A, _G: _C, _C: _G}.get(q, _A)
    return base


@functools.lru_cache(maxsize=1)
def best_pair_table():
    """BEST_PAIR[a][b] = resolve(a,b)*7 + resolve(b,a) (reference
    nuc_cruc.cpp:203-213 `best_base_pair`)."""
    bp = np.zeros((NUM_ALPHA, NUM_ALPHA), dtype=np.int32)
    for a in range(NUM_ALPHA):
        for b in range(NUM_ALPHA):
            bp[a, b] = _resolve_one(a, b) * NUM_BASE + _resolve_one(b, a)
    return bp


@functools.lru_cache(maxsize=None)
def _best_pair_on(device):
    """best_pair_table() flattened, on `device` (one upload per device)."""
    return torch.from_numpy(best_pair_table()).to(device).reshape(-1)


def _relu(x):
    return torch.clamp_min(x, 0)


def dp_max_score(q_codes, q_len, t_codes, t_len, delta_g, *, wq, wt):
    """Max M-state DP score for a batch of windows.

    q_codes: (B, wq) int32 melt codes, padded arbitrarily past q_len
    q_len:   (B,) int32 true oligo lengths
    t_codes: (B, wt) int32, padded past t_len
    t_len:   (B,) int32
    delta_g: (49*49,) int32 score table at the screen temperature
    All tensors on one device (any).  Returns (B,) int32 max scores (==
    reference NucCruc max_score; -1 when no cell scores >= 0, the
    reference's initial max).

    Codes are melt codes of the 18-letter alphabet, 0..17, padding
    included: a value outside is clamped into that range before the pair
    table is read (the JAX gather clamps too; a torch gather would raise).

    Where every code of a call lies in {A, C, G, T, I} (0..4) the same
    score comes from `dp_scores_canon`, one launch of the screen_dp kernel
    on a card.  TpuScreen.screen_windows calls that for such a batch,
    because this function runs some twenty small tensor operations per DP
    row and the kernel one launch per call; it calls this function for a
    batch with a degenerate code, which the canonical table cannot express,
    and for an oligo wider than the kernel takes.
    """
    dev = q_codes.device
    i32 = torch.int32
    bp = _best_pair_on(dev)
    dg = delta_g.reshape(-1)
    B = q_codes.shape[0]

    q_codes = q_codes.clamp(0, NUM_ALPHA - 1)
    t_codes = t_codes.clamp(0, NUM_ALPHA - 1)
    # Row-indexed (reversed query) base array: the reversal starts at the
    # true oligo end (q_len-1), not the padded end, so roll per row (the
    # modulo keeps padded rows in range; they are masked below)
    idx = (q_len[:, None] - 1 - torch.arange(wq, device=dev)[None, :]) % wq
    q_rev = torch.gather(q_codes, 1, idx.long())

    gap_col = torch.full((B, 1), GAP, dtype=i32, device=dev)
    qb = q_rev                                   # (B, wq) base at row r
    pq = torch.cat([gap_col, q_rev[:, :-1]], dim=1)
    tb = t_codes                                 # (B, wt) base at col c
    pt = torch.cat([gap_col, t_codes[:, :-1]], dim=1)

    def pair(a, b):
        return bp[(a * NUM_ALPHA + b).long()]

    cur = pair(tb[:, None, :], qb[:, :, None])           # (B, wq, wt)
    bp_pt_pq = pair(pt[:, None, :], pq[:, :, None])
    bp_pt_gap = pair(pt, GAP)[:, None, :]                # (B, 1, wt)
    bp_gap_pq = pair(torch.full_like(pq, GAP), pq)[:, :, None]   # (B, wq, 1)
    gq = pair(tb, GAP)[:, None, :]                       # cur pair for Iq
    gt = pair(torch.full_like(qb, GAP), qb)[:, :, None]  # cur pair for It
    bp_pt_qb = pair(pt[:, None, :], qb[:, :, None])
    bp_tb_pq = pair(tb[:, None, :], pq[:, :, None])

    def g(prev_bp, cur_bp):
        return dg[(prev_bp * NUM_BP + cur_bp).long()]    # broadcasts

    DGmm = g(bp_pt_pq, cur)
    DGmq = g(bp_pt_gap, cur)
    DGmt = g(bp_gap_pq, cur)
    DGqi = g(bp_pt_qb, gq)
    DGqe = g(bp_pt_gap, gq).expand(B, wq, wt)
    DGti = g(bp_tb_pq, gt)
    DGte = g(bp_gap_pq, gt).expand(B, wq, wt)

    col_valid = torch.arange(wt, device=dev)[None, :] < t_len[:, None]
    row_valid = torch.arange(wq, device=dev)[None, :] < q_len[:, None]

    neg_col = torch.full((B, 1), -1, dtype=i32, device=dev)
    prevM = torch.full((B, wt + 1), -1, dtype=i32, device=dev)
    prevIq = prevM
    prevIt = prevM
    best = torch.full((B,), -1, dtype=i32, device=dev)
    for r in range(wq):
        dgqe = DGqe[:, r]
        m = torch.maximum(
            torch.maximum(_relu(prevM[:, :-1]) - DGmm[:, r],
                          _relu(prevIq[:, :-1]) - DGmq[:, r]),
            _relu(prevIt[:, :-1]) - DGmt[:, r])             # (B, wt)
        it = torch.maximum(_relu(prevM[:, 1:]) - DGti[:, r],
                           _relu(prevIt[:, 1:]) - DGte[:, r])
        m_shift = torch.cat([neg_col, m[:, :-1]], dim=1)
        a = torch.maximum(_relu(m_shift) - DGqi[:, r], -dgqe)
        # int32 throughout: torch.cumsum of int32 gives int64 unless told
        s = torch.cumsum(dgqe, dim=1, dtype=i32)
        iq = torch.cummax(a + s, dim=1).values - s
        ok = col_valid & row_valid[:, r:r + 1]
        best = torch.maximum(best, torch.where(ok, m, -1).amax(dim=1))
        prevM = torch.cat([neg_col, m], dim=1)
        prevIq = torch.cat([neg_col, iq], dim=1)
        prevIt = torch.cat([neg_col, it], dim=1)
    return best


def dp_delta_g(q_codes, q_len, t_codes, t_len, delta_g, *, wq, wt):
    """DP best free energy in kcal/mol (== -max_score/10000; the reference
    dp dG used by tm_dimer before exact re-scoring), float32."""
    score = dp_max_score(q_codes, q_len, t_codes, t_len, delta_g,
                         wq=wq, wt=wt)
    return -score.to(torch.float32) / 10000.0


# copy of tntblast_tpu/ops/thermo_dp.py:224 build_qpair_rows
def build_qpair_rows(slot_codes, slot_qlen, *, wq):
    """(S, wq) int32: qpair index pq6*5+qb per DP row (reversed query).
    Rows past slot_qlen hold 0 (masked by row_valid in the DP)."""
    S = len(slot_codes)
    out = np.zeros((S, wq), dtype=np.int32)
    for s in range(S):
        n = int(slot_qlen[s])
        rev = np.asarray(slot_codes[s][:n][::-1], dtype=np.int64)
        for r in range(n):
            qb = int(rev[r])
            pq6 = int(rev[r - 1]) if r > 0 else QP_GAP
            out[s, r] = pq6 * NUM_T5 + qb
    return out


# copy of tntblast_tpu/ops/thermo_dp.py:239-275 (_t_canon_cached,
# _build_t_canon, build_t_canon)
@functools.lru_cache(maxsize=None)
def _t_canon_cached(dg_key):
    dg = np.frombuffer(dg_key, dtype=np.int32)
    return _build_t_canon(dg)


def _build_t_canon(dg):
    """(30, 30, 7) int32 canonical energy table from a flat (2401,) dg."""
    dg = np.asarray(dg).reshape(-1)
    base6 = np.array([0, 1, 2, 3, 4, GAP])      # domain letter -> melt code

    def bp(a, b):
        return a * NUM_BASE + b

    T = np.zeros((NUM_PREV * NUM_T5, NUM_PREV * NUM_T5, 7), dtype=np.int32)
    for pt6 in range(NUM_PREV):
        pt = base6[pt6]
        for tb in range(NUM_T5):
            i = pt6 * NUM_T5 + tb
            for pq6 in range(NUM_PREV):
                pq = base6[pq6]
                for qb in range(NUM_T5):
                    j = pq6 * NUM_T5 + qb
                    cur = bp(tb, qb)
                    T[i, j, 0] = dg[bp(pt, pq) * NUM_BP + cur]
                    T[i, j, 1] = dg[bp(pt, GAP) * NUM_BP + cur]
                    T[i, j, 2] = dg[bp(GAP, pq) * NUM_BP + cur]
                    T[i, j, 3] = dg[bp(pt, qb) * NUM_BP + bp(tb, GAP)]
                    T[i, j, 4] = dg[bp(pt, GAP) * NUM_BP + bp(tb, GAP)]
                    T[i, j, 5] = dg[bp(tb, pq) * NUM_BP + bp(GAP, qb)]
                    T[i, j, 6] = dg[bp(GAP, pq) * NUM_BP + bp(GAP, qb)]
    return T


def build_t_canon(dg):
    return _t_canon_cached(np.ascontiguousarray(
        np.asarray(dg, dtype=np.int32)).tobytes())


def target_pairs(t_codes):
    """(B, wt) int32 target-pair index pt6*5+tb5 of window codes (codes
    clipped to {A,C,G,T,I}; column 0's previous base is GAP)."""
    tb5 = t_codes.clamp(0, NUM_T5 - 1)
    pt6 = torch.cat([torch.full_like(tb5[:, :1], QP_GAP), tb5[:, :-1]],
                    dim=1)
    return pt6 * NUM_T5 + tb5


def dp_scores_canon(qp_rows, q_len, t_codes, t_len, t_canon):
    """Exact int32 max M-state DP score per window (== the reference
    align_dimer max_score), the single-condition case of the screen DP.

    qp_rows: (B, wq) int32 qpair per row (build_qpair_rows[os_idx])
    q_len:   (B,) int32
    t_codes: (B, wt) int32 melt codes in {0..4}
    t_len:   (B,) int32
    t_canon: (30, 30, 7) int32
    All on one device; returns (B,) int32.
    """
    B = t_codes.shape[0]
    slot = torch.arange(B, dtype=torch.int32, device=t_codes.device)
    best, _, _ = screen_dp(
        target_pairs(t_codes).contiguous(), slot, q_len.contiguous(),
        t_len.contiguous(), qp_rows.contiguous(),
        t_canon[None].contiguous(), eval_on=False)
    return best[0]
