# Copy of tntblast_tpu/screen_bound.py with the package name changed.
"""Constructive screening-slack bound (docs/screen_bound.md).

The screen drops a window when its DP score over the SCREENING table
(update_dp_param_screen: every fitted, zero-clamped event charge —
gap-adjacent terminal entries, interior LOOP pairs, BULGE extensions —
replaced by 0) fails `min_score - slack`.  Soundness needs, for the
alignment A* the engine reports:

    screen_path(A*, T) - exact(A*, T) <= slack        for all A*, T.

With zeroed event charges the screening DP can CROSS every interior
event at a cost no greater than the exact evaluator's penalty for it —
usually by re-routing through zero-charged gap pairs; the event's
literal path may overcharge (a lone T.T mismatch pays genuine mismatch
stacks while the exact evaluator prices the 1x1 loop lower), so the
premise quantifies over the DP's cheapest ROUTE, and _compute_bound
asserts it numerically for every repeatable family (route cost from an
actual DP over the screening table, differenced against the event-free
baseline).  What remains are per-alignment O(1) LOCAL terms: AT
closings, init terms, terminal/frayed effects, salt-count constants.
Those are enumerated here NUMERICALLY, per family, from the actual
tables: a small alignment is built for every family instance, the exact
side comes from the native evaluator (the code under test), the
screening-path side from an exact walker over the int screening table,
and the slack is the max improvement observed over the full enumeration
plus a truncation margin.

This replaces the corpus-fitted constants 4.0/7.0, which were UNSOUND:
a mismatch cluster routed through gap pairs overcharges the ORIGINAL
table linearly in cluster size (measured improvement 5.16 kcal/mol at
size 6; unbounded in window length) — the screening-table fix removes
the event charges instead of bounding them.
"""


import numpy as np

NUM_BASE = 7
NUM_BP = 49
GAP = 6
E = 5

WC_PAIRS = [(0, 3), (3, 0), (1, 2), (2, 1)]
I_PAIRS = [(4, b) for b in range(5)] + [(b, 4) for b in range(4)]
MM_PAIRS = [(a, b) for a in range(4) for b in range(4) if a + b != 3]


def screen_path_dg(q_row, t_row, dg_int):
    """An upper bound on the screening-DP free energy reachable for this
    alignment: the charges align_dimer would apply along the path
    (melt_engine.cpp:371-452), SKIPPING the first pair's charge — the DP
    maximum always dominates the sub-path that starts at the alignment's
    second pair, whose first charge is exactly the (pair1 -> pair2)
    stack, i.e. this sum.  So screen_dp_dg <= screen_path_dg(A) for
    every alignment A of the window, independent of what precedes A.
    q_row/t_row may contain GAP codes."""
    dg = np.asarray(dg_int, dtype=np.int64).reshape(-1)

    def bp(a, b):
        return int(a) * NUM_BASE + int(b)

    n = len(q_row)
    score = 0
    prev_q = None     # None = first consumed position (charge skipped)
    prev_t = GAP
    for i in range(n):
        qc, tc = int(q_row[i]), int(t_row[i])
        if prev_q is None and (qc != GAP and tc != GAP):
            prev_q, prev_t = qc, tc        # first pair: no charge
            continue
        if qc == GAP:                      # Iq: consumes target
            # entry/extension collapse: the pushed charge is the one the
            # DP applied when entering this cell; next query base:
            nq = GAP
            for k in range(i + 1, n):
                if int(q_row[k]) != GAP:
                    nq = int(q_row[k])
                    break
            cur = bp(tc, GAP)
            first_of_run = i == 0 or int(q_row[i - 1]) != GAP
            pb = bp(prev_t, nq) if first_of_run else bp(prev_t, GAP)
            score -= dg[pb * NUM_BP + cur]
            prev_t = tc
        elif tc == GAP:                    # It: consumes query
            nt = GAP
            for k in range(i + 1, n):
                if int(t_row[k]) != GAP:
                    nt = int(t_row[k])
                    break
            cur = bp(GAP, qc)
            first_of_run = i == 0 or int(t_row[i - 1]) != GAP
            pb = bp(nt, prev_q) if first_of_run else bp(GAP, prev_q)
            score -= dg[pb * NUM_BP + cur]
            prev_q = qc
        else:                              # M: consumes both
            cur = bp(tc, qc)
            pb = bp(prev_t, prev_q)
            score -= dg[pb * NUM_BP + cur]
            prev_q, prev_t = qc, tc
    return -score / 10000.0


def _family_alignments(dangle):
    """Small alignments covering every local event family, each tagged
    `repeatable`: True for INTERIOR events that can occur multiple times
    in one alignment (mismatch clusters, bulges, mixed loops, wobble
    specials), False for per-alignment-bounded terms (terminals,
    dangling/frayed attachments).  Flanking context is exhaustive where
    the family formula depends on it.

    The soundness theorem (docs/screen_bound.md step 3) composes
    per-event improvements additively; slack = the worst SINGLE term is
    only a bound if every repeatable event's own improvement is <= 0 —
    `_compute_bound` asserts exactly that, differentially against the
    event-free baseline (the alignment's WC columns)."""
    out = []

    def A(qs, ts, repeatable):
        out.append((np.array(qs, np.uint8), np.array(ts, np.uint8),
                    repeatable))

    # pure duplexes incl. AT terminals (AT-closing + terminal charges)
    for L in WC_PAIRS + I_PAIRS:
        for R in WC_PAIRS + I_PAIRS:
            A([L[0], 2, 1, R[0]], [L[1], 1, 2, R[1]], False)
    # gapless mismatch clusters m = 1..12, all flanking mm pairs
    for m in (1, 2, 3, 4, 8, 12):
        for M1 in MM_PAIRS:
            for Mm in MM_PAIRS:
                mid = [(0, 0)] * max(0, m - 2)
                mms = [M1] + mid + ([Mm] if m > 1 else [])
                qs = [2, 1] + [p[0] for p in mms] + [2, 1]
                ts = [1, 2] + [p[1] for p in mms] + [1, 2]
                A(qs, ts, True)
    # bulges k = 1..6 on each strand, all WC flanks, bulge base choices
    for k in (1, 2, 3, 6):
        for L in WC_PAIRS:
            for R in WC_PAIRS:
                for B in range(4):
                    gq = [GAP] * k
                    gb = [B] * k
                    A([2, L[0]] + gq + [R[0], 1],
                      [1, L[1]] + gb + [R[1], 2], True)
                    A([2, L[0]] + gb + [R[0], 1],
                      [1, L[1]] + gq + [R[1], 2], True)
    # asymmetric / mixed loops: mm x gaps in several arrangements
    for mm in (1, 2, 3):
        for g in (1, 2, 3):
            for M1 in ((0, 0), (2, 2), (3, 2)):
                mpart_q = [M1[0]] * mm
                mpart_t = [M1[1]] * mm
                A([2, 1] + mpart_q + [GAP] * g + [2, 1],
                  [1, 2] + mpart_t + [0] * g + [1, 2], True)
                A([2, 1] + [GAP] * g + mpart_q + [2, 1],
                  [1, 2] + [0] * g + mpart_t + [1, 2], True)
                A([2, 1] + mpart_q + [0] * g + [2, 1],
                  [1, 2] + mpart_t + [GAP] * g + [1, 2], True)
                # gaps on both strands (gap_difference = 0 loop)
                A([2, 1] + mpart_q + [GAP] * g + [0] * g + [2, 1],
                  [1, 2] + mpart_t + [0] * g + [GAP] * g + [1, 2], True)
    # GT/TG double-wobble special (loop_size == 2 via equal gaps)
    for w1 in ((2, 3), (3, 2)):
        for w2 in ((2, 3), (3, 2)):
            A([2, w1[0], GAP, 0, w2[0], 1],
              [1, w1[1], 0, GAP, w2[1], 2], True)
    # multi-event alignments (two bulges / bulge + mismatch cluster):
    # direct probes of the additive-composition premise
    for k1 in (1, 2):
        for k2 in (1, 3):
            for B in (0, 2):
                A([2, 1] + [GAP] * k1 + [2, 1] + [GAP] * k2 + [2, 1],
                  [1, 2] + [B] * k1 + [1, 2] + [B] * k2 + [1, 2], True)
                A([2, 1] + [B] * k1 + [2, 1] + [GAP] * k2 + [2, 1],
                  [1, 2] + [GAP] * k1 + [1, 2] + [B] * k2 + [1, 2], True)
    for m in (1, 3):
        for k in (1, 2):
            A([2, 1] + [0] * m + [2, 1] + [GAP] * k + [2, 1],
              [1, 2] + [0] * m + [1, 2] + [1] * k + [1, 2], True)
    if dangle:
        # dangling-end / frayed-end attachments: E-paired terminals
        for D in range(4):
            for L in WC_PAIRS:
                A([E, L[0], 2, 1], [D, L[1], 1, 2], False)
                A([D, L[0], 2, 1], [E, L[1], 1, 2], False)
                A([2, 1, L[0], E], [1, 2, L[1], D], False)
                A([2, 1, L[0], D], [1, 2, L[1], E], False)
                # frayed: mismatch terminal followed by the attach pair
                for M1 in MM_PAIRS[:6]:
                    A([M1[0], L[0], 2, 1], [M1[1], L[1], 1, 2], False)
    return out


def _wc_baseline(q, t):
    """The alignment with its non-WC columns removed: the event-free
    context sharing the same terminals (inosine counts as pairing)."""
    keep = [i for i in range(len(q))
            if q[i] < 5 and t[i] < 5
            and (q[i] == 4 or t[i] == 4 or int(q[i]) + int(t[i]) == 3)]
    return q[keep], t[keep]


# REPEAT_MARGIN: allowance on the repeatable-event non-positivity assert
# (int table truncation <= 1e-4/charge, f32 eval rounding).
REPEAT_MARGIN = 0.02

# GC anchors flanking the premise-check windows: long enough that the
# screening DP's best route CROSSES the event instead of aligning one
# anchor alone (events whose exact cost exceeds the anchor strength are
# then measured as a skip, which only weakens the asserted quantity —
# conservative in the safe direction, see _compute_bound).
_ANCH_Q = [2, 1] * 3
_ANCH_T = [1, 2] * 3


def _screen_dp_batch(qs, ts, dg):
    """Max DP score per (query, window) over the screening table — a
    numpy mirror of ops.thermo_dp.dp_max_score (the production kernel),
    kept JAX-free so slack_bound never touches a device backend.
    qs: list of query code arrays (5'->3'), ts: list of window code
    arrays (plus orientation).  Semantics checked against dp_max_score in
    tests/test_screen_bound.py."""
    B = len(qs)
    wq = max(len(q) for q in qs)
    wt = max(len(t) for t in ts)
    Q = np.zeros((B, wq), np.int64)
    Tw = np.zeros((B, wt), np.int64)
    ql = np.array([len(q) for q in qs], np.int64)
    tl = np.array([len(t) for t in ts], np.int64)
    for i, (q, t) in enumerate(zip(qs, ts)):
        Q[i, :len(q)] = q
        Tw[i, :len(t)] = t
    idx = (ql[:, None] - 1 - np.arange(wq)[None, :]) % wq
    qr = np.take_along_axis(Q, idx, axis=1)     # reversed query per row

    dgf = np.asarray(dg, np.int64).reshape(-1)

    def g(pa, pb, ca, cb):
        return dgf[(pa * NUM_BASE + pb) * NUM_BP + ca * NUM_BASE + cb]

    gapv = np.full(B, GAP, np.int64)
    M = np.full((B, wt + 1), -1, np.int64)
    Iq = np.full((B, wt + 1), -1, np.int64)
    It = np.full((B, wt + 1), -1, np.int64)
    best = np.full(B, -1, np.int64)
    for r in range(wq):
        qb = qr[:, r]
        pq = qr[:, r - 1] if r > 0 else gapv
        newM = np.full((B, wt + 1), -1, np.int64)
        newIq = np.full((B, wt + 1), -1, np.int64)
        newIt = np.full((B, wt + 1), -1, np.int64)
        m_left = np.full(B, -1, np.int64)        # M[r, c-1]
        for c in range(wt):
            tb = Tw[:, c]
            pt = Tw[:, c - 1] if c > 0 else gapv
            m = np.maximum(
                np.maximum(np.maximum(M[:, c], 0) - g(pt, pq, tb, qb),
                           np.maximum(Iq[:, c], 0) - g(pt, gapv, tb, qb)),
                np.maximum(It[:, c], 0) - g(gapv, pq, tb, qb))
            it = np.maximum(
                np.maximum(M[:, c + 1], 0) - g(tb, pq, gapv, qb),
                np.maximum(It[:, c + 1], 0) - g(gapv, pq, gapv, qb))
            dgqe = g(pt, gapv, tb, gapv)
            a = np.maximum(
                np.maximum(m_left, 0) - g(pt, qb, tb, gapv), -dgqe)
            iq = np.maximum(a, newIq[:, c] - dgqe)
            valid = (c < tl) & (r < ql)
            best = np.maximum(best, np.where(valid, m, -1))
            newM[:, c + 1] = m
            newIq[:, c + 1] = iq
            newIt[:, c + 1] = it
            m_left = m
        M, Iq, It = newM, newIq, newIt
    return best


def _compute_bound(engine, T, dangle):
    dg = engine.delta_g_screen(np.float32(T)).astype(np.int64).reshape(-1)
    aligns = _family_alignments(dangle)
    # premise-check variants: every repeatable event and its event-free
    # baseline, wrapped in GC anchors so the screening DP's best route
    # crosses the event
    rep_idx = [k for k, (_, _, rep) in enumerate(aligns) if rep]

    def aug(q, t):
        return (np.concatenate([_ANCH_Q, q, _ANCH_Q]).astype(np.uint8),
                np.concatenate([_ANCH_T, t, _ANCH_T]).astype(np.uint8))

    aug_ev = [aug(aligns[k][0], aligns[k][1]) for k in rep_idx]
    aug_ba = [aug(*_wc_baseline(aligns[k][0], aligns[k][1]))
              for k in rep_idx]
    qs = [q for q, _, _ in aligns] + [q for q, _ in aug_ev] \
        + [q for q, _ in aug_ba]
    ts = [t for _, t, _ in aligns] + [t for _, t in aug_ev] \
        + [t for _, t in aug_ba]
    tm, dH, dS, ok = engine.eval_alignments(
        qs, ts, np.full(len(qs), 9e-7, dtype=np.float32))
    nA = len(aligns)
    nR = len(rep_idx)

    def window(q, t):
        qd = q[q != GAP].astype(np.int64)
        td = t[t != GAP][::-1].astype(np.int64)
        return qd, td

    dp_q, dp_t = [], []
    for q, t in aug_ev + aug_ba:
        qd, td = window(q, t)
        dp_q.append(qd)
        dp_t.append(td)
    dp_best = (_screen_dp_batch(dp_q, dp_t, dg) if dp_q
               else np.zeros(0, np.int64))

    def wc_core(q, t):
        """The DP path underlying a reported alignment is its WC-trimmed
        core (frayed ends are trimmed before evaluation, dangling ends
        attached after; neither is charged by the path the screen DP can
        realize)."""
        def wc(a, b):
            return (a == 4) | (b == 4) | (a + b == 3)
        lo, hi = 0, len(q) - 1
        while hi >= lo and not (q[lo] < 5 and t[lo] < 5
                                and wc(int(q[lo]), int(t[lo]))):
            lo += 1
        while hi >= lo and not (q[hi] < 5 and t[hi] < 5
                                and wc(int(q[hi]), int(t[hi]))):
            hi -= 1
        return q[lo:hi + 1], t[lo:hi + 1]

    def improvement(k, q, t):
        qc, tc = wc_core(q, t)
        if len(qc) == 0:
            return None
        path = screen_path_dg(qc, tc, dg)
        exact = float(dH[k]) - T * float(dS[k])
        return path - exact

    worst = 0.0
    for k, (q, t, rep) in enumerate(aligns):
        if not ok[k]:
            # evaluate_alignment rejected (dH >= 0): the engine reports
            # tm = 0 for such alignments — they can never be a hit under
            # a min_tm > 0 / max_dg < 0 criterion, so the invariant is
            # vacuous for them
            continue
        imp = improvement(k, q, t)
        if imp is None:
            continue
        worst = max(worst, imp)

    # Composition premise (docs/screen_bound.md step 3): the screening
    # DP's CHEAPEST ROUTE through a repeatable interior event must not
    # exceed the event's exact penalty, or per-event overcharges would
    # compose additively past the single-event slack.  Both sides are
    # measured differentially against the event-free WC baseline with
    # identical anchors; the route cost comes from the actual DP (the
    # LITERAL path of the event can overcharge by several kcal/mol —
    # e.g. a lone T.T mismatch pays genuine mismatch stacks while the
    # exact evaluator prices the 1x1 loop lower — soundness rides on the
    # DP's freedom to re-route, typically through zero-charged gap
    # pairs).  Fail loudly: a violation means the screening table
    # changed in a way the slack theorem does not cover.
    for j, k in enumerate(rep_idx):
        ke = nA + j
        kb = nA + nR + j
        if not (ok[ke] and ok[kb]):
            continue
        dp_diff = -(float(dp_best[j]) - float(dp_best[nR + j])) / 10000.0
        exact_diff = (float(dH[ke]) - T * float(dS[ke])) \
            - (float(dH[kb]) - T * float(dS[kb]))
        if dp_diff - exact_diff > REPEAT_MARGIN:
            q, t, _ = aligns[k]
            raise AssertionError(
                "screen_bound: repeatable interior event's cheapest "
                f"screening route overcharges exact by "
                f"{dp_diff - exact_diff:.4f} kcal/mol at T={T} "
                f"(q={list(map(int, q))}, t={list(map(int, t))}); "
                "the additive-composition premise is violated")
    # margins: int truncation (<= 1e-4 per charge, <= 64 charges), f32
    # eval rounding, enumeration granularity
    return worst + 0.05


_BOUND_CACHE = {}


def _persist_path():
    import os
    d = os.environ.get(
        "TNTBLAST_SLACK_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "tntblast_tpu_torch"))
    if d == "0":
        return None
    return os.path.join(d, "slack_bounds.json")


def _load_persisted():
    import json
    import os
    path = _persist_path()
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as fh:
            raw = json.load(fh)
        return {tuple(k.split("|")): float(v) for k, v in raw.items()}
    except Exception:   # noqa: BLE001 — a corrupt cache is recomputed
        return {}


def _save_persisted(cache):
    import json
    import os
    path = _persist_path()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump({"|".join(map(str, k)): v for k, v in cache.items()},
                      fh)
        os.replace(tmp, path)
    except Exception:   # noqa: BLE001 — persistence is best-effort
        pass


def slack_bound(engine, T, dangle=False):
    """Provable screening slack at temperature T (kcal/mol): the maximum
    over all enumerated event families of screen_path - exact, plus a
    truncation margin.  Events compose additively (each family term is
    the event's complete local contribution), every repeatable interior
    event's cheapest screening route is asserted no costlier than its
    exact penalty in _compute_bound — so the per-alignment improvement
    is bounded by the worst single-event terms captured here (see
    docs/screen_bound.md for the argument).

    Cached by the CONTENT of the engine's screening table (never by
    engine identity — holding engines in a module dict would leak the
    native engine for the life of the process), and persisted across
    processes: the enumeration + premise assert cost ~0.4 s per
    temperature, paid once per parameter-table content ever.  Any table
    change changes the key and re-runs the premise verification."""
    ck = getattr(engine, "_screen_bound_key", None)
    if ck is None:
        import hashlib
        tab = engine.delta_g_screen(np.float32(310.15)).astype(np.int64)
        ck = hashlib.sha1(tab.tobytes()).hexdigest()
        try:
            engine._screen_bound_key = ck
        except AttributeError:
            pass
    key = (ck, str(round(float(T), 4)), str(bool(dangle)))
    got = _BOUND_CACHE.get(key)
    if got is not None:
        return got
    if not _BOUND_CACHE:
        _BOUND_CACHE.update(_load_persisted())
        got = _BOUND_CACHE.get(key)
        if got is not None:
            return got
    got = _BOUND_CACHE[key] = _compute_bound(engine, T, dangle)
    _save_persisted(_BOUND_CACHE)
    return got
