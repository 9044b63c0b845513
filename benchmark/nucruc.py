"""Plain nearest-neighbour thermodynamics of an oligo bound to a target
window, as thermonucleotideBLAST's NucCruc defines them: written anew in
Python and NumPy from the published parameters, for the benchmark's
reference (benchmark/reference.py).  It imports nothing of the program.

  - Parameters: SantaLucia & Hicks, Annu. Rev. Biophys. Biomol. Struct.
    33:415-440 (2004), Table 1 (Watson-Crick stacks) and the dangling-end
    values it collects; the single-mismatch stacks of Allawi & SantaLucia
    (Biochemistry 36:10581, 37:2170, 37:9435; NAR 26:2694) and Peyret et
    al. (Biochemistry 38:3468); loop and bulge length entropies (Table 4,
    interpolated, Jacobson-Stockmayer past 30); the supplementary loop,
    bulge and terminal values that NucCruc ships (a refit of the TM
    program's).  Bases A, C, G, T only: the benchmark's data hold no
    inosine and no degenerate base, and `Melt` refuses them.
  - The alignment: NucCruc's local three-state dynamic program over
    pair-of-pairs free energies at the search's temperature, in fixed
    point (-dG x 10000, truncated), the query reversed so that rows run
    from the oligo's 3' end; every co-optimal path from every best cell
    is traced (at most 17 traces a cell, paths cut at each cell of score
    0 in turn), its frayed ends trimmed, and scored exactly; the least
    dG at the search's temperature wins.
  - The score of an alignment: the nearest-neighbour sums with internal
    loops, bulges, terminal mismatches and the salt correction, in
    float32, and Tm = dH / (dS + R ln C) - 273.15.

One quirk of NucCruc is kept as a set of outcomes instead of one: a path
that reaches the oligo's 3' end reads one base past it from a buffer that
holds whatever a longer oligo left there before.  Where that base can
change the result, `Melt.window` returns every outcome (one for each of
A, C, G, T and for a base that pairs with nothing), and the reference
accepts any of them.
"""

import math

import numpy as np

f32 = np.float32

A, C, G, T, I, E, GAP = range(7)
NB, NBP = 7, 49
# the codes a stale buffer slot can hold: A, C, G, T, and 7, a code that
# pairs with no base (so that the phantom pair is always trimmed)
STALE = (A, C, G, T, 7)
CODE = {"A": A, "C": C, "G": G, "T": T, "$": E, "-": GAP}
_IDX = {"A": A, "C": C, "G": G, "T": T, "I": I, "E": E, "_": GAP}

T37 = f32(310.15)
NC_R = f32(1.9872e-3)
ZERO_C = f32(273.15)

# trace bits
M1 = 1      # from (i-1, j-1): the M state
UP = 2      # from (i-1, j): the gap-in-target state
LEFT = 4    # from (i, j-1): the gap-in-query state


def P(name):
    return _IDX[name[0]] * NB + _IDX[name[1]]


def entropy(dg, dh):
    """(dH - dG) / 310.15 in float32."""
    return f32((f32(dh) - f32(dg)) / T37)


# (pairs of base pairs sharing the value, dH kcal/mol, dG37 kcal/mol); a
# base pair is written query-base then target-base
STACKS = [
    # Watson-Crick (SantaLucia & Hicks 2004, Table 1)
    ([("AT", "AT"), ("TA", "TA")], -7.9, -1.00),
    ([("AT", "CG"), ("GC", "TA")], -8.4, -1.44),
    ([("AT", "GC"), ("CG", "TA")], -7.8, -1.28),
    ([("AT", "TA")], -7.2, -0.88),
    ([("CG", "AT"), ("TA", "GC")], -8.5, -1.45),
    ([("CG", "CG"), ("GC", "GC")], -8.0, -1.84),
    ([("CG", "GC")], -10.6, -2.17),
    ([("GC", "AT"), ("TA", "CG")], -8.2, -1.30),
    ([("GC", "CG")], -9.8, -2.24),
    ([("TA", "AT")], -7.2, -0.58),
    # 3' dangling ends
    ([("AE", "AT"), ("TA", "EA")], 0.2, -0.51),
    ([("AE", "CG"), ("GC", "EA")], -6.3, -0.96),
    ([("AE", "GC"), ("CG", "EA")], -3.7, -0.58),
    ([("AE", "TA"), ("AT", "EA")], -2.9, -0.5),
    ([("CE", "AT"), ("TA", "EC")], 0.6, -0.42),
    ([("CE", "CG"), ("GC", "EC")], -4.4, -0.52),
    ([("CE", "GC"), ("CG", "EC")], -4.0, -0.34),
    ([("CE", "TA"), ("AT", "EC")], -4.1, -0.02),
    ([("GE", "AT"), ("TA", "EG")], -1.1, -0.62),
    ([("GE", "CG"), ("GC", "EG")], -5.1, -0.72),
    ([("GE", "GC"), ("CG", "EG")], -3.9, -0.56),
    ([("GE", "TA"), ("AT", "EG")], -4.2, 0.48),
    ([("TE", "AT"), ("TA", "ET")], -6.9, -0.71),
    ([("TE", "CG"), ("GC", "ET")], -4.0, -0.58),
    ([("TE", "GC"), ("CG", "ET")], -4.9, -0.61),
    ([("TE", "TA"), ("AT", "ET")], -0.2, -0.10),
    # 5' dangling ends
    ([("EA", "AT"), ("TA", "AE")], -0.7, -0.48),
    ([("EA", "CG"), ("GC", "AE")], -2.1, -0.92),
    ([("EA", "GC"), ("CG", "AE")], -5.9, -0.82),
    ([("EA", "TA"), ("AT", "AE")], -0.5, -0.12),
    ([("EC", "AT"), ("TA", "CE")], 4.4, -0.19),
    ([("EC", "CG"), ("GC", "CE")], -0.2, -0.23),
    ([("EC", "GC"), ("CG", "CE")], -2.6, -0.31),
    ([("EC", "TA"), ("AT", "CE")], 4.7, 0.28),
    ([("EG", "AT"), ("TA", "GE")], -1.6, -0.50),
    ([("EG", "CG"), ("GC", "GE")], -3.9, -0.44),
    ([("EG", "GC"), ("CG", "GE")], -3.2, -0.01),
    ([("EG", "TA"), ("AT", "GE")], -4.1, -0.01),
    ([("ET", "AT"), ("TA", "TE")], 2.9, -0.29),
    ([("ET", "CG"), ("GC", "TE")], -4.4, -0.35),
    ([("ET", "GC"), ("CG", "TE")], -5.2, -0.52),
    ([("ET", "TA"), ("AT", "TE")], -3.8, 0.13),
    # G-A mismatches (Allawi & SantaLucia 1998, Biochemistry 37:2170)
    ([("AT", "AG"), ("GA", "TA")], -0.6, 0.14),
    ([("AT", "GA"), ("AG", "TA")], -0.7, 0.02),
    ([("CG", "AG"), ("GA", "GC")], -0.7, 0.03),
    ([("CG", "GA"), ("AG", "GC")], -4.0, 0.11),
    ([("GC", "AG"), ("GA", "CG")], -0.6, -0.25),
    ([("GC", "GA"), ("AG", "CG")], 0.5, -0.52),
    ([("TA", "AG"), ("GA", "AT")], 0.7, 0.42),
    ([("TA", "GA"), ("AG", "AT")], 3.0, 0.74),
    # C-T mismatches (Allawi & SantaLucia 1998, NAR 26:2694)
    ([("AT", "CT"), ("TC", "TA")], 0.7, 0.64),
    ([("AT", "TC"), ("CT", "TA")], -1.2, 0.73),
    ([("CG", "CT"), ("TC", "GC")], -0.8, 0.62),
    ([("CG", "TC"), ("CT", "GC")], -1.5, 0.40),
    ([("GC", "CT"), ("TC", "CG")], 2.3, 0.62),
    ([("GC", "TC"), ("CT", "CG")], 5.2, 0.98),
    ([("TA", "CT"), ("TC", "AT")], 1.2, 0.97),
    ([("TA", "TC"), ("CT", "AT")], 1.0, 0.75),
    # A-C mismatches (Allawi & SantaLucia 1998, Biochemistry 37:9435)
    ([("AT", "AC"), ("CA", "TA")], 2.3, 0.88),
    ([("AT", "CA"), ("AC", "TA")], 5.3, 0.77),
    ([("CG", "AC"), ("CA", "GC")], 1.9, 0.75),
    ([("CG", "CA"), ("AC", "GC")], 0.6, 0.79),
    ([("GC", "AC"), ("CA", "CG")], 5.2, 0.81),
    ([("GC", "CA"), ("AC", "CG")], -0.7, 0.47),
    ([("TA", "AC"), ("CA", "AT")], 3.4, 0.92),
    ([("TA", "CA"), ("AC", "AT")], 7.6, 1.33),
    # G-T mismatches (Allawi & SantaLucia 1997, Biochemistry 36:10581)
    ([("AT", "GT"), ("TG", "TA")], 1.0, 0.71),
    ([("AT", "TG"), ("GT", "TA")], -2.5, 0.07),
    ([("CG", "GT"), ("TG", "GC")], -4.1, -0.47),
    ([("CG", "TG"), ("GT", "GC")], -2.8, -0.32),
    ([("GC", "GT"), ("TG", "CG")], 3.3, 0.08),
    ([("GT", "GT"), ("TG", "TG")], 5.8, 0.74),
    ([("GC", "TG"), ("GT", "CG")], -4.4, -0.59),
    ([("GT", "TG")], 4.1, 1.15),
    ([("TA", "GT"), ("TG", "AT")], -0.1, 0.43),
    ([("TG", "GT")], -1.4, 0.52),
    ([("TA", "TG"), ("GT", "AT")], -1.3, 0.34),
    # like-with-like mismatches (Peyret et al. 1999)
    ([("AT", "AA"), ("AA", "TA")], 1.2, 0.61),
    ([("CG", "AA"), ("AA", "GC")], -0.9, 0.43),
    ([("GC", "AA"), ("AA", "CG")], -2.9, 0.17),
    ([("TA", "AA"), ("AA", "AT")], 4.7, 0.69),
    ([("AT", "CC"), ("CC", "TA")], 0.0, 1.33),
    ([("CG", "CC"), ("CC", "GC")], -1.5, 0.70),
    ([("GC", "CC"), ("CC", "CG")], 3.6, 0.79),
    ([("TA", "CC"), ("CC", "AT")], 6.1, 1.05),
    ([("AT", "GG"), ("GG", "TA")], -3.1, -0.13),
    ([("CG", "GG"), ("GG", "GC")], -4.9, -0.11),
    ([("GC", "GG"), ("GG", "CG")], -6.0, -1.11),
    ([("TA", "GG"), ("GG", "AT")], 1.6, 0.44),
    ([("AT", "TT"), ("TT", "TA")], -2.7, 0.69),
    ([("CG", "TT"), ("TT", "GC")], -5.0, -0.12),
    ([("GC", "TT"), ("TT", "CG")], -2.2, 0.45),
    ([("TA", "TT"), ("TT", "AT")], 0.2, 0.68),
]

# loop and bulge length free energies at 37 C (SantaLucia & Hicks 2004,
# Table 4); sizes between anchors are interpolated
LOOP_DG = {3: 3.2, 4: 3.6, 5: 4.0, 6: 4.4, 7: 4.6, 8: 4.8, 9: 4.9, 10: 4.9,
           12: 5.2, 14: 5.4, 16: 5.6, 18: 5.8, 20: 5.9, 25: 6.3, 30: 6.6}
BULGE_DG = {1: 4.0, 2: 2.9, 3: 3.1, 4: 3.2, 5: 3.3, 6: 3.5, 7: 3.7, 8: 3.9,
            9: 4.1, 10: 4.3, 12: 4.5, 14: 4.8, 16: 5.0, 18: 5.2, 20: 5.3,
            25: 5.6, 30: 5.9}
BETWEEN = [(11, 10, 12), (13, 12, 14), (15, 14, 16), (17, 16, 18),
           (19, 18, 20), (21, 20, 25), (22, 20, 25), (23, 20, 25),
           (24, 20, 25), (26, 25, 30), (27, 25, 30), (28, 25, 30),
           (29, 25, 30)]
MAX_LOOP = 512

# NucCruc's supplementary values: (dH, dS) of an internal loop step, a
# bulge step, a terminal A-T / G-C match and a terminal mismatch next to a
# gap or an end; and the salt factor of each
SUPP = {"loop": (-5.779, -2.330e-2), "bulge": (5.247e-1, 3.318e-4),
        "term_at": (-4.474, -2.091e-2), "term_gc": (-3.000, -1.318e-2),
        "term_mm": (-2.421, -1.180e-2)}
SUPP_SALT = {"loop": 3.08, "bulge": 0.69, "term_match": 0.56,
             "term_mm": 1.31}
SALT = f32(0.368e-3)
INIT = (f32(0.2), entropy(1.96, 0.2))
AT_CLOSING = (f32(2.2), entropy(0.05, 2.2))
ASYM_LOOP_S = entropy(0.3, 0.0)
BULGE_AT_S = entropy(0.5, 0.0)


def _length_entropy(anchors):
    s = np.zeros(MAX_LOOP + 1, np.float32)
    for k, dg in anchors.items():
        s[k] = entropy(dg, 0.0)
    for x, b, e in BETWEEN:
        frac = f32(f32(x - b) / f32(e - b))
        s[x] = f32(s[b] + f32(f32(s[e] - s[b]) * frac))
    coeff = f32(f32(2.44) * NC_R)
    for n in range(31, MAX_LOOP):
        s[n] = f32(np.float64(s[30])
                   - np.float64(coeff) * math.log(n / 30.0))
    return s


def _tables():
    H = np.zeros((NBP, NBP), np.float32)
    S = np.zeros((NBP, NBP), np.float32)
    for i in range(5):
        for j in range(5):
            for a, b in ((i * NB + j, GAP * NB + GAP),
                         (i * NB + GAP, GAP * NB + j),
                         (GAP * NB + i, j * NB + GAP)):
                H[a, b] = H[b, a] = f32(100.0)
    for pairs, dh, dg in STACKS:
        for a, b in pairs:
            H[P(a), P(b)] = f32(dh)
            S[P(a), P(b)] = entropy(dg, dh)
    wc = np.zeros(NBP, bool)
    for name in ("AT", "TA", "CG", "GC"):
        wc[P(name)] = True
    return H, S, wc


H_TAB, S_TAB, WC = _tables()
LOOP_S = _length_entropy(LOOP_DG)
BULGE_S = _length_entropy(BULGE_DG)


def score_table(temp, na):
    """The DP's int32 table of -dG x 10000 (truncated) for every pair of
    base pairs at temperature `temp` (K) and [Na+] `na` (M): stacks with
    their salt term; a pair next to a gap or an end, two mismatches in a
    row and a bulge step take the supplementary values, never below 0."""
    temp = f32(temp)
    sc = f32(np.float64(SALT) * np.log(np.float64(na)))

    def scale(x):
        return np.trunc(np.float32(x * f32(10000.0))).astype(np.int64)

    def supp(key, salt_key):
        h, s = SUPP[key]
        salt = f32(sc * f32(SUPP_SALT[salt_key]))
        v = f32(f32(h) - temp * f32(f32(s) + salt))
        return max(0, int(scale(v)))

    dg = scale(H_TAB - temp * (S_TAB + sc))
    at, gc = supp("term_at", "term_match"), supp("term_gc", "term_match")
    mm = supp("term_mm", "term_mm")
    loop, bulge = supp("loop", "loop"), supp("bulge", "bulge")
    term_i = at
    for i in range(5):
        for j in range(5):
            cur = i * NB + j
            for k in range(5):
                for prev in (k * NB + GAP, GAP * NB + k):
                    if WC[cur]:
                        v = at if cur in (P("AT"), P("TA")) else \
                            gc if cur in (P("GC"), P("CG")) else term_i
                    else:
                        v = mm
                    dg[cur, prev] = dg[prev, cur] = v
            if not WC[cur]:
                for k in range(5):
                    for m in range(5):
                        if not WC[k * NB + m]:
                            dg[cur, k * NB + m] = loop
    for i in range(5):
        for j in range(5):
            dg[i * NB + GAP, j * NB + GAP] = bulge
            dg[GAP * NB + i, GAP * NB + j] = bulge
    return dg.astype(np.int32).reshape(-1)


def comp(q, t):
    """Whether two codes are Watson-Crick partners."""
    return q < 4 and t < 4 and q + t == 3


def pair(q, t):
    """The base-pair index of codes q and t; the code 7 (a slot that pairs
    with nothing) reads as a gap's partner for the tables, which it never
    reaches."""
    return min(q, GAP) * NB + min(t, GAP)


def is_virtual(b):
    return b in (E, GAP)


class Arith:
    """float32 arithmetic, or every result rounded to bfloat16 (the
    control)."""

    def __init__(self, dtype="float32"):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(dtype)
        self.bf16 = dtype == "bfloat16"

    def c(self, x):
        x = f32(x)
        if not self.bf16:
            return x
        b = np.array([x], np.float32).view(np.uint32)
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
            & np.uint32(0xFFFF0000)
        return b.view(np.float32)[0]


class Alignment:
    __slots__ = ("q", "t", "fm_q", "fm_t", "lm_q", "lm_t", "dH", "dS", "tm",
                 "valid")

    def __init__(self):
        self.q, self.t = [], []
        self.fm_q = self.fm_t = self.lm_q = self.lm_t = 0
        self.dH = self.dS = self.tm = f32(0)
        self.valid = False

    def copy(self):
        a = Alignment()
        a.q, a.t = list(self.q), list(self.t)
        for k in ("fm_q", "fm_t", "lm_q", "lm_t", "dH", "dS", "tm", "valid"):
            setattr(a, k, getattr(self, k))
        return a


def evaluate(al, na, conc, ar=None):
    """dH, dS and Tm of the alignment rows al.q, al.t (codes, the query
    5'->3' against the target 3'->5'), in place; False where dH >= 0."""
    ar = ar or Arith()
    c = ar.c
    q, t = al.q, al.t
    AT_, TA_, GT_, TG_ = P("AT"), P("TA"), P("GT"), P("TG")
    EE = E * NB + E
    PAIR__ = GAP * NB + GAP
    terminal_bp = last_last_bp = last_bp = PAIR__
    dh, ds = c(INIT[0]), c(INIT[1])
    n_qgap = n_tgap = n_mm = 0
    n_base = 0
    terminal_5 = False
    cur_bp = pair(q[0], t[0])
    if WC[cur_bp]:
        terminal_5 = True
        if cur_bp in (AT_, TA_):
            dh, ds = c(dh + AT_CLOSING[0]), c(ds + AT_CLOSING[1])
    n_base += (0 if is_virtual(q[0]) else 1) + (0 if is_virtual(t[0]) else 1)
    n = len(q)
    for ai in range(1, n):
        last_last_bp, last_bp = last_bp, cur_bp
        cur_bp = pair(q[ai], t[ai])
        start, stop = ai == 1, ai == n - 1
        in_loop = q[ai] == GAP or t[ai] == GAP or (not WC[last_bp]
                                                   and not WC[cur_bp])
        if not in_loop:
            last_real = last_bp // NB < E and last_bp % NB < E
            cur_real = cur_bp // NB < E and cur_bp % NB < E
            if start and not WC[last_bp] and last_real:
                tq, tr = divmod(last_bp, NB)
                for tp in (pair(tq, E), pair(E, tr)):
                    dh = c(dh + H_TAB[tp, cur_bp])
                    ds = c(ds + S_TAB[tp, cur_bp])
            elif stop and not WC[cur_bp] and cur_real:
                for tp in (pair(q[ai], E), pair(E, t[ai])):
                    dh = c(dh + H_TAB[last_bp, tp])
                    ds = c(ds + S_TAB[last_bp, tp])
            else:
                dh = c(dh + H_TAB[last_bp, cur_bp])
                ds = c(ds + S_TAB[last_bp, cur_bp])
            n_base += (0 if is_virtual(q[ai]) else 1) \
                + (0 if is_virtual(t[ai]) else 1)
        if WC[cur_bp] or cur_bp == EE:
            terminal_bp = cur_bp
            if not terminal_5:
                terminal_5 = True
                if cur_bp in (AT_, TA_):
                    dh = c(dh + AT_CLOSING[0])
                    ds = c(ds + AT_CLOSING[1])
            max_gap = max(n_qgap, n_tgap)
            if n_mm > 1 or (max_gap > 0 and n_mm == 1):
                # an internal loop closes here
                gap_diff = abs(n_qgap - n_tgap)
                size = n_mm * 2 + gap_diff
                if size == 2 and last_bp in (GT_, TG_) \
                        and last_last_bp in (GT_, TG_):
                    dh = c(dh + H_TAB[last_last_bp, last_bp])
                    ds = c(ds + S_TAB[last_last_bp, last_bp])
                    n_base += 2
                else:
                    ds = c(ds + LOOP_S[size])
                    ds = c(ds + c(f32(gap_diff) * ASYM_LOOP_S))
                    rhs_q = rhs_t = ai - 1
                    dh = c(dh - H_TAB[last_bp, cur_bp])
                    ds = c(ds - S_TAB[last_bp, cur_bp])
                    if not (last_bp % NB == GAP or last_bp // NB >= GAP):
                        dh = c(dh + H_TAB[last_bp, cur_bp])
                        ds = c(ds + S_TAB[last_bp, cur_bp])
                    else:
                        mm_bp = PAIR__
                        if last_bp // NB == GAP:
                            while True:
                                if not is_virtual(q[rhs_q]):
                                    mm_bp = pair(q[rhs_q], last_bp % NB)
                                    break
                                if rhs_q == 0:
                                    break
                                rhs_q -= 1
                        else:
                            while True:
                                if not is_virtual(t[rhs_t]):
                                    mm_bp = pair(last_bp // NB, t[rhs_t])
                                    break
                                if rhs_t == 0:
                                    break
                                rhs_t -= 1
                        dh = c(dh + H_TAB[mm_bp, cur_bp])
                        ds = c(ds + S_TAB[mm_bp, cur_bp])
                    lhs_q = lhs_t = ai - 1
                    while True:
                        pm_bp = pair(q[lhs_q], t[lhs_t])
                        if WC[pm_bp]:
                            lhs_q += 1
                            lhs_t += 1
                            if q[lhs_q] != GAP and t[lhs_t] != GAP:
                                mm_bp = pair(q[lhs_q], t[lhs_t])
                                dh = c(dh - H_TAB[pm_bp, mm_bp])
                                ds = c(ds - S_TAB[pm_bp, mm_bp])
                            else:
                                n_base += 2
                                while q[lhs_q] == GAP:
                                    lhs_q += 1
                                while t[lhs_t] == GAP:
                                    lhs_t += 1
                            mm_bp = pair(q[lhs_q], t[lhs_t])
                            dh = c(dh + H_TAB[pm_bp, mm_bp])
                            ds = c(ds + S_TAB[pm_bp, mm_bp])
                            break
                        if lhs_q == 0:
                            break
                        lhs_q -= 1
                        lhs_t -= 1
                    if rhs_q != lhs_q:
                        n_base += 1
                    if rhs_t != lhs_t:
                        n_base += 1
            elif n_qgap or n_tgap:
                # a bulge closes here
                size = max(n_qgap, n_tgap)
                if size == 1:
                    dh = c(dh + H_TAB[last_last_bp, cur_bp])
                    ds = c(ds + S_TAB[last_last_bp, cur_bp])
                ds = c(ds + BULGE_S[size])
                if size != 1 and q[ai] in (A, T):
                    ds = c(ds + BULGE_AT_S)
                if size != 1:
                    qi = ti = ai
                    while True:
                        qi -= 1
                        ti -= 1
                        if not (qi != 0 and ti != 0
                                and (q[qi] == GAP or t[ti] == GAP)):
                            break
                    if pair(q[qi], t[ti]) in (AT_, TA_):
                        ds = c(ds + BULGE_AT_S)
            n_qgap = n_tgap = n_mm = 0
        else:
            n_mm += 0 if (is_virtual(q[ai]) or is_virtual(t[ai])) else 1
        n_qgap += q[ai] == GAP
        n_tgap += t[ai] == GAP
    if terminal_bp in (AT_, TA_):
        dh = c(dh + AT_CLOSING[0])
        ds = c(ds + AT_CLOSING[1])
    al.dH, al.dS = dh, ds
    if dh >= 0:
        return False
    salt = c(c(SALT * c(f32(0.5) * f32(n_base) - f32(1)))
             * f32(np.log(np.float32(na))))
    ds = c(ds + salt)
    al.dS = ds
    tm = c(c(dh / c(c(NC_R * f32(np.log(np.float32(conc)))) + ds)) - ZERO_C)
    al.tm = max(f32(0), tm)
    return True


def dp(queries, targets, table):
    """The DP over a batch of windows: `queries` (B, nq) and `targets`
    (B, nt) codes.  Returns the matrices M, Iq (a gap in the query), It
    (a gap in the target) as (B, nq + 1, nt + 1) int32 and their trace
    bits as uint8; row 0 and column 0 hold -1.  Row i holds the query's
    base nq - i (the query reversed), column j the target's base j - 1.

    A row at a time over every column: M and It read the row before;
    the gap-in-query state runs along the row,
        Iq[j] = max(A[j], max(Iq[j - 1], 0) - E[j]),
    and with X[j] = max(Iq[j], 0) = max(A'[j], X[j - 1] - E[j]), A' =
    max(A, 0), X[j] = cummax(A' + cumsum E)[j] - cumsum(E)[j]."""
    B, nq = queries.shape
    nt = targets.shape[1]
    shape = (B, nq + 1, nt + 1)
    M = np.full(shape, -1, np.int32)
    Iq = np.full(shape, -1, np.int32)
    It = np.full(shape, -1, np.int32)
    Mt = np.full(shape, 8, np.uint8)
    Iqt = np.full(shape, 8, np.uint8)
    Itt = np.full(shape, 8, np.uint8)
    q = queries.astype(np.int64)
    tb = targets.astype(np.int64)                       # (B, nt)
    pt = np.concatenate([np.full((B, 1), GAP, np.int64), tb[:, :-1]], 1)
    tab = table.astype(np.int64)
    ext_cost = tab[(pt * NB + GAP) * NBP + tb * NB + GAP]   # Iq extension
    for i in range(1, nq + 1):
        qb = q[:, nq - i][:, None]
        pq = np.full((B, 1), GAP, np.int64) if i == 1 \
            else q[:, nq - i + 1][:, None]
        cur = tb * NB + qb
        d1 = np.maximum(M[:, i - 1, :-1], 0) - tab[(pt * NB + pq) * NBP + cur]
        d2 = np.maximum(Iq[:, i - 1, :-1], 0) \
            - tab[(pt * NB + GAP) * NBP + cur]
        d3 = np.maximum(It[:, i - 1, :-1], 0) \
            - tab[(GAP * NB + pq) * NBP + cur]
        a12, a13, a23 = d1 >= d2, d1 >= d3, d2 >= d3
        one = a12 & a13
        two = ~a12 & a23
        M[:, i, 1:] = np.where(one, d1, np.where(two, d2, d3))
        Mt[:, i, 1:] = np.where(
            one, M1 | np.where(d1 == d2, LEFT, 0) | np.where(d1 == d3, UP, 0),
            np.where(two, LEFT | np.where(d2 == d3, UP, 0), UP))
        cg = GAP * NB + qb
        ins = np.maximum(M[:, i - 1, 1:], 0) - tab[(tb * NB + pq) * NBP + cg]
        ext = np.maximum(It[:, i - 1, 1:], 0) - tab[(GAP * NB + pq) * NBP + cg]
        It[:, i, 1:] = np.where(ins >= ext, ins, ext)
        Itt[:, i, 1:] = np.where(ins >= ext,
                                 M1 | np.where(ins == ext, UP, 0), UP)
        ins = np.maximum(M[:, i, :-1], 0) \
            - tab[(pt * NB + qb) * NBP + tb * NB + GAP]
        cs = np.cumsum(ext_cost, axis=1)
        x = np.maximum.accumulate(np.maximum(ins, 0) + cs, axis=1) - cs
        xprev = np.concatenate([np.zeros((B, 1), np.int64), x[:, :-1]], 1)
        ext = xprev - ext_cost
        Iq[:, i, 1:] = np.where(ins >= ext, ins, ext)
        Iqt[:, i, 1:] = np.where(ins >= ext,
                                 M1 | np.where(ins == ext, LEFT, 0), LEFT)
    return M, Iq, It, Mt, Iqt, Itt


def _split(x):
    return ((x & 1) + ((x & 2) >> 1) + ((x & 4) >> 2)) > 1


class _Branch:
    __slots__ = ("key", "mask", "cur")

    def __init__(self, key, mask):
        self.key, self.mask = key, mask
        self.cur = M1 if mask & M1 else (UP if mask & UP else LEFT)

    def next(self):
        self.cur <<= 1
        while self.cur < 8:
            if self.cur & self.mask:
                return True
            self.cur <<= 1
        return False


class Window:
    """One window's matrices (as lists) and what the traces read."""

    def __init__(self, q, t, mats, stale):
        self.q, self.t = q, t
        self.M, self.Iq, self.It, self.Mt, self.Iqt, self.Itt = mats
        self.stale = stale
        self.read_stale = False

    def q_at(self, i):
        if i < len(self.q):
            return self.q[i]
        self.read_stale = True
        return self.stale


def trace_back(w, cell, stack, zc):
    """One path from `cell` (i, j); `zc` holds the zero count, as NucCruc
    keeps it between traces."""
    nq = len(w.q)
    li, lj = cell
    al = Alignment()
    al.fm_q, al.fm_t = nq - li, lj - 1
    trunc, count = 0, False
    if zc[0] < 0:
        zc[0], count = 0, True
    else:
        trunc = zc[0]
        zc[0] -= 1
    key = None                      # the first step is the M state
    while True:
        if key is None:
            mask = M1
        else:
            kind, ki, kj = key
            mask = int((w.Mt, w.Iqt, w.Itt)[kind][ki, kj])
        if _split(mask):
            for b in stack:
                if b.key == key:
                    local = b.cur
                    break
            else:
                stack.append(_Branch(key, mask))
                local = stack[-1].cur
        else:
            local = mask
        valid = True
        if local == M1:
            if li > nq or lj < 1:
                valid = False
            else:
                v = w.M[li, lj]
                if v < 0:
                    valid = False
                elif v == 0:
                    if count:
                        zc[0] += 1
                    else:
                        trunc -= 1
                        if trunc == 0:
                            valid = False
                al.q.append(w.q_at(nq - li))
                al.t.append(w.t[lj - 1])
                al.lm_q, al.lm_t = nq - li, lj - 1
                key = (0, li, lj)
                li, lj = li - 1, lj - 1
        elif local == LEFT:
            if lj < 1:
                valid = False
            else:
                if w.Iq[li, lj] < 0:
                    valid = False
                al.q.append(GAP)
                al.t.append(w.t[lj - 1])
                al.lm_q, al.lm_t = nq - li + 1, lj - 1
                key = (1, li, lj)
                lj -= 1
        elif local == UP:
            if li > nq:
                valid = False
            else:
                if w.It[li, lj] < 0:
                    valid = False
                al.q.append(w.q_at(nq - li))
                al.t.append(GAP)
                al.lm_q, al.lm_t = nq - li, lj
                key = (2, li, lj)
                li -= 1
        else:
            return al
        if not valid:
            return al


def enumerate_cell(w, cell, best, temp, na, conc, ar):
    """Every co-optimal path from `cell`; keeps in `best` the alignment of
    least dG at `temp`."""
    stack, zc = [], [-1]
    first, count = True, 0
    best_dg = f32(best.dH - f32(temp) * best.dS)
    while True:
        if not first and not stack and zc[0] <= 0:
            break
        if 16 < count:
            break
        count += 1
        first = False
        al = trace_back(w, cell, stack, zc)
        while al.q and not WC[pair(al.q[-1], al.t[-1])]:
            if not is_virtual(al.q[-1]):
                al.lm_q -= 1
            if not is_virtual(al.t[-1]):
                al.lm_t += 1
            al.q.pop()
            al.t.pop()
        while al.q and not WC[pair(al.q[0], al.t[0])]:
            if not is_virtual(al.q[0]):
                al.fm_q += 1
            if not is_virtual(al.t[0]):
                al.fm_t -= 1
            al.q.pop(0)
            al.t.pop(0)
        if zc[0] == 0 and stack:
            while stack and not stack[-1].next():
                stack.pop()
            zc[0] = -1
        if len(al.q) < 3:
            continue
        if evaluate(al, na, conc, ar):
            dg = f32(al.dH - f32(temp) * al.dS)
            if not best.valid or dg < best_dg:
                best.__init__()
                for k in Alignment.__slots__:
                    setattr(best, k, getattr(al, k))
                best.q, best.t = list(al.q), list(al.t)
                best.valid = True
                best_dg = dg


def mismatches(al, n):
    mm = aligned = 0
    for a, b in zip(al.q, al.t):
        if not is_virtual(a):
            if not is_virtual(b) and not comp(a, b):
                mm += 1
            aligned += 1
    return mm if n < aligned else mm + n - aligned


def render(w, al):
    """The three printed rows: query, marks, target (without their 5'/3'
    labels)."""
    n, nt = len(w.q), len(w.t)
    pre = max(0, min(al.fm_q, nt - 1 - al.fm_t))
    suf = max(0, min(n - 1 - al.lm_q, al.lm_t))
    code = "ACGTI$-x"
    qrow = "".join(code[w.q_at(al.fm_q - pre + i)] for i in range(pre)) \
        + "".join(code[b] for b in al.q) \
        + "".join(code[w.q_at(al.lm_q + 1 + i)] for i in range(suf))
    marks = "".join(":" if comp(w.q_at(al.fm_q - pre + i),
                                w.t[al.fm_t + pre - i]) else " "
                    for i in range(pre)) \
        + "".join("|" if comp(a, b) else " " for a, b in zip(al.q, al.t)) \
        + "".join(":" if comp(w.q_at(al.lm_q + 1 + i), w.t[al.lm_t - i - 1])
                  else " " for i in range(suf))
    trow = "".join(code[w.t[al.fm_t + i]] for i in range(pre, 0, -1)) \
        + "".join(code[b] for b in al.t) \
        + "".join(code[w.t[al.lm_t - i]] for i in range(1, suf + 1))
    return qrow, marks, trow


class Melt:
    """Tm, dH, dS and the alignment of oligos against target windows at a
    search's temperature `temp` (K), [Na+] `na` and strand concentration
    `conc` (M)."""

    def __init__(self, temp=310.15, na=0.05, dtype="float32"):
        self.temp, self.na = f32(temp), na
        self.table = score_table(temp, na).astype(np.int64)
        self.ar = Arith(dtype)

    def batch(self, queries, targets, concs, min_tms=None):
        """Windows `targets` (B, nt) codes against `queries` (B, nq) codes
        at strand concentrations `concs` (B,): a list, a window each, of
        its outcomes (see `result`); with `min_tms` (B,) an outcome below
        its window's Tm has no printed rows."""
        queries = np.asarray(queries, np.int64)
        if queries.max(initial=0) > T or targets.max(initial=0) > T:
            raise ValueError("bases other than A, C, G, T")
        mats = dp(queries, targets, self.table)
        M = mats[0][:, 1:, 1:]
        best = M.reshape(len(M), -1).max(axis=1)
        cells = {}
        # the best cells in scan order; none where every cell reads below
        # the DP's starting best of -1
        hit = (M == best[:, None, None]) & (best >= -1)[:, None, None]
        for b, i, j in zip(*np.nonzero(hit)):
            cells.setdefault(int(b), []).append((int(i) + 1, int(j) + 1))
        out = []
        for b in range(len(targets)):
            lists = [m[b] for m in mats]
            min_tm = None if min_tms is None else f32(min_tms[b])
            out.append(self.outcomes(queries[b].tolist(),
                                     targets[b].tolist(), lists,
                                     cells.get(b, []), f32(concs[b]),
                                     min_tm))
        return out

    def outcomes(self, q, t, lists, cells, conc, min_tm=None):
        """The window's results: one where the stale slot is never read or
        never matters, else one for each thing it can hold."""
        first = self.result(Window(q, t, lists, STALE[0]), cells, conc,
                            min_tm)
        if not first[1]:
            return [first[0]]
        seen, outs = set(), []
        for s in STALE:
            r = self.result(Window(q, t, lists, s), cells, conc, min_tm)[0]
            key = (r["tm"], r["dH"], r["dS"], r["align"], r["range"])
            if key not in seen:
                seen.add(key)
                outs.append(r)
        return outs

    def result(self, w, cells, conc, min_tm=None):
        """(outcome, whether the stale slot was read): the alignment of
        least dG from every best cell `cells`, its Tm, dH, dS, dG,
        mismatches, gaps, printed rows and (5' query, 3' query, 3'
        target, 5' target) positions."""
        nq = len(w.q)
        best = Alignment()
        for cell in cells:
            enumerate_cell(w, cell, best, self.temp, self.na, conc, self.ar)
        r = {"valid": best.valid, "tm": best.tm, "dH": best.dH,
             "dS": best.dS,
             "dG": f32(best.dH - self.temp * best.dS)}
        if best.valid:
            r["mm"] = mismatches(best, nq)
            r["gaps"] = sum(b == GAP for b in best.q) \
                + sum(b == GAP for b in best.t)
            r["align"] = render(w, best) if min_tm is None \
                or best.tm >= min_tm else None
            r["range"] = (best.fm_q, best.lm_q, best.lm_t, best.fm_t)
        else:
            r.update(mm=0, gaps=0, align=None, range=None)
        return r, w.read_stale
