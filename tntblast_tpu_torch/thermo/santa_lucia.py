# Copy of tntblast_tpu/thermo/santa_lucia.py with the package name changed.
"""SantaLucia nearest-neighbor thermodynamic parameter tables.

Single source of truth for both the native (C++) melt engine and the
JAX/Pallas DP kernels.  All arithmetic is performed in float32 with the same
operation order as the reference implementation so that every derived value
is bit-identical (reference: nuc_cruc_santa_lucia.cpp:7-1182,
nuc_cruc.cpp:226-338 for the supplementary parameters, nuc_cruc.cpp:340-487
for the temperature/salt-dependent DP score table).

Published data sources (same as the reference):
  - SantaLucia & Hicks, Annu. Rev. Biophys. Biomol. Struct. 33:415-440 (2004)
  - Allawi & SantaLucia,  Biochemistry 36:10581 (1997); 37:2170 (1998);
    37:9435 (1998); NAR 26:2694 (1998)
  - Peyret et al., Biochemistry 38:3468 (1999)
  - Watkins & SantaLucia, NAR 33:6258 (2005) (inosine)
  - Unpublished supplementary loop/bulge/terminal parameters distributed with
    the TM program of Leber & Kaderali (Bioinformatics 2005), refit by the
    reference author (nuc_cruc.cpp:271-300).

Tables are indexed by nearest-neighbor *pairs of base pairs*: a pair is
``first*7 + second`` over the 7-letter alphabet A,C,G,T,I,E(dangling),-(gap),
and a stack entry is ``(prev_pair, cur_pair)`` into a 49x49 matrix.
"""

import json
import os
from dataclasses import dataclass, field

import numpy as np

f32 = np.float32

NUM_BASE = 7
NUM_BASE_PAIR = NUM_BASE * NUM_BASE  # 49

MAX_LOOP_LENGTH = 512
MAX_BULGE_LENGTH = 512
MAX_HAIRPIN_LENGTH = 512

_T37 = f32(310.15)

_BASE_IDX = {"A": 0, "C": 1, "G": 2, "T": 3, "I": 4, "E": 5, "_": 6}


def P(name):
    """Pair index from a two-letter name, e.g. P("AT") == 0*7+3."""
    return _BASE_IDX[name[0]] * NUM_BASE + _BASE_IDX[name[1]]


def _entropy(dG, dH):
    """ENTROPY(dG, dH) = (dH - dG)/310.15 in float32 (reference nuc_cruc.h:42)."""
    return f32((f32(dH) - f32(dG)) / _T37)


# ---------------------------------------------------------------------------
# Nearest-neighbor stack data.  Each entry: (list of (prev, cur) pair-name
# tuples that share the value, dH [kcal/mol], dG@37C [kcal/mol]).  dS is
# derived via _entropy.  Grouped exactly like the published tables.
_NN_STACKS = [
    # -- Watson-Crick matches (SantaLucia & Hicks 2004, Table 1) ------------
    ([("AT", "AT"), ("TA", "TA")], -7.9, -1.00),   # AA/TT
    ([("AT", "CG"), ("GC", "TA")], -8.4, -1.44),   # AC/TG
    ([("AT", "GC"), ("CG", "TA")], -7.8, -1.28),   # AG/TC
    ([("AT", "TA")], -7.2, -0.88),                 # AT/TA
    ([("CG", "AT"), ("TA", "GC")], -8.5, -1.45),   # CA/GT
    ([("CG", "CG"), ("GC", "GC")], -8.0, -1.84),   # CC/GG
    ([("CG", "GC")], -10.6, -2.17),                # CG/GC
    ([("GC", "AT"), ("TA", "CG")], -8.2, -1.30),   # GA/CT
    ([("GC", "CG")], -9.8, -2.24),                 # GC/CG
    ([("TA", "AT")], -7.2, -0.58),                 # TA/AT
    # -- 3' dangling ends ---------------------------------------------------
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
    # -- 5' dangling ends ---------------------------------------------------
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
    # -- single G-A mismatches (Allawi 1998, Biochem 37:2170) --------------
    ([("AT", "AG"), ("GA", "TA")], -0.6, 0.14),
    ([("AT", "GA"), ("AG", "TA")], -0.7, 0.02),
    ([("CG", "AG"), ("GA", "GC")], -0.7, 0.03),
    ([("CG", "GA"), ("AG", "GC")], -4.0, 0.11),
    ([("GC", "AG"), ("GA", "CG")], -0.6, -0.25),
    ([("GC", "GA"), ("AG", "CG")], 0.5, -0.52),
    ([("TA", "AG"), ("GA", "AT")], 0.7, 0.42),
    ([("TA", "GA"), ("AG", "AT")], 3.0, 0.74),
    # -- single C-T mismatches (Allawi 1998, NAR 26:2694) ------------------
    ([("AT", "CT"), ("TC", "TA")], 0.7, 0.64),
    ([("AT", "TC"), ("CT", "TA")], -1.2, 0.73),
    ([("CG", "CT"), ("TC", "GC")], -0.8, 0.62),
    ([("CG", "TC"), ("CT", "GC")], -1.5, 0.40),
    ([("GC", "CT"), ("TC", "CG")], 2.3, 0.62),
    ([("GC", "TC"), ("CT", "CG")], 5.2, 0.98),
    ([("TA", "CT"), ("TC", "AT")], 1.2, 0.97),
    ([("TA", "TC"), ("CT", "AT")], 1.0, 0.75),
    # -- single A-C mismatches (Allawi 1998, Biochem 37:9435) --------------
    ([("AT", "AC"), ("CA", "TA")], 2.3, 0.88),
    ([("AT", "CA"), ("AC", "TA")], 5.3, 0.77),
    ([("CG", "AC"), ("CA", "GC")], 1.9, 0.75),
    ([("CG", "CA"), ("AC", "GC")], 0.6, 0.79),
    ([("GC", "AC"), ("CA", "CG")], 5.2, 0.81),
    ([("GC", "CA"), ("AC", "CG")], -0.7, 0.47),
    ([("TA", "AC"), ("CA", "AT")], 3.4, 0.92),
    ([("TA", "CA"), ("AC", "AT")], 7.6, 1.33),
    # -- single G-T mismatches (Allawi 1997, Biochem 36:10581) -------------
    ([("AT", "GT"), ("TG", "TA")], 1.0, 0.71),
    ([("AT", "TG"), ("GT", "TA")], -2.5, 0.07),
    ([("CG", "GT"), ("TG", "GC")], -4.1, -0.47),
    ([("CG", "TG"), ("GT", "GC")], -2.8, -0.32),
    ([("GC", "GT"), ("TG", "CG")], 3.3, 0.08),
    ([("GT", "GT"), ("TG", "TG")], 5.8, 0.74),    # gg/tt double mismatch
    ([("GC", "TG"), ("GT", "CG")], -4.4, -0.59),
    ([("GT", "TG")], 4.1, 1.15),                  # gt/tg double mismatch
    ([("TA", "GT"), ("TG", "AT")], -0.1, 0.43),
    ([("TG", "GT")], -1.4, 0.52),                 # tg/gt double mismatch
    ([("TA", "TG"), ("GT", "AT")], -1.3, 0.34),
    # -- single like-with-like mismatches (Peyret 1999) --------------------
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
    # -- inosine pairs (Watkins & SantaLucia 2005) -------------------------
    # I-C
    ([("AT", "IC"), ("CI", "TA")], -8.9, -0.96),
    ([("TA", "IC"), ("CI", "AT")], -5.9, -0.46),
    ([("AT", "CI"), ("IC", "TA")], -8.8, -0.89),
    ([("TA", "CI"), ("IC", "AT")], -4.9, -0.59),
    ([("CG", "IC"), ("CI", "GC")], -5.4, -1.14),
    ([("GC", "IC"), ("CI", "CG")], -6.8, -0.86),
    ([("CG", "CI"), ("IC", "GC")], -8.3, -0.88),
    ([("GC", "CI"), ("IC", "CG")], -5.0, -1.07),
    # I-A
    ([("AT", "IA"), ("AI", "TA")], -8.3, -0.51),
    ([("TA", "IA"), ("AI", "AT")], -3.4, 0.09),
    ([("AT", "AI"), ("IA", "TA")], -0.7, 0.12),
    ([("TA", "AI"), ("IA", "AT")], -1.3, 0.12),
    ([("CG", "IA"), ("AI", "GC")], 2.6, -0.18),
    ([("GC", "IA"), ("AI", "CG")], -7.8, -1.24),
    ([("CG", "AI"), ("IA", "GC")], -7.0, -0.77),
    ([("GC", "AI"), ("IA", "CG")], -7.6, -1.33),
    # I-T
    ([("AT", "IT"), ("TI", "TA")], 0.49, 0.71),
    ([("TA", "IT"), ("TI", "AT")], -6.5, 0.36),
    ([("AT", "TI"), ("IT", "TA")], -5.6, 0.22),
    ([("TA", "TI"), ("IT", "AT")], -0.8, 0.54),
    ([("CG", "IT"), ("TI", "GC")], -1.0, -0.26),
    ([("GC", "IT"), ("TI", "CG")], -3.5, -0.19),
    ([("CG", "TI"), ("IT", "GC")], 0.1, 0.41),
    ([("GC", "TI"), ("IT", "CG")], -4.3, -0.54),
    # I-G
    ([("AT", "IG"), ("GI", "TA")], -4.9, 0.02),
    ([("TA", "IG"), ("GI", "AT")], -1.9, 0.76),
    ([("AT", "GI"), ("IG", "TA")], 0.1, 0.65),
    ([("TA", "GI"), ("IG", "AT")], 1.0, 0.70),
    ([("CG", "IG"), ("GI", "GC")], 7.1, 0.47),
    ([("GC", "IG"), ("GI", "CG")], -1.1, -0.10),
    ([("CG", "GI"), ("IG", "GC")], 5.8, 0.54),
    ([("GC", "GI"), ("IG", "CG")], -7.6, -0.74),
    # I-I
    ([("AT", "II"), ("II", "TA")], -3.3, 0.40),
    ([("TA", "II"), ("II", "AT")], 0.1, 0.81),
    ([("CG", "II"), ("II", "GC")], 1.3, 0.36),
    ([("GC", "II"), ("II", "CG")], -0.5, -0.09),
    # tandem inosine pairs
    ([("IC", "IC"), ("CI", "CI")], -9.3, -0.64),
    ([("IA", "IC"), ("CI", "AI")], -3.1, 0.27),
    ([("IC", "IA"), ("AI", "CI")], -8.7, 0.44),
    ([("IA", "IA"), ("AI", "AI")], -2.1, -0.27),
    ([("IT", "IA"), ("AI", "TI")], 2.3, 0.83),
    ([("IG", "IA"), ("AI", "GI")], 4.2, 0.30),
    ([("IC", "IT"), ("TI", "CI")], -14.5, 0.33),
    ([("IA", "IT"), ("TI", "AI")], -17.8, 0.19),
    ([("IT", "IT"), ("TI", "TI")], -7.0, 1.69),
    ([("IG", "IT"), ("TI", "GI")], -19.4, 0.13),
    ([("IT", "IG"), ("GI", "TI")], 13.3, 0.03),
    ([("IG", "IG"), ("GI", "GI")], 0.3, -1.30),
    ([("II", "II")], -10.65, 0.52),
    # "other" tandem inosine mismatch pairs
    ([("IC", "CI")], -12.1, -0.85),
    ([("CI", "IC")], -1.8, 0.06),
    ([("IA", "AI")], -13.9, -1.43),
    ([("AI", "IA")], -9.5, -0.56),
    ([("IT", "TI")], -7.6, 2.03),
    ([("TI", "IT")], -14.7, 0.61),
    ([("IG", "GI")], 3.2, 1.18),
    ([("GI", "IG")], -4.2, 1.12),
]

# Loop-length entropy anchor points (SantaLucia & Hicks 2004, Table 4), as
# dG@37C values.  Intermediate sizes are linearly interpolated and sizes > 30
# use the Jacobson-Stockmayer extrapolation.
_LOOP_DG = {3: 3.2, 4: 3.6, 5: 4.0, 6: 4.4, 7: 4.6, 8: 4.8, 9: 4.9, 10: 4.9,
            12: 5.2, 14: 5.4, 16: 5.6, 18: 5.8, 20: 5.9, 25: 6.3, 30: 6.6}
_BULGE_DG = {1: 4.0, 2: 2.9, 3: 3.1, 4: 3.2, 5: 3.3, 6: 3.5, 7: 3.7, 8: 3.9,
             9: 4.1, 10: 4.3, 12: 4.5, 14: 4.8, 16: 5.0, 18: 5.2, 20: 5.3,
             25: 5.6, 30: 5.9}
_HAIRPIN_DG = {3: 3.5, 4: 3.5, 5: 3.3, 6: 4.0, 7: 4.2, 8: 4.3, 9: 4.5,
               10: 4.6, 12: 5.0, 14: 5.1, 16: 5.3, 18: 5.5, 20: 5.7,
               25: 6.1, 30: 6.3}

# Index pairs for the linear interpolation of missing sizes
_INTERP = [(11, 10, 12), (13, 12, 14), (15, 14, 16), (17, 16, 18),
           (19, 18, 20), (21, 20, 25), (22, 20, 25), (23, 20, 25),
           (24, 20, 25), (26, 25, 30), (27, 25, 30), (28, 25, 30),
           (29, 25, 30)]

# Supplementary parameter indices (reference nuc_cruc.h:496-526)
LOOP_H, LOOP_S = 0, 1
BULGE_H, BULGE_S = 2, 3
TERMINAL_MATCH_AT_H, TERMINAL_MATCH_AT_S = 4, 5
TERMINAL_MATCH_GC_H, TERMINAL_MATCH_GC_S = 6, 7
TERMINAL_MATCH_I_H, TERMINAL_MATCH_I_S = 8, 9
TERMINAL_MISMATCH_H, TERMINAL_MISMATCH_S = 10, 11
NUM_SUPP_PARAM = 12

LOOP_SALT, BULGE_SALT, TERMINAL_MATCH_SALT, TERMINAL_MISMATCH_SALT = range(4)
NUM_SALT_PARAM = 4

NC_R = f32(1.9872e-3)


@dataclass
class ThermoParams:
    """All temperature-independent SantaLucia tables (float32, exact)."""

    param_H: np.ndarray = field(default=None)           # (49, 49)
    param_S: np.ndarray = field(default=None)           # (49, 49)
    param_loop_terminal_H: np.ndarray = field(default=None)
    param_loop_terminal_S: np.ndarray = field(default=None)
    param_hairpin_terminal_H: np.ndarray = field(default=None)
    param_hairpin_terminal_S: np.ndarray = field(default=None)
    param_loop_S: np.ndarray = field(default=None)      # (513,)
    param_bulge_S: np.ndarray = field(default=None)
    param_hairpin_S: np.ndarray = field(default=None)
    hairpin_special_names: list = field(default=None)   # 131 loop strings
    param_hairpin_special_H: np.ndarray = field(default=None)
    param_hairpin_special_S: np.ndarray = field(default=None)
    param_supp: np.ndarray = field(default=None)        # (12,)
    param_supp_salt: np.ndarray = field(default=None)   # (4,)
    param_init_H: np.float32 = f32(0)
    param_init_S: np.float32 = f32(0)
    param_AT_closing_H: np.float32 = f32(0)
    param_AT_closing_S: np.float32 = f32(0)
    param_symmetry_S: np.float32 = f32(0)
    param_SALT: np.float32 = f32(0)
    param_asymmetric_loop_dS: np.float32 = f32(0)
    param_bulge_AT_closing_S: np.float32 = f32(0)
    watson_and_crick: np.ndarray = field(default=None)  # (49,) bool


def _length_entropy(anchors, max_len):
    """Build a loop/bulge/hairpin length-entropy table of size max_len+1."""
    s = np.zeros(max_len + 1, dtype=np.float32)
    for k, dg in anchors.items():
        s[k] = _entropy(dg, 0.0)
    for x, b, e in _INTERP:
        # INTERPOLATE: S[b] + (S[e]-S[b]) * float(x-b)/(e-b), float32 ops
        frac = f32(f32(x - b) / f32(e - b))
        s[x] = f32(s[b] + f32(f32(s[e] - s[b]) * frac))
    # Jacobson-Stockmayer: dS(n) = dS(30) - 2.44*R*ln(n/30); the reference
    # evaluates 2.44f*NC_R in float, the log in double, and the final
    # subtraction in double before narrowing to float.
    coeff = f32(f32(2.44) * NC_R)
    for n in range(31, max_len):
        s[n] = f32(np.float64(s[30]) - np.float64(coeff) * np.log(np.float64(n) / 30.0))
    # The reference loop stops at max_len-1 leaving the last slot
    # uninitialized; zero is a safe deterministic stand-in (never reachable
    # for oligo-scale alignments).
    return s


def build_tables():
    """Construct all static tables (reference init_param_Santa_Lucia + ctor)."""
    p = ThermoParams()

    H = np.zeros((NUM_BASE_PAIR, NUM_BASE_PAIR), dtype=np.float32)
    S = np.zeros((NUM_BASE_PAIR, NUM_BASE_PAIR), dtype=np.float32)

    # Forbidden interactions get a +100 kcal/mol enthalpy penalty
    default_H = f32(100.0)
    GAP = _BASE_IDX["_"]
    for i in range(5):          # A..I
        for j in range(5):
            curr = i * NUM_BASE + j
            prev = GAP * NUM_BASE + GAP          # -- / --
            H[curr, prev] = H[prev, curr] = default_H
            curr2 = i * NUM_BASE + GAP           # x- / -y
            prev2 = GAP * NUM_BASE + j
            H[curr2, prev2] = H[prev2, curr2] = default_H
            curr3 = GAP * NUM_BASE + i           # -x / y-
            prev3 = j * NUM_BASE + GAP
            H[curr3, prev3] = H[prev3, curr3] = default_H

    for pairs, dH, dG in _NN_STACKS:
        dH = f32(dH)
        dS = _entropy(dG, dH)
        for a, b in pairs:
            H[P(a), P(b)] = dH
            S[P(a), P(b)] = dS

    p.param_H = H
    p.param_S = S
    # The unpublished UNAFold terminal-mismatch tables ship empty in the
    # reference (nuc_cruc_santa_lucia_tstack{h,i}.cpp), so the loop/hairpin
    # terminal tables are identical copies of the stack tables.
    p.param_loop_terminal_H = H.copy()
    p.param_loop_terminal_S = S.copy()
    p.param_hairpin_terminal_H = H.copy()
    p.param_hairpin_terminal_S = S.copy()

    p.param_init_H = f32(0.2)
    p.param_init_S = _entropy(1.96, 0.2)
    p.param_AT_closing_H = f32(2.2)
    p.param_AT_closing_S = _entropy(0.05, 2.2)
    p.param_symmetry_S = _entropy(0.43, 0.0)
    p.param_SALT = f32(0.368e-3)
    p.param_asymmetric_loop_dS = _entropy(0.3, 0.0)
    p.param_bulge_AT_closing_S = _entropy(0.5, 0.0)

    p.param_loop_S = _length_entropy(_LOOP_DG, MAX_LOOP_LENGTH)
    p.param_bulge_S = _length_entropy(_BULGE_DG, MAX_BULGE_LENGTH)
    p.param_hairpin_S = _length_entropy(_HAIRPIN_DG, MAX_HAIRPIN_LENGTH)

    data_path = os.path.join(os.path.dirname(__file__), "special_hairpin_loops.json")
    with open(data_path) as fh:
        spec = json.load(fh)
    p.hairpin_special_names = spec["names"]
    p.param_hairpin_special_H = np.asarray(spec["dH"], dtype=np.float32)
    p.param_hairpin_special_S = np.asarray(spec["dS"], dtype=np.float32)

    # Supplementary loop/bulge/terminal parameters (reference ctor,
    # nuc_cruc.cpp:271-300; refit of the Leber & Kaderali TM values).
    supp = np.zeros(NUM_SUPP_PARAM, dtype=np.float32)
    supp[LOOP_H], supp[LOOP_S] = f32(-5.779), f32(-2.330e-2)
    supp[BULGE_H], supp[BULGE_S] = f32(5.247e-1), f32(3.318e-4)
    supp[TERMINAL_MATCH_AT_H] = f32(-4.474)
    supp[TERMINAL_MATCH_AT_S] = f32(-2.091e-2)
    supp[TERMINAL_MATCH_GC_H] = f32(-3.000)
    supp[TERMINAL_MATCH_GC_S] = f32(-1.318e-2)
    supp[TERMINAL_MATCH_I_H] = supp[TERMINAL_MATCH_AT_H]
    supp[TERMINAL_MATCH_I_S] = supp[TERMINAL_MATCH_AT_S]
    supp[TERMINAL_MISMATCH_H] = f32(-2.421)
    supp[TERMINAL_MISMATCH_S] = f32(-1.180e-2)
    p.param_supp = supp

    p.param_supp_salt = np.array([3.08, 0.69, 0.56, 1.31], dtype=np.float32)

    wc = np.zeros(NUM_BASE_PAIR, dtype=bool)
    for name in ["AT", "TA", "CG", "GC", "AI", "IA", "TI", "IT",
                 "GI", "IG", "CI", "IC", "II"]:
        wc[P(name)] = True
    p.watson_and_crick = wc
    return p


def update_dp_param(p: ThermoParams, target_T, na_concentration):
    """Recompute the int32 DP score table delta_g for (T, [Na+]).

    Bit-exact replication of reference nuc_cruc.cpp:340-487: base stacks get
    a per-pair salt correction folded into dS; pairs involving gaps and
    double mismatches are overridden with the supplementary loop/bulge/
    terminal parameters, clamped at >= 0 (always unfavorable).
    Scores are -dG * 10000 truncated toward zero (the DP *subtracts* these).
    """
    T = f32(target_T)
    # float = float * double(log) narrowed, matching the reference
    salt_correction = f32(np.float64(p.param_SALT) * np.log(np.float64(na_concentration)))

    loop_sc = f32(salt_correction * p.param_supp_salt[LOOP_SALT])
    bulge_sc = f32(salt_correction * p.param_supp_salt[BULGE_SALT])
    term_match_sc = f32(salt_correction * p.param_supp_salt[TERMINAL_MATCH_SALT])
    term_mismatch_sc = f32(salt_correction * p.param_supp_salt[TERMINAL_MISMATCH_SALT])

    def scale(x):
        # NC_SCORE_SCALE: int(float(x) * 10000.0f), C++ truncation toward 0
        return np.trunc(np.float32(x * f32(10000.0))).astype(np.int64)

    dg = scale(p.param_H - T * (p.param_S + salt_correction))

    wc = p.watson_and_crick
    supp = p.param_supp
    GAP = _BASE_IDX["_"]

    def supp_dg(h_idx, s_idx, sc):
        v = f32(supp[h_idx] - T * f32(supp[s_idx] + sc))
        return max(np.int64(0), scale(v))

    at_dg = supp_dg(TERMINAL_MATCH_AT_H, TERMINAL_MATCH_AT_S, term_match_sc)
    gc_dg = supp_dg(TERMINAL_MATCH_GC_H, TERMINAL_MATCH_GC_S, term_match_sc)
    i_dg = supp_dg(TERMINAL_MATCH_I_H, TERMINAL_MATCH_I_S, term_match_sc)
    mm_dg = supp_dg(TERMINAL_MISMATCH_H, TERMINAL_MISMATCH_S, term_mismatch_sc)
    loop_dg = supp_dg(LOOP_H, LOOP_S, loop_sc)
    bulge_dg = supp_dg(BULGE_H, BULGE_S, bulge_sc)

    AT, TA, CG, GC = P("AT"), P("TA"), P("CG"), P("GC")
    for i in range(5):
        for j in range(5):
            curr = i * NUM_BASE + j
            for k in range(5):
                prev1 = k * NUM_BASE + GAP
                prev2 = GAP * NUM_BASE + k
                if wc[curr]:
                    if curr in (AT, TA):
                        v = at_dg
                    elif curr in (GC, CG):
                        v = gc_dg
                    else:
                        v = i_dg
                else:
                    v = mm_dg
                dg[curr, prev1] = dg[prev1, curr] = v
                dg[curr, prev2] = dg[prev2, curr] = v
            if not wc[curr]:
                for k in range(5):
                    for l in range(5):
                        prev = k * NUM_BASE + l
                        if not wc[prev]:
                            dg[curr, prev] = loop_dg
    for i in range(5):
        for j in range(5):
            dg[i * NUM_BASE + GAP, j * NUM_BASE + GAP] = bulge_dg
            dg[GAP * NUM_BASE + i, GAP * NUM_BASE + j] = bulge_dg

    return dg.astype(np.int32)
