# Copy of tntblast_tpu/constants.py with the package name changed.
"""Program-wide constants and default parameter values.

Mirrors the reference's compiled-in defaults (reference: tntblast.h:19-98,
options.h:85-170, seq.h:9-42, nuc_cruc.h:31-52).  Values here define the
*semantics* of the search and must not drift from the reference.
"""

import numpy as np

# ---------------------------------------------------------------------------
# Base codes used for packed database sequences (reference: seq.h:12-35).
# The first five values must match the melt-engine base enum.
DB_A, DB_C, DB_G, DB_T = 0, 1, 2, 3
DB_MAX_ATGC = DB_T
DB_I = 4
DB_M, DB_R, DB_S, DB_V, DB_W = 5, 6, 7, 8, 9
DB_Y, DB_H, DB_K, DB_D, DB_B, DB_N = 10, 11, 12, 13, 14, 15
DB_GAP = 16
DB_UNKNOWN = 17

# Melt-engine base alphabet (reference: nuc_cruc.h:179-188):
# real bases A,C,G,T,I then virtual bases E (dangling end) and GAP,
# then the IUPAC degenerate codes.
BASE_A, BASE_C, BASE_G, BASE_T, BASE_I = 0, 1, 2, 3, 4
BASE_E, BASE_GAP = 5, 6
BASE_M, BASE_R, BASE_S, BASE_V, BASE_W = 7, 8, 9, 10, 11
BASE_Y, BASE_H, BASE_K, BASE_D, BASE_B, BASE_N = 12, 13, 14, 15, 16, 17

NUM_BASE = 7  # A,C,G,T,I + virtual E,GAP (pair-table alphabet)
NUM_BASE_PAIR = NUM_BASE * NUM_BASE  # 49

# Rendering map for melt-engine codes (reference: nuc_cruc_output.cpp:11)
BASE_TO_ASCII = "ACGTI$-MRSVWYHKDBN"

# Physical constants (reference: nuc_cruc.h:31-33)
NC_ZERO_C = np.float32(273.15)
NC_DEFAULT_T = np.float32(273.15 + 37.0)
NC_R = np.float32(1.9872e-3)  # Kcal/(Mol K)

MAX_SEQUENCE_LENGTH = 1024
MAX_LOOP_LENGTH = MAX_SEQUENCE_LENGTH // 2
MAX_BULGE_LENGTH = MAX_SEQUENCE_LENGTH // 2
MAX_HAIRPIN_LENGTH = MAX_SEQUENCE_LENGTH // 2

# Fixed-point DP score scaling (reference: nuc_cruc.h:161-168)
NC_SCORE_SCALE = 10000.0

# Search defaults (reference: tntblast.h:19-90)
DEFAULT_MAX_LEN = 2000
DEFAULT_PRIMER_CLAMP = 0
DEFAULT_MIN_MAX_PRIMER_CLAMP = -1
DEFAULT_PROBE_CLAMP_5 = 0
DEFAULT_PROBE_CLAMP_3 = 0
DEFAULT_MIN_PRIMER_TM = 0.0
DEFAULT_MAX_PRIMER_TM = 9999.0
DEFAULT_MIN_PROBE_TM = 0.0
DEFAULT_MAX_PROBE_TM = 9999.0
DEFAULT_MIN_PRIMER_DG = -9999.0
DEFAULT_MAX_PRIMER_DG = 0.0
DEFAULT_MIN_PROBE_DG = -9999.0
DEFAULT_MAX_PROBE_DG = 0.0
DEFAULT_SALT = 50.0e-3
DEFAULT_PRIMER_STRAND = 9.0e-7
DEFAULT_PROBE_STRAND = 2.5e-7
DEFAULT_TARGET_T = 310.15
DEFAULT_HASH_WORD_SIZE = 7
DEFAULT_DANGLE_5 = False
DEFAULT_DANGLE_3 = False
DEFAULT_FRAGMENT_TARGET_LENGTH = 500000
DEFAULT_MAX_GAP = 999
DEFAULT_MAX_MISMATCH = 999
DEFAULT_MAX_POLY_DEGEN = 3
DEFAULT_RESCALE_CT = True
NUM_FLANK_BASE = 4
DEFAULT_QT = 0.25

VERSION = "2.77 (February 19, 2026)"  # reference version we are parity-matched to

# Assay formats (reference: hybrid_sig.h:19)
ASSAY_PCR, ASSAY_PROBE, ASSAY_PADLOCK, ASSAY_MIPS, ASSAY_AFFYMETRIX, ASSAY_NONE = range(6)

# Strand selectors (reference: seq.h:38-42)
SEQ_STRAND_PLUS = 1
SEQ_STRAND_MINUS = 2
SEQ_STRAND_BOTH = 3

# Output format bits (reference: options.h:7-13)
OUTPUT_STANDARD = 1 << 0
OUTPUT_FASTA = 1 << 1
OUTPUT_NETWORK = 1 << 2
OUTPUT_INVERSE_TARGET = 1 << 3
OUTPUT_INVERSE_QUERY = 1 << 4
OUTPUT_ALIGNMENTS = 1 << 5
OUTPUT_SEQ_MATCH = 1 << 6

# Masking options (reference: tntblast.h:114-118)
NO_MASK = 0
MASK_PRIMERS = 1
MASK_PROBE = 2
REPLACE_PRIMERS = 4

# Query segmentation modes (reference: tntblast.h:122-124)
QUERY_SEGMENTATION_ON = 0
QUERY_SEGMENTATION_OFF = 1
QUERY_SEGMENTATION_ADAPTIVE = 2

# Threshold bookkeeping bits (reference: options.h:15-19)
THRESHOLD_NONE = 0
THRESHOLD_PRIMER_DELTA_G = 1 << 0
THRESHOLD_PRIMER_TM = 1 << 1
THRESHOLD_PROBE_DELTA_G = 1 << 2
THRESHOLD_PROBE_TM = 1 << 3

# ascii <-> db code maps (reference: seq.h:58-189)
ASCII_TO_DB = np.full(256, DB_UNKNOWN, dtype=np.uint8)
for _ch, _code in [
    ("A", DB_A), ("C", DB_C), ("G", DB_G), ("T", DB_T), ("U", DB_T),
    ("I", DB_I), ("M", DB_M), ("R", DB_R), ("S", DB_S), ("V", DB_V),
    ("W", DB_W), ("Y", DB_Y), ("H", DB_H), ("K", DB_K), ("D", DB_D),
    ("B", DB_B), ("N", DB_N), ("-", DB_GAP),
]:
    ASCII_TO_DB[ord(_ch)] = _code
    ASCII_TO_DB[ord(_ch.lower())] = _code

DB_TO_ASCII = np.frombuffer(b"ACGTIMRSVWYHKDBN-?", dtype=np.uint8).copy()
# index 16 is DB_GAP='-'; 17 unknown placeholder
_tmp = list("ACGTIMRSVWYHKDBN")
DB_TO_ASCII = np.frombuffer(
    ("".join(_tmp) + "-?").encode(), dtype=np.uint8).copy()

DB_TO_ASCII_COMPLEMENT = np.frombuffer(
    ("TGCAIKYSBWRDMHVN" + "-?").encode(), dtype=np.uint8).copy()

# db code -> melt-engine code for a *plus strand* target window
DB_TO_MELT_PLUS = np.array(
    [BASE_A, BASE_C, BASE_G, BASE_T, BASE_I,
     BASE_M, BASE_R, BASE_S, BASE_V, BASE_W,
     BASE_Y, BASE_H, BASE_K, BASE_D, BASE_B, BASE_N,
     255, 255], dtype=np.uint8)

# db code -> melt-engine code of the *complement* base (used when binding an
# oligo to the minus strand; reference: bind_oligo.cpp:187-254)
DB_TO_MELT_COMPLEMENT = np.array(
    [BASE_T, BASE_G, BASE_C, BASE_A, BASE_I,
     BASE_K, BASE_Y, BASE_S, BASE_B, BASE_W,
     BASE_R, BASE_D, BASE_M, BASE_H, BASE_V, BASE_N,
     255, 255], dtype=np.uint8)

# ascii oligo char -> melt-engine code (reference: nuc_cruc.h:190-231)
ASCII_TO_MELT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in [
    ("A", BASE_A), ("C", BASE_C), ("G", BASE_G), ("T", BASE_T), ("I", BASE_I),
    ("M", BASE_M), ("R", BASE_R), ("S", BASE_S), ("V", BASE_V), ("W", BASE_W),
    ("Y", BASE_Y), ("H", BASE_H), ("K", BASE_K), ("D", BASE_D), ("B", BASE_B),
    ("N", BASE_N),
]:
    ASCII_TO_MELT[ord(_ch)] = _code
    ASCII_TO_MELT[ord(_ch.lower())] = _code

# ascii oligo char -> melt-engine code of the complement
ASCII_TO_MELT_COMPLEMENT = np.full(256, 255, dtype=np.uint8)
for _ch, _code in [
    ("A", BASE_T), ("C", BASE_G), ("G", BASE_C), ("T", BASE_A), ("I", BASE_I),
    ("M", BASE_K), ("R", BASE_Y), ("S", BASE_S), ("V", BASE_B), ("W", BASE_W),
    ("Y", BASE_R), ("H", BASE_D), ("K", BASE_M), ("D", BASE_H), ("B", BASE_V),
    ("N", BASE_N),
]:
    ASCII_TO_MELT_COMPLEMENT[ord(_ch)] = _code
    ASCII_TO_MELT_COMPLEMENT[ord(_ch.lower())] = _code
