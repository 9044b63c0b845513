# Copy of tntblast_tpu/heuristics.py with the package name changed.
"""PCR primer design-rule heuristics and %GC.

Mirrors the reference rule engine (reference: primer.cpp:44-328, primer.h:76-96,
tntblast_util.cpp:917-925, :1274-1295).  Output-path only: the search itself
never consults these rules; they are reported per hit.
"""

# Rule bit flags (reference primer.h:70-86)
BAD_BASE = -1
PCR_VALID = 0
POLY_3_GC = 1
MULTI_5_GC = 1 << 1
NO_POLY_RUNS = 1 << 2
NO_3_T = 1 << 3
GC_CONTENT = 1 << 4
NO_5_G = 1 << 5
NO_5_G_3_C = 1 << 6
NO_IDENTICAL_RUNS = 1 << 7
NO_5_PENULTIMATE_G = 1 << 8
NO_3_POLY_G = 1 << 9
NO_MIDDLE_CC = 1 << 10

MIDDLE_LOWER_BOUND = 0.25
MIDDLE_UPPER_BOUND = 0.75

_ERROR_ORDER = [
    (POLY_3_GC, "POLY_3_GC"), (MULTI_5_GC, "MULTI_5_GC"),
    (NO_POLY_RUNS, "NO_POLY_RUNS"), (NO_3_T, "NO_3_T"),
    (GC_CONTENT, "GC_CONTENT"), (NO_5_G, "NO_5_G"),
    (NO_5_G_3_C, "NO_5_G_3_C"), (NO_IDENTICAL_RUNS, "NO_IDENTICAL_RUNS"),
    (NO_5_PENULTIMATE_G, "NO_5_PENULTIMATE_G"), (NO_3_POLY_G, "NO_3_POLY_G"),
    (NO_MIDDLE_CC, "NO_MIDDLE_CC"),
]


def pcr_primer_status(primer, mask, run_len=5, gc_min=0.0, gc_max=1.0):
    """Verbose-mode rule evaluation (reference primer.cpp:44-328 with
    report_verbose=true): accumulate every violated rule bit."""
    seq = []
    for ch in primer:
        c = ch.upper()
        if c not in "ATGC":
            return BAD_BASE
        seq.append(c)
    if not seq:
        raise ValueError("Empty primer buffer")

    status = PCR_VALID
    n = len(seq)

    if (mask & NO_3_T) and seq[-1] == "T":
        status |= NO_3_T
    if (mask & NO_5_G) and seq[0] == "G":
        status |= NO_5_G
    if (mask & NO_5_G_3_C) and seq[0] == "G" and seq[-1] == "C":
        status |= NO_5_G_3_C
    if mask & NO_3_POLY_G:
        if n >= 3 and seq[-1] == "G" and seq[-2] == "G" and seq[-3] == "G":
            status |= NO_3_POLY_G
        if (n >= 4 and seq[-1] == "G" and seq[-2] == "A" and seq[-3] == "G"
                and seq[-4] == "G"):
            status |= NO_3_POLY_G

    TC_run = AG_run = G_run = C_run = A_run = T_run = 0
    max_TC_run = max_AG_run = num_GC = 0
    lower_middle = int(n * MIDDLE_LOWER_BOUND)
    upper_middle = int(n * MIDDLE_UPPER_BOUND)

    for index, b in enumerate(seq):
        if b == "A":
            AG_run += 1; A_run += 1
            TC_run = T_run = G_run = C_run = 0
        elif b == "T":
            TC_run += 1; T_run += 1
            AG_run = G_run = C_run = A_run = 0
        elif b == "G":
            AG_run += 1; G_run += 1
            TC_run = C_run = A_run = T_run = 0
            num_GC += 1
        else:  # C
            TC_run += 1; C_run += 1
            AG_run = G_run = A_run = T_run = 0
            num_GC += 1

        max_TC_run = max(max_TC_run, TC_run)
        max_AG_run = max(max_AG_run, AG_run)

        if mask & NO_IDENTICAL_RUNS:
            if (A_run >= run_len or T_run >= run_len or G_run >= run_len
                    or C_run >= run_len):
                status |= NO_IDENTICAL_RUNS
        if index == 4 and (mask & MULTI_5_GC):
            if max_TC_run >= 2:
                if num_GC > 2:
                    status |= MULTI_5_GC
            else:
                if num_GC > 3:
                    status |= MULTI_5_GC
        if index == 1 and (mask & NO_5_PENULTIMATE_G) and b == "G":
            status |= NO_5_PENULTIMATE_G
        if ((mask & NO_MIDDLE_CC) and lower_middle < index <= upper_middle
                and C_run >= 2):
            status |= NO_MIDDLE_CC

    if mask & NO_POLY_RUNS:
        if max_TC_run >= run_len or max_AG_run >= run_len:
            status |= NO_POLY_RUNS
    if mask & POLY_3_GC:
        if C_run >= 3 or G_run >= 3:
            status |= POLY_3_GC
    if mask & GC_CONTENT:
        gc = float(num_GC) / n
        if gc < gc_min or gc > gc_max:
            status |= GC_CONTENT

    return status


def heuristic_error_string(code):
    """reference primer.cpp:406-514."""
    if code == PCR_VALID:
        return "PCR_VALID"
    if code == BAD_BASE:
        return "BAD_BASE"
    return ", ".join(name for bit, name in _ERROR_ORDER if code & bit)


def primer_heuristics(primer):
    """reference tntblast_util.cpp:917-925: fixed 4-rule mask, run length 5."""
    return heuristic_error_string(pcr_primer_status(
        primer, POLY_3_GC | MULTI_5_GC | NO_POLY_RUNS | NO_3_T, run_len=5))


def gc_content(seq):
    """Fraction of G/C bases (reference tntblast_util.cpp:1274-1295)."""
    if not seq:
        raise ValueError("gc_content: empty sequence!")
    gc = sum(1 for c in seq if c in "GgCc")
    return gc / len(seq)
