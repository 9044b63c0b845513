# Copy of tntblast_tpu/search/mask.py with the package name changed.
"""Amplicon binding-site masking / primer replacement (-k/-K/-r options).

Mirrors the reference masking pass (reference: tntblast_util.cpp:97-576):
after a hit's amplicon is extracted, the oligos are re-located in the
amplicon text by fresh melt evaluations and the bound ranges are lowercased
(mask) or overwritten with the oligo sequence (replace).

Note the reference's asymmetric base mapping is replicated exactly: the 5'
pass loads the complement of every base, while the 3'/probe passes load
plain A/T/G/C/I but the *complement* of IUPAC degenerate codes
(tntblast_util.cpp:282-339, :408-462 — a long-standing quirk of the
original code that is part of the output contract).
"""

import numpy as np

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import native

# amplicon char -> melt code, complementing every base (5' pass)
_COMP_ALL = {
    "A": C.BASE_T, "T": C.BASE_A, "G": C.BASE_C, "C": C.BASE_G,
    "I": C.BASE_I, "M": C.BASE_K, "R": C.BASE_Y, "S": C.BASE_S,
    "V": C.BASE_B, "W": C.BASE_W, "Y": C.BASE_R, "H": C.BASE_D,
    "K": C.BASE_M, "D": C.BASE_H, "B": C.BASE_V, "N": C.BASE_N,
}

# amplicon char -> melt code, plain ATGCI but complemented degenerates
# (3' and probe plus-strand passes; reference quirk)
_PLAIN_QUIRK = {
    "A": C.BASE_A, "T": C.BASE_T, "G": C.BASE_G, "C": C.BASE_C,
    "I": C.BASE_I, "M": C.BASE_K, "R": C.BASE_Y, "S": C.BASE_S,
    "V": C.BASE_B, "W": C.BASE_W, "Y": C.BASE_R, "H": C.BASE_D,
    "K": C.BASE_M, "D": C.BASE_H, "B": C.BASE_V, "N": C.BASE_N,
}

_BASE_COMPLEMENT = {"A": "T", "T": "A", "G": "C", "C": "G"}


def _oligo_codes(oligo):
    return C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), dtype=np.uint8)]


def _eval_one(engine, oligo, target_codes, conc):
    out = engine.eval_batch(
        native.HETERO, [_oligo_codes(oligo)],
        [np.asarray(target_codes, dtype=np.uint8)],
        np.array([conc], dtype=np.float32))
    return out


def mask_primer_5(amp, oligo, engine, conc, do_mask, do_replace):
    """reference tntblast_util.cpp:139-256."""
    if not do_mask and not do_replace:
        return amp
    length = len(amp)
    oligo_len = len(oligo)

    target = []  # built via push_front: prepend complement of each base
    gap_offset = 0
    for ch in amp[:oligo_len]:
        c = ch.upper()
        if c == "-":
            gap_offset += 1
        elif c in _COMP_ALL:
            target.insert(0, _COMP_ALL[c])
        else:
            break
    target_len = len(target)
    if target_len == 0:
        return amp
    out = _eval_one(engine, oligo, target, conc)
    if not out["valid"][0]:
        return amp
    r0, r1 = int(out["t_range"][0][0]), int(out["t_range"][0][1])
    hi = gap_offset + target_len - r0 - 1
    lo = gap_offset + target_len - r1 - 1

    if do_replace:
        amp = oligo + amp[hi + 1:]
        if do_mask:
            amp = amp[:oligo_len].lower() + amp[oligo_len:]
    elif do_mask:
        amp = amp[:lo] + amp[lo:hi + 1].lower() + amp[hi + 1:]
    return amp


def mask_primer_3(amp, oligo, engine, conc, do_mask, do_replace):
    """reference tntblast_util.cpp:258-388."""
    if not do_mask and not do_replace:
        return amp
    length = len(amp)
    oligo_len = len(oligo)

    target = []
    gap_offset = 0
    for ch in amp[length - oligo_len:]:
        c = ch.upper()
        if c == "-":
            gap_offset += 1
        elif c in _PLAIN_QUIRK:
            target.append(_PLAIN_QUIRK[c])
        else:
            target = []
    target_len = len(target)
    if target_len == 0:
        return amp
    out = _eval_one(engine, oligo, target, conc)
    if not out["valid"][0]:
        return amp
    r0 = int(out["t_range"][0][0]) - gap_offset
    r1 = int(out["t_range"][0][1]) - gap_offset

    if do_replace:
        oligo_complement = "".join(
            _BASE_COMPLEMENT.get(c.upper(), "N") for c in reversed(oligo))
        amp = amp[:length - target_len + r0] + oligo_complement
        if do_mask:
            new_len = len(amp)
            amp = amp[:new_len - oligo_len] + amp[new_len - oligo_len:].lower()
    elif do_mask:
        lo = length - target_len + r0
        hi = (length + r1 + 1) - target_len
        amp = amp[:lo] + amp[lo:hi].lower() + amp[hi:]
    return amp


def mask_probe(amp, oligo, engine, conc, min_tm):
    """reference tntblast_util.cpp:391-576: slide a (oligo_len+2)-wide
    window across both strands of the amplicon, masking every position
    where the probe melts at >= min_tm."""
    length = len(amp)
    padded = len(oligo) + 2
    chars = list(amp)

    def run_pass(plus):
        nonlocal chars
        # Precompute the window contents at every position (they depend only
        # on the pass-start amplicon text), then evaluate as one batch.
        windows = []
        target = []
        for i in range(length):
            c = chars[i].upper()
            table = _PLAIN_QUIRK if plus else _COMP_ALL
            if c in table:
                if plus:
                    target.append(table[c])
                else:
                    target.insert(0, table[c])
            else:
                target = []
            windows.append(list(target))
            if len(target) == padded:
                if plus:
                    target.pop(0)
                else:
                    target.pop()

        idx = [i for i, w in enumerate(windows) if w]
        if not idx:
            return
        out = engine.eval_batch(
            native.HETERO, [_oligo_codes(oligo)] * len(idx),
            [np.asarray(windows[i], dtype=np.uint8) for i in idx],
            np.full(len(idx), conc, dtype=np.float32))
        for k, i in enumerate(idx):
            tm = float(out["tm"][k])
            if tm < min_tm or not out["valid"][k]:
                continue
            r0, r1 = int(out["t_range"][k][0]), int(out["t_range"][k][1])
            tlen = len(windows[i])
            if plus:
                lo = r0 + (i - (tlen - 1))
                hi = r1 + (i - (tlen - 1))
            else:
                hi = i - r0
                lo = i - r1
            for j in range(max(lo, 0), min(hi, length - 1) + 1):
                chars[j] = chars[j].lower()

    run_pass(plus=True)
    run_pass(plus=False)
    return "".join(chars)


def mask_binding_sites(ctx, sig, opt):
    """reference tntblast_util.cpp:97-137.  Returns the (possibly
    re-written) amplicon string for one hit."""
    amp = sig.amplicon
    mask = opt.mask_options
    if mask == C.NO_MASK:
        return amp
    engine = ctx.engine
    if sig.has_primers():
        amp = mask_primer_5(
            amp, sig.forward_oligo, engine,
            opt.forward_primer_strand,
            bool(mask & C.MASK_PRIMERS), bool(mask & C.REPLACE_PRIMERS))
        amp = mask_primer_3(
            amp, sig.reverse_oligo, engine,
            opt.reverse_primer_strand,
            bool(mask & C.MASK_PRIMERS), bool(mask & C.REPLACE_PRIMERS))
    if (mask & C.MASK_PROBE) and sig.has_probe():
        amp = mask_probe(amp, sig.probe_oligo, engine,
                         opt.probe_strand, opt.min_probe_tm)
    return amp
