# Copy of tntblast_tpu/search/assays.py with the package name changed.
"""Assay-level search: PCR/TaqMan pairing, hybridization probes, padlock
ligation (reference: amplicon_search.cpp, probe_search.cpp,
padlock_search.cpp)."""

import numpy as np

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.model import Assay, PLUS, MINUS
from tntblast_tpu_torch.search.bind import (
    F, R, P, PLUS_STRAND, MINUS_STRAND, VALID,
    OligoInfo, match_oligo, bind_oligo)
from tntblast_tpu_torch.utils.listsort import list_sort

STRAND_INFO = PLUS_STRAND | MINUS_STRAND


def oligo_loc_less(a, b):
    """sort_by_oligo_loc (reference amplicon_search.cpp:12-26): unbound
    entries (loc_5+loc_3 == 0) compare by seed target position."""
    if (a.loc_5 + a.loc_3) == 0 or (b.loc_5 + b.loc_3) == 0:
        return a.target_loc < b.target_loc
    if a.loc_5 == b.loc_5:
        return a.loc_3 < b.loc_3
    return a.loc_5 < b.loc_5


def cull_oligo_match(match_list, max_amplicon_len, has_probe, single_primer_pcr):
    """Prune seeds that cannot participate in any (F..R[, probe]) pairing
    (reference amplicon_search.cpp:679-765).  Returns the culled list and
    the (minus, plus) strand counts with the reference's one-ahead counting.
    """
    threshold = max_amplicon_len + 50
    items = list_sort(match_list, oligo_loc_less)
    for e in items:
        e.mask &= ~VALID

    n = len(items)
    for fi in range(n):
        f = items[fi]
        if f.mask & (PLUS_STRAND | P):
            continue
        for ri in range(fi + 1, n):
            r = items[ri]
            # unsigned arithmetic in the reference: a negative difference
            # wraps to a huge value and breaks the scan
            diff = (r.target_loc - f.target_loc) & 0xFFFFFFFF
            if diff > threshold:
                break
            if r.mask & (MINUS_STRAND | P):
                continue
            if (not single_primer_pcr
                    and (f.mask & (R | F)) == (r.mask & (R | F))):
                continue
            if has_probe:
                for pi in range(fi + 1, ri):
                    p = items[pi]
                    if p.mask & P:
                        p.mask |= VALID
                        f.mask |= VALID
                        r.mask |= VALID
            else:
                f.mask |= VALID
                r.mask |= VALID

    kept = [e for e in items if e.mask & VALID]
    # Strand counting replicates the reference's post-increment read: for
    # each kept element the *next* element's strand is counted (the final
    # sentinel read is skipped here).
    n_minus = n_plus = 0
    for i in range(len(kept)):
        if i + 1 < len(kept):
            nxt = kept[i + 1]
            n_minus += 1 if (nxt.mask & MINUS_STRAND) else 0
            n_plus += 1 if (nxt.mask & PLUS_STRAND) else 0
    return kept, (n_minus, n_plus)


def _extract_amplicon(seq_codes, amp_start, amp_stop, plus_strand):
    """Amplicon bases in forward-primer orientation (reference
    amplicon_search.cpp:506-537)."""
    amp_len = amp_stop - amp_start + 1
    out = np.full(amp_len, ord("-"), dtype=np.uint8)
    n = len(seq_codes)
    if plus_strand:
        i0 = max(0, -amp_start)
        src = seq_codes[max(0, amp_start):max(0, amp_start) + (amp_len - i0)]
        src = src[:max(0, n - max(0, amp_start))]
        out[i0:i0 + len(src)] = C.DB_TO_ASCII[src]
    else:
        start_ptr = min(amp_stop, n - 1)
        i0 = max(0, amp_stop - n + 1)
        m = min(amp_len - i0, start_ptr + 1)
        src = seq_codes[start_ptr - m + 1:start_ptr + 1][::-1]
        out[i0:i0 + len(src)] = C.DB_TO_ASCII_COMPLEMENT[src]
    return out.tobytes().decode("latin1")


def amplicon(ctx, sig: Assay, opt):
    """PCR / TaqMan search over one fragment (reference
    amplicon_search.cpp:58-677)."""
    apply_mmc = opt.min_max_primer_clamp >= 0
    fconc = opt.forward_primer_strand / sig.forward_degen
    rconc = opt.reverse_primer_strand / sig.reverse_degen
    pconc = opt.probe_strand / sig.probe_degen

    sig_list = []
    match_list = []

    primer_filt = dict(min_tm=opt.min_primer_tm, max_tm=opt.max_primer_tm,
                       min_dg=opt.min_primer_dg, max_dg=opt.max_primer_dg,
                       clamp_5=0, clamp_3=opt.primer_clamp,
                       max_mm=opt.max_mismatch, max_gap=opt.max_gap,
                       max_poly_degen=opt.max_poly_degen)
    probe_filt = dict(min_tm=opt.min_probe_tm, max_tm=opt.max_probe_tm,
                      min_dg=opt.min_probe_dg, max_dg=opt.max_probe_dg,
                      clamp_5=opt.probe_clamp_5, clamp_3=opt.probe_clamp_3,
                      max_mm=opt.max_mismatch, max_gap=opt.max_gap,
                      max_poly_degen=opt.max_poly_degen)

    match_oligo(match_list, ctx, sig.forward_oligo, F, True,
                primer_filt, fconc)
    match_oligo(match_list, ctx, sig.reverse_oligo, R, True,
                primer_filt, rconc)
    num_minus = len(match_list)
    if num_minus == 0:
        return sig_list
    match_oligo(match_list, ctx, sig.forward_oligo, F, False,
                primer_filt, fconc)
    match_oligo(match_list, ctx, sig.reverse_oligo, R, False,
                primer_filt, rconc)
    if len(match_list) == num_minus:
        return sig_list
    num_plus = len(match_list)
    if sig.has_probe():
        match_oligo(match_list, ctx, sig.probe_oligo, P, True,
                    probe_filt, pconc)
        match_oligo(match_list, ctx, sig.probe_oligo, P, False,
                    probe_filt, pconc)
        if len(match_list) == num_plus:
            return sig_list

    match_list, strand_count = cull_oligo_match(
        match_list, opt.max_len, sig.has_probe(), opt.single_primer_pcr)

    def bind(oligo, mask, conc, minus):
        nonlocal match_list
        match_list = bind_oligo(ctx, match_list, oligo, minus, conc,
                                primer_filt, oligo_mask=mask)

    if strand_count[0] < strand_count[1]:   # fewer minus than plus
        order = [(sig.forward_oligo, F, fconc, True),
                 (sig.reverse_oligo, R, rconc, True),
                 (sig.forward_oligo, F, fconc, False),
                 (sig.reverse_oligo, R, rconc, False)]
    else:
        order = [(sig.forward_oligo, F, fconc, False),
                 (sig.reverse_oligo, R, rconc, False),
                 (sig.forward_oligo, F, fconc, True),
                 (sig.reverse_oligo, R, rconc, True)]

    for i, (oligo, mask, conc, minus) in enumerate(order):
        bind(oligo, mask, conc, minus)
        if i < 3:
            match_list, _ = cull_oligo_match(
                match_list, opt.max_len, sig.has_probe(), opt.single_primer_pcr)
            if not match_list:
                return sig_list

    if sig.has_probe():
        match_list, _ = cull_oligo_match(
            match_list, opt.max_len, sig.has_probe(), opt.single_primer_pcr)
        if not match_list:
            return sig_list
        match_list = bind_oligo(ctx, match_list, sig.probe_oligo, True, pconc,
                                probe_filt, oligo_mask=P)
        match_list = bind_oligo(ctx, match_list, sig.probe_oligo, False, pconc,
                                probe_filt, oligo_mask=P)

    match_list = list_sort(match_list, oligo_loc_less)

    n = len(match_list)
    for fi in range(n):
        f = match_list[fi]
        if f.mask & (PLUS_STRAND | P):
            continue
        for ri in range(fi + 1, n):
            r = match_list[ri]
            if r.mask & (MINUS_STRAND | P):
                continue
            if (not opt.single_primer_pcr
                    and (f.mask & (R | F)) == (r.mask & (R | F))):
                continue
            if f.loc_3 >= r.loc_5:
                continue
            if (r.loc_3 - f.loc_5 + 1) > opt.max_len:
                continue
            if (apply_mmc
                    and max(f.anchor_3, r.anchor_3) <= opt.min_max_primer_clamp):
                continue

            if sig.has_probe():
                for pi in range(fi + 1, ri):
                    p = match_list[pi]
                    if not (p.mask & P):
                        continue
                    amp_start, amp_stop = f.loc_5, r.loc_3
                    if not (p.loc_5 >= amp_start and p.loc_3 <= amp_stop):
                        continue
                    # TaqMan hydrolysis: probe must not overlap the primer
                    # bound to its own strand
                    if (p.mask & STRAND_INFO) == (f.mask & STRAND_INFO):
                        if p.loc_5 <= f.loc_3:
                            continue
                    else:
                        if p.loc_3 >= r.loc_5:
                            continue
                    tmp = _build_hit(ctx, sig, opt, f, r)
                    tmp.probe_range = (p.loc_5, p.loc_3)
                    tmp.probe_tm = p.tm
                    tmp.probe_dH = p.dH
                    tmp.probe_dS = p.dS
                    tmp.probe_mm = p.num_mm
                    tmp.probe_gap = p.num_gap
                    tmp.probe_strand = PLUS if (p.mask & PLUS_STRAND) else MINUS
                    tmp.probe_align = p.alignment
                    sig_list.append(tmp)
            else:
                sig_list.append(_build_hit(ctx, sig, opt, f, r))
    return sig_list


def _build_hit(ctx, sig, opt, f, r):
    amp_start, amp_stop = f.loc_5, r.loc_3
    tmp = sig.copy()
    if (f.mask & R) and (r.mask & R):
        tmp.forward_oligo = sig.reverse_oligo
    if (f.mask & F) and (r.mask & F):
        tmp.reverse_oligo = sig.forward_oligo
    tmp.primer_strand = PLUS if (f.mask & F) else MINUS
    tmp.amplicon_def = ctx.defline
    tmp.amplicon_range = (amp_start, amp_stop)

    fo, ro = f, r
    if (f.mask & R) and (r.mask & F):
        fo, ro = r, f
    tmp.forward_tm, tmp.reverse_tm = fo.tm, ro.tm
    tmp.forward_dH, tmp.reverse_dH = fo.dH, ro.dH
    tmp.forward_dS, tmp.reverse_dS = fo.dS, ro.dS
    tmp.forward_mm, tmp.reverse_mm = fo.num_mm, ro.num_mm
    tmp.forward_gap, tmp.reverse_gap = fo.num_gap, ro.num_gap
    tmp.forward_primer_clamp = fo.anchor_3
    tmp.reverse_primer_clamp = ro.anchor_3
    tmp.forward_align = fo.alignment
    tmp.reverse_align = ro.alignment

    tmp.amplicon = _extract_amplicon(
        ctx.seq, amp_start, amp_stop, tmp.primer_strand == PLUS)
    if opt.mask_options != C.NO_MASK:
        from tntblast_tpu_torch.search.mask import mask_binding_sites
        tmp.amplicon = mask_binding_sites(ctx, tmp, opt)
    return tmp


# ---------------------------------------------------------------------------

def hybrid(ctx, sig: Assay, opt):
    """Single-probe hybridization search (reference probe_search.cpp:67-230)."""
    pconc = opt.probe_strand / sig.probe_degen
    filt = dict(min_tm=opt.min_probe_tm, max_tm=opt.max_probe_tm,
                min_dg=opt.min_probe_dg, max_dg=opt.max_probe_dg,
                clamp_5=opt.probe_clamp_5, clamp_3=opt.probe_clamp_3,
                max_mm=opt.max_mismatch, max_gap=opt.max_gap,
                max_poly_degen=opt.max_poly_degen)
    sig_list = []
    n = len(ctx.seq)

    for minus in (True, False):
        if minus and not (opt.target_strand & C.SEQ_STRAND_MINUS):
            continue
        if not minus and not (opt.target_strand & C.SEQ_STRAND_PLUS):
            continue
        # the reference uses a throwaway cache for probe binding
        bind = bind_oligo(ctx, [], sig.probe_oligo, minus, pconc, filt,
                          oligo_mask=None, use_cache=False)
        for e in bind:
            tmp = sig.copy()
            probe_start, probe_stop = e.loc_5, e.loc_3
            probe_len = probe_stop - probe_start + 1
            tmp.probe_tm = e.tm
            tmp.probe_dH = e.dH
            tmp.probe_dS = e.dS
            tmp.probe_mm = e.num_mm
            tmp.probe_gap = e.num_gap
            tmp.probe_range = (probe_start, probe_stop)
            tmp.amplicon_def = ctx.defline
            tmp.probe_strand = MINUS if minus else PLUS
            tmp.probe_align = e.alignment

            out = np.full(probe_len, ord("-"), dtype=np.uint8)
            if minus:
                ptr = min(probe_stop, n - 1)
                m = min(probe_len, ptr + 1)
                src = ctx.seq[ptr - m + 1:ptr + 1][::-1]
                out[:len(src)] = C.DB_TO_ASCII_COMPLEMENT[src]
            else:
                ptr = max(0, probe_start)
                src = ctx.seq[ptr:ptr + probe_len]
                out[:len(src)] = C.DB_TO_ASCII[src]
            tmp.amplicon = out.tobytes().decode("latin1")
            sig_list.append(tmp)
    return sig_list


# ---------------------------------------------------------------------------

def padlock(ctx, sig: Assay, opt, max_len):
    """Padlock/MOL-PCR/MIPS ligation search (reference
    padlock_search.cpp:62-361): the two probe arms bind adjacently on the
    same strand; gap in [0, max_len]."""
    fconc = opt.forward_primer_strand / sig.forward_degen
    rconc = opt.reverse_primer_strand / sig.reverse_degen

    up_filt = dict(min_tm=opt.min_probe_tm, max_tm=opt.max_probe_tm,
                   min_dg=opt.min_probe_dg, max_dg=opt.max_probe_dg,
                   clamp_5=opt.probe_clamp_5, clamp_3=0,
                   max_mm=opt.max_mismatch, max_gap=opt.max_gap,
                   max_poly_degen=opt.max_poly_degen)
    down_filt = dict(up_filt, clamp_5=0, clamp_3=opt.probe_clamp_3)

    sig_list = []
    n = len(ctx.seq)

    for minus in (True, False):
        if minus and not (opt.target_strand & C.SEQ_STRAND_MINUS):
            continue
        if not minus and not (opt.target_strand & C.SEQ_STRAND_PLUS):
            continue
        upstream = bind_oligo(ctx, [], sig.reverse_oligo, minus, rconc,
                              up_filt, oligo_mask=None)
        downstream = bind_oligo(ctx, [], sig.forward_oligo, minus, fconc,
                                down_filt, oligo_mask=None)
        for up in upstream:
            for down in downstream:
                if minus:
                    gap = up.loc_5 - down.loc_3 - 1
                else:
                    gap = down.loc_5 - up.loc_3 - 1
                if not (0 <= gap <= max_len):
                    continue
                if minus:
                    start, stop = down.loc_5, up.loc_3
                else:
                    start, stop = up.loc_5, down.loc_3
                prod_len = stop - start + 1
                tmp = sig.copy()
                tmp.primer_strand = MINUS if minus else PLUS
                tmp.amplicon_def = ctx.defline
                tmp.amplicon_range = (start, stop)
                tmp.forward_tm, tmp.reverse_tm = down.tm, up.tm
                tmp.forward_dH, tmp.reverse_dH = down.dH, up.dH
                tmp.forward_dS, tmp.reverse_dS = down.dS, up.dS
                tmp.forward_mm, tmp.reverse_mm = down.num_mm, up.num_mm
                tmp.forward_gap, tmp.reverse_gap = down.num_gap, up.num_gap
                tmp.forward_align = down.alignment
                tmp.reverse_align = up.alignment
                tmp.forward_primer_clamp = down.anchor_3
                tmp.reverse_primer_clamp = up.anchor_5

                out = np.full(prod_len, ord("-"), dtype=np.uint8)
                if minus:
                    ptr = max(0, start)
                    i0 = max(0, 1 - start)
                    src = ctx.seq[ptr:ptr + prod_len - i0]
                    out[i0:i0 + len(src)] = C.DB_TO_ASCII[src]
                else:
                    ptr = min(stop, n - 1)
                    i0 = max(0, stop - n - 1)
                    m = min(prod_len - i0, ptr + 1)
                    src = ctx.seq[ptr - m + 1:ptr + 1][::-1]
                    out[i0:i0 + len(src)] = C.DB_TO_ASCII_COMPLEMENT[src]
                tmp.amplicon = out.tobytes().decode("latin1")
                sig_list.append(tmp)
    return sig_list
