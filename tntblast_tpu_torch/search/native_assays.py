# Copy of tntblast_tpu/search/native_assays.py with the package name changed.
"""Native fragment-search front end: converts frag_search.cpp hit records
into hybrid_sig results, byte-identically to the Python search layer
(search/assays.py) and therefore to the reference
(amplicon_search.cpp / probe_search.cpp / padlock_search.cpp)."""

import numpy as np

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import native
from tntblast_tpu_torch.model import PLUS, MINUS
from tntblast_tpu_torch.search.assays import _extract_amplicon


class NativeFragContext:
    """Per-fragment search state backed by the native engine; mirrors
    BindContext + MeltCaches scope (caches live for one fragment and are
    shared across the assay loop — reference tntblast_local.cpp:345-376)."""

    def __init__(self, engine, seq_codes, word_len, defline="",
                 panel_result=None):
        self.engine = engine
        self.seq = seq_codes
        self.defline = defline
        self.frag = engine.frag_search(seq_codes, word_len)
        if panel_result:
            # Inject the device-computed, pre-screened seed lists
            # (parallel/panel.py): the native search skips both host
            # seeding and the exact evaluation of screened-out windows
            # for every slot present.  Trusted gapless evaluations ride
            # along (tnt_frag_set_evals): seeds whose windows PROVABLY
            # fail the slot's full filter cascade are dropped from the
            # injected list before the search ever builds match lists -
            # the same soundness argument as the screen, now applied
            # with the device's bit-exact evaluation.
            for key, (q, t, n_screened, ev) in panel_result.items():
                oligo, minus, f9, conc = key
                codes = _codes(oligo)
                self.frag.set_seeds(codes, minus, f9[0], f9[3],
                                    conc, q, t, n_screened)
                if ev is not None and len(q):
                    self.frag.set_evals(codes, minus, f9, conc, q, t, ev)

    def close(self):
        self.frag.close()


def _codes(oligo):
    return C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), dtype=np.uint8)]


def search_assay(ctx, sig, opt):
    """Run one assay over the fragment; returns the hit list in reference
    order (drop-in for assays.amplicon / .hybrid / .padlock)."""
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

    if sig.has_primers():
        fconc = opt.forward_primer_strand / sig.forward_degen
        rconc = opt.reverse_primer_strand / sig.reverse_degen
        f_codes = _codes(sig.forward_oligo)
        r_codes = _codes(sig.reverse_oligo)
    else:
        fconc = rconc = 0.0
        f_codes = r_codes = None
    if sig.has_probe():
        pconc = opt.probe_strand / sig.probe_degen
        p_codes = _codes(sig.probe_oligo)
    else:
        pconc = 0.0
        p_codes = None

    if sig.has_primers():
        if opt.assay_format == C.ASSAY_PCR:
            fmt, max_len = 0, opt.max_len
        elif opt.assay_format == C.ASSAY_PADLOCK:
            fmt, max_len = 2, 0
        elif opt.assay_format == C.ASSAY_MIPS:
            fmt, max_len = 3, opt.max_len
        else:
            return []
        if fmt != 0:
            p_codes = None  # padlock search uses only the two arms
    elif sig.has_probe():
        fmt, max_len = 1, opt.max_len
    else:
        return []

    res = ctx.frag.search(
        fmt, f_codes, r_codes, p_codes, fconc, rconc, pconc,
        primer_filt, probe_filt, max_len,
        opt.single_primer_pcr, opt.min_max_primer_clamp, opt.target_strand)
    if res is None:
        return []
    ints, floats, aligns = res

    out = []
    n = len(ints)
    seq = ctx.seq
    nseq = len(seq)
    for k in range(n):
        (flags, amp_start, amp_stop, p_start, p_stop,
         f_mm, f_gap, f_clamp, r_mm, r_gap, r_clamp, p_mm, p_gap) = (
            int(v) for v in ints[k])
        (f_tm, f_dH, f_dS, r_tm, r_dH, r_dS, p_tm, p_dH, p_dS) = (
            float(v) for v in floats[k])
        f_align, r_align, p_align = aligns[3 * k:3 * k + 3]

        tmp = sig.copy()
        tmp.amplicon_def = ctx.defline

        if flags & native.HF_HAS_PRIMERS:
            if flags & native.HF_SWAP_F:
                tmp.forward_oligo = sig.reverse_oligo
            if flags & native.HF_SWAP_R:
                tmp.reverse_oligo = sig.forward_oligo
            plus = bool(flags & native.HF_PRIMER_PLUS)
            tmp.primer_strand = PLUS if plus else MINUS
            tmp.amplicon_range = (amp_start, amp_stop)
            tmp.forward_tm, tmp.reverse_tm = f_tm, r_tm
            tmp.forward_dH, tmp.reverse_dH = f_dH, r_dH
            tmp.forward_dS, tmp.reverse_dS = f_dS, r_dS
            tmp.forward_mm, tmp.reverse_mm = f_mm, r_mm
            tmp.forward_gap, tmp.reverse_gap = f_gap, r_gap
            tmp.forward_primer_clamp = f_clamp
            tmp.reverse_primer_clamp = r_clamp
            tmp.forward_align, tmp.reverse_align = f_align, r_align

            if fmt == 0:
                # PCR/TaqMan amplicon (search/assays.py _build_hit)
                tmp.amplicon = _extract_amplicon(
                    seq, amp_start, amp_stop, plus)
                if opt.mask_options != C.NO_MASK:
                    from tntblast_tpu_torch.search.mask import mask_binding_sites
                    tmp.amplicon = mask_binding_sites(ctx, tmp, opt)
            else:
                # padlock product (search/assays.py padlock:369-381);
                # note the swapped strand sense vs PCR
                minus = not plus
                prod_len = amp_stop - amp_start + 1
                buf = np.full(prod_len, ord("-"), dtype=np.uint8)
                if minus:
                    ptr = max(0, amp_start)
                    i0 = max(0, 1 - amp_start)
                    src = seq[ptr:ptr + prod_len - i0]
                    buf[i0:i0 + len(src)] = C.DB_TO_ASCII[src]
                else:
                    ptr = min(amp_stop, nseq - 1)
                    i0 = max(0, amp_stop - nseq - 1)
                    m = min(prod_len - i0, ptr + 1)
                    src = seq[ptr - m + 1:ptr + 1][::-1]
                    buf[i0:i0 + len(src)] = C.DB_TO_ASCII_COMPLEMENT[src]
                tmp.amplicon = buf.tobytes().decode("latin1")

        if flags & native.HF_HAS_PROBE:
            tmp.probe_range = (p_start, p_stop)
            tmp.probe_tm = p_tm
            tmp.probe_dH = p_dH
            tmp.probe_dS = p_dS
            tmp.probe_mm = p_mm
            tmp.probe_gap = p_gap
            tmp.probe_strand = (PLUS if (flags & native.HF_PROBE_PLUS)
                                else MINUS)
            tmp.probe_align = p_align

            if not (flags & native.HF_HAS_PRIMERS):
                # hybridization probe site (search/assays.py hybrid:299-309)
                probe_len = p_stop - p_start + 1
                buf = np.full(probe_len, ord("-"), dtype=np.uint8)
                if tmp.probe_strand == MINUS:
                    ptr = min(p_stop, nseq - 1)
                    m = min(probe_len, ptr + 1)
                    src = seq[ptr - m + 1:ptr + 1][::-1]
                    buf[:len(src)] = C.DB_TO_ASCII_COMPLEMENT[src]
                else:
                    ptr = max(0, p_start)
                    src = seq[ptr:ptr + probe_len]
                    buf[:len(src)] = C.DB_TO_ASCII[src]
                tmp.amplicon = buf.tobytes().decode("latin1")

        out.append(tmp)
    return out
