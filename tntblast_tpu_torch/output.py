# Copy of tntblast_tpu/output.py with the package name changed.
"""Result formatting — byte-identical to the reference output pipeline
(reference: tntblast_local.cpp:877-1372, options.cpp:943-1033,
tntblast_util.cpp:1244-1335)."""

import sys

import numpy as np

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.heuristics import gc_content, primer_heuristics
from tntblast_tpu_torch.model import hit_less
from tntblast_tpu_torch.search.dedup import select_best_match, uniquify_results
from tntblast_tpu_torch.utils.cppio import cpp
from tntblast_tpu_torch.utils.listsort import list_sort

RULE = "#" * 85

f32 = np.float32


def echo_options(opt, stream):
    """operator<<(ostream, Options) (reference options.cpp:943-1033)."""
    w = stream.write
    w(f"Found {len(opt.sig_list)} query assays\n")
    w("Search parameters:\n")
    w(f"\tOutput = {opt.output_filename}\n")
    w(f"\t[Na+] = {cpp(opt.salt)} M\n")
    w(f"\tmax gap = {opt.max_gap}\n")
    w(f"\tmax mismatch = {opt.max_mismatch}\n")
    if opt.has_primers():
        if opt.asymmetric_strand_ratio != 1.0:
            w(f"\t[reverse primer Ct] = {cpp(opt.primer_strand)} M\n")
            w("\t[forward primer Ct]/[reverse primer Ct] = "
              f"{cpp(opt.asymmetric_strand_ratio)}\n")
        else:
            w(f"\t[primer Ct] = {cpp(opt.primer_strand)} M\n")
    if opt.has_probe():
        w(f"\t[probe Ct] = {cpp(opt.probe_strand)} M\n")
    if opt.has_primers():
        if opt.assay_format == C.ASSAY_PCR:
            w(f"\t{cpp(opt.min_primer_tm)} <= Primer Tm (C) <= "
              f"{cpp(opt.max_primer_tm)}\n")
            w(f"\t{cpp(opt.min_primer_dg)} <= Primer Delta G (Kcal/Mol) <= "
              f"{cpp(opt.max_primer_dg)}\n")
        else:
            w(f"\t{cpp(opt.min_primer_tm)} <= Padlock Tm (C) <= "
              f"{cpp(opt.max_primer_tm)}\n")
            w(f"\t{cpp(opt.min_primer_dg)} <= Padlock Delta G (Kcal/Mol) <= "
              f"{cpp(opt.max_primer_dg)}\n")
    if opt.has_probe():
        w(f"\t{cpp(opt.min_probe_tm)} <= Probe Tm (C) <= "
          f"{cpp(opt.max_probe_tm)}\n")
        w(f"\t{cpp(opt.min_probe_dg)} <= Probe Delta G (Kcal/Mol) <= "
          f"{cpp(opt.max_probe_dg)}\n")
    if opt.assay_format == C.ASSAY_PADLOCK:
        w(f"\t5' Ligation clamp = {opt.probe_clamp_5}\n")
        w(f"\t3' Ligation clamp = {opt.probe_clamp_3}\n")
        w("Assay format is PADLOCK/MOL-PCR\n")
    else:
        if opt.has_primers():
            w(f"\t3' Primer clamp = {opt.primer_clamp}\n")
            if opt.min_max_primer_clamp >= 0:
                w("\tThe minimum, maximum 3' Primer clamp = "
                  f"{opt.min_max_primer_clamp}\n")
        if opt.has_probe():
            w(f"\t5' Probe clamp = {opt.probe_clamp_5}\n")
            w(f"\t3' Probe clamp = {opt.probe_clamp_3}\n")
        if opt.has_primers():
            w(f"\tMax amplicon len = {opt.max_len}\n")
            w("Assay format is PCR and/or PROBE\n")
            if not opt.single_primer_pcr:
                w("Single primers will *not* be tested for amplicon "
                  "generation\n")
        if opt.assay_format == C.ASSAY_AFFYMETRIX:
            w("Assay format is Affymetrix PROBE\n")


def write_alignment(stream, prefix, alignment):
    """reference tntblast_util.cpp:1313-1335."""
    if alignment == "":
        return
    stream.write(prefix)
    for ch in alignment:
        stream.write(ch)
        if ch == "\n":
            stream.write(prefix)
    stream.write("\n")


def mask_white_space(s):
    return "".join("_" if c.isspace() else c for c in s)


class _Range:
    def __init__(self, lo, hi):
        self.lo = lo
        self.hi = hi

    def add(self, v):
        self.lo = min(self.lo, v)
        self.hi = max(self.hi, v)


def write_results(opt, state, db, stdout=None, out_stream=None,
                  sif_stream=None, atr_stream=None, open_per_query=None):
    """The full output phase of local_main.  `open_per_query(name)` is the
    callback used for -n T (one output file per query)."""
    if stdout is None:
        stdout = sys.stdout
    ptr_out = out_stream if out_stream is not None else stdout

    num_sig = len(opt.sig_list)
    search_results = state.search_results

    if opt.output_format & C.OUTPUT_INVERSE_QUERY:
        query_set = {s.name for s in opt.sig_list}
        match_set = {opt.sig_list[i].name for i in range(num_sig)
                     if state.query_matches[i]}
        for name in sorted(query_set - match_set):
            ptr_out.write(name + "\n")

    total_unique_targets = set()
    match_count = [0] * num_sig

    # Output statistics (reference tntblast_local.cpp:236-263)
    forward_tm = _Range(9999.0, -1.0)
    reverse_tm = _Range(9999.0, -1.0)
    probe_tm = _Range(9999.0, -1.0)
    forward_dg = _Range(9999.0, -9999.0)
    reverse_dg = _Range(9999.0, -9999.0)
    probe_dg = _Range(9999.0, -9999.0)
    forward_gc = _Range(9999.0, -1.0)
    reverse_gc = _Range(9999.0, -1.0)
    probe_gc = _Range(9999.0, -1.0)
    amplicon_size = _Range(9999, 0)
    forward_size = _Range(9999, 0)
    reverse_size = _Range(9999, 0)
    probe_size = _Range(9999, 0)
    max_primer_hairpin = -1.0
    max_primer_homodimer = -1.0
    max_primer_heterodimer = -1.0
    max_probe_homodimer = -1.0
    max_probe_hairpin = -1.0
    num_primer = 0
    num_probe = 0

    for result_index in range(num_sig):
        tmp = search_results[result_index]
        if not tmp:
            continue
        if opt.best_match:
            tmp = select_best_match(tmp)
        if state.fragment_target:
            tmp = uniquify_results(tmp)
        tmp = list_sort(tmp, hit_less)

        if opt.one_output_file_per_query and open_per_query is not None:
            ptr_out, sif_stream = open_per_query(tmp[0].name)

        standard = bool(opt.output_format & C.OUTPUT_STANDARD)
        if standard:
            ptr_out.write(RULE + "\n")

        unique_targets = set()

        for it in tmp:
            if standard:
                ptr_out.write(f"name = {it.name}\n")

            fp = ""
            rp = ""
            amplicon_seq = it.amplicon or ""

            if it.has_primers():
                num_primer += 1
                fp = ("forward primer" if opt.assay_format == C.ASSAY_PCR
                      else "5' probe")
                rp = ("reverse primer" if opt.assay_format == C.ASSAY_PCR
                      else "3' probe")
                if standard:
                    ptr_out.write(f"{fp} = 5' {it.forward_oligo} 3'\n")
                    ptr_out.write(f"{rp} = 5' {it.reverse_oligo} 3'\n")

                fdg = float(f32(it.forward_dH)
                            - f32(opt.target_t) * f32(it.forward_dS))
                rdg = float(f32(it.reverse_dH)
                            - f32(opt.target_t) * f32(it.reverse_dS))

                max_primer_hairpin = max(max_primer_hairpin,
                                         it.forward_hairpin_tm,
                                         it.reverse_hairpin_tm)
                max_primer_homodimer = max(max_primer_homodimer,
                                           it.forward_dimer_tm,
                                           it.reverse_dimer_tm)
                max_primer_heterodimer = max(max_primer_heterodimer,
                                             it.primer_dimer_tm)

                if standard:
                    ptr_out.write(f"{fp} tm = {cpp(it.forward_tm)}\n")
                    ptr_out.write(f"{rp} tm = {cpp(it.reverse_tm)}\n")
                    ptr_out.write(
                        f"{fp} hairpin tm = {cpp(it.forward_hairpin_tm)}\n")
                    ptr_out.write(
                        f"{rp} hairpin tm = {cpp(it.reverse_hairpin_tm)}\n")
                    ptr_out.write(
                        f"{fp} homodimer tm = {cpp(it.forward_dimer_tm)}\n")
                    ptr_out.write(
                        f"{rp} homodimer tm = {cpp(it.reverse_dimer_tm)}\n")
                    ptr_out.write(
                        f"heterodimer tm = {cpp(it.primer_dimer_tm)}\n")
                    ptr_out.write(
                        f"{fp} dG[{cpp(fdg)}] = dH[{cpp(it.forward_dH)}] - "
                        f"T*dS[{cpp(it.forward_dS)}]\n")
                    ptr_out.write(
                        f"{rp} dG[{cpp(rdg)}] = dH[{cpp(it.reverse_dH)}] - "
                        f"T*dS[{cpp(it.reverse_dS)}]\n")
                    ptr_out.write(f"{fp} mismatches = {it.forward_mm}\n")
                    ptr_out.write(f"{rp} mismatches = {it.reverse_mm}\n")
                    ptr_out.write(f"{fp} gaps = {it.forward_gap}\n")
                    ptr_out.write(f"{rp} gaps = {it.reverse_gap}\n")
                    if opt.assay_format == C.ASSAY_PCR:
                        ptr_out.write(
                            f"min 3' clamp = {it.min_primer_clamp()}\n")
                        ptr_out.write(
                            f"max 3' clamp = {it.max_primer_clamp()}\n")
                    if opt.assay_format in (C.ASSAY_PADLOCK, C.ASSAY_MIPS):
                        ptr_out.write("5' probe 3' ligation clamp = "
                                      f"{it.forward_primer_clamp}\n")
                        ptr_out.write("3' probe 5' ligation clamp = "
                                      f"{it.reverse_primer_clamp}\n")

                forward_size.add(len(it.forward_oligo))
                reverse_size.add(len(it.reverse_oligo))
                forward_tm.add(it.forward_tm)
                forward_dg.add(fdg)
                reverse_tm.add(it.reverse_tm)
                reverse_dg.add(rdg)

                gc = float(f32(100.0) * f32(gc_content(it.forward_oligo)))
                if standard:
                    ptr_out.write(f"{fp} %GC = {cpp(gc)}\n")
                forward_gc.add(gc)
                gc = float(f32(100.0) * f32(gc_content(it.reverse_oligo)))
                if standard:
                    ptr_out.write(f"{rp} %GC = {cpp(gc)}\n")
                reverse_gc.add(gc)

                if standard:
                    ptr_out.write(f"{fp} heuristics = "
                                  f"{primer_heuristics(it.forward_oligo)}\n")
                    ptr_out.write(f"{rp} heuristics = "
                                  f"{primer_heuristics(it.reverse_oligo)}\n")
                    if opt.assay_format == C.ASSAY_PCR:
                        ptr_out.write(
                            f"amplicon range = {it.amplicon_range[0]} .. "
                            f"{it.amplicon_range[1]}\n")
                        ptr_out.write(
                            f"amplicon length = {len(amplicon_seq)}\n")
                    elif opt.assay_format in (C.ASSAY_PADLOCK, C.ASSAY_MIPS):
                        ptr_out.write(
                            f"product range = {it.amplicon_range[0]} .. "
                            f"{it.amplicon_range[1]}\n")
                        ptr_out.write(
                            f"product length = {len(amplicon_seq)}\n")
                    if it.primer_strand == 0:  # PLUS
                        ptr_out.write("Forward primer is contained in the "
                                      "target plus strand (+)\n")
                    else:
                        ptr_out.write("Forward primer is contained in the "
                                      "target minus strand (-)\n")

                amplicon_size.add(len(amplicon_seq))

            if it.has_probe():
                num_probe += 1
                gc = float(f32(100.0) * f32(gc_content(it.probe_oligo)))
                probe_gc.add(gc)
                pdg = float(f32(it.probe_dH)
                            - f32(opt.target_t) * f32(it.probe_dS))
                max_probe_hairpin = max(max_probe_hairpin, it.probe_hairpin_tm)
                max_probe_homodimer = max(max_probe_homodimer,
                                          it.probe_dimer_tm)
                if standard:
                    ptr_out.write(f"probe = 5' {it.probe_oligo} 3'\n")
                    ptr_out.write(f"probe tm = {cpp(it.probe_tm)}\n")
                    ptr_out.write(
                        f"probe hairpin tm = {cpp(it.probe_hairpin_tm)}\n")
                    ptr_out.write(
                        f"probe homodimer tm = {cpp(it.probe_dimer_tm)}\n")
                    ptr_out.write(
                        f"probe dG[{cpp(pdg)}] = dH[{cpp(it.probe_dH)}] - "
                        f"T*dS[{cpp(it.probe_dS)}]\n")
                    ptr_out.write(f"probe mismatches = {it.probe_mm}\n")
                    ptr_out.write(f"probe gaps = {it.probe_gap}\n")
                    ptr_out.write(f"probe %GC = {cpp(gc)}\n")
                    ptr_out.write(f"probe range = {it.probe_range[0]} .. "
                                  f"{it.probe_range[1]}\n")
                    if it.probe_strand != it.primer_strand:
                        ptr_out.write(
                            "probe contained in forward strand (+)\n")
                    else:
                        ptr_out.write(
                            "probe contained in reverse strand (-)\n")
                probe_tm.add(it.probe_tm)
                probe_dg.add(pdg)
                probe_size.add(len(it.probe_oligo))

            if standard:
                if opt.output_format & C.OUTPUT_ALIGNMENTS:
                    write_alignment(ptr_out, fp + " align ", it.forward_align)
                    write_alignment(ptr_out, rp + " align ", it.reverse_align)
                    write_alignment(ptr_out, "probe align ", it.probe_align)
                if db is not None and db.is_annot_format():
                    db.write_annotation(ptr_out, it)

            if opt.output_format & (C.OUTPUT_STANDARD | C.OUTPUT_FASTA):
                line = ">" + (it.amplicon_def or "")
                if opt.append_name_to_defline:
                    line += " " + it.name
                ptr_out.write(line + "\n")
                if opt.output_format & C.OUTPUT_SEQ_MATCH:
                    ptr_out.write(amplicon_seq + "\n")
            if standard:
                ptr_out.write("\n")

            if (opt.output_format & C.OUTPUT_NETWORK) and sif_stream:
                sif_stream.write(
                    f"{mask_white_space(it.name)} binds "
                    f"{mask_white_space(it.amplicon_def or '')}\n")

            unique_targets.add(it.amplicon_def or "")
            total_unique_targets.add(it.amplicon_def or "")

        match_count[result_index] = len(unique_targets)

    if (opt.output_format & C.OUTPUT_NETWORK) and atr_stream:
        for sig in opt.sig_list:
            atr_stream.write(f"{mask_white_space(sig.name)} = parent\n")
        for t in sorted(total_unique_targets):
            atr_stream.write(f"{mask_white_space(t)} = child\n")

    if opt.output_format & C.OUTPUT_INVERSE_TARGET:
        count = 0
        for i in range(db.size()):
            defline = db.defline(i)
            if defline not in total_unique_targets:
                ptr_out.write(defline + "\n")
                count += 1
        if opt.verbose:
            stdout.write(f"Wrote {count} inverse target matches "
                         "(that did not match any query!)\n")

    inverse_query = bool(opt.output_format & C.OUTPUT_INVERSE_QUERY)
    if opt.verbose and not inverse_query:
        stdout.write(f"Found {len(total_unique_targets)} (total) target "
                     "sequence matches\n")

    if opt.verbose and num_primer > 0 and not inverse_query:
        stdout.write(
            "Amplicon:\n"
            f"\t{amplicon_size.lo} <= Amplicon length <= "
            f"{amplicon_size.hi}\n"
            "Forward primer:\n"
            f"\t{cpp(forward_tm.lo)} <= Tm (C) <= {cpp(forward_tm.hi)}\n"
            f"\t{cpp(forward_dg.lo)} <= Delta G (Kcal/Mol) <= "
            f"{cpp(forward_dg.hi)}\n"
            f"\t{cpp(forward_gc.lo)} <= %GC <= {cpp(forward_gc.hi)}\n"
            f"\t{forward_size.lo} <= length <= {forward_size.hi}\n"
            "Reverse primer:\n"
            f"\t{cpp(reverse_tm.lo)} <= Tm (C) <= {cpp(reverse_tm.hi)}\n"
            f"\t{cpp(reverse_dg.lo)} <= Delta G (Kcal/Mol) <= "
            f"{cpp(reverse_dg.hi)}\n"
            f"\t{cpp(reverse_gc.lo)} <= %GC <= {cpp(reverse_gc.hi)}\n"
            f"\t{reverse_size.lo} <= length <= {reverse_size.hi}\n"
            f"Max primer hairpin Tm = {cpp(max_primer_hairpin)}\n"
            f"Max primer heterodimer Tm = {cpp(max_primer_heterodimer)}\n"
            f"Max primer homodimer Tm = {cpp(max_primer_homodimer)}\n")

    if opt.verbose and num_probe > 0 and not inverse_query:
        stdout.write(
            "Probe:\n"
            f"\t{cpp(probe_tm.lo)} <= Tm (C) <= {cpp(probe_tm.hi)}\n"
            f"\t{cpp(probe_dg.lo)} <= Delta G (Kcal/Mol) <= "
            f"{cpp(probe_dg.hi)}\n"
            f"\t{cpp(probe_gc.lo)} <= %GC <= {cpp(probe_gc.hi)}\n"
            f"\t{probe_size.lo} <= length <= {probe_size.hi}\n"
            f"Max probe hairpin Tm = {cpp(max_probe_hairpin)}\n"
            f"Max probe homodimer Tm = {cpp(max_probe_homodimer)}\n")

    if opt.assay_summary and not inverse_query:
        stdout.write("*** Assay Summary ***\n")
        for sig in opt.sig_list:
            stdout.write(f"{sig.name} matched {match_count[sig.id]} "
                         "sequences\n")
            if sig.forward_oligo is not None and sig.reverse_oligo is not None:
                stdout.write(f"\tF::R = {sig.forward_oligo} :: "
                             f"{sig.reverse_oligo}\n")
            if sig.probe_oligo is not None:
                stdout.write(f"\tP = {sig.probe_oligo}\n")
