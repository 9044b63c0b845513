# Copy of tntblast_tpu/model.py with the package name changed.
"""Assay / hit records, input parsing, degenerate + multiplex expansion.

The Assay dataclass plays both roles of the reference's hybrid_sig (query
record and search hit; reference: hybrid_sig.h).  Strings are stored
directly (the reference's Huffman string interning is a CPU-memory
optimization we do not need).
"""

import itertools
from dataclasses import dataclass, field, replace

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.utils.listsort import list_sort

PLUS, MINUS = 0, 1

_DEGEN_EXPANSION = {
    "A": "A", "T": "T", "G": "G", "C": "C", "I": "I",
    "M": "AC", "R": "GA", "S": "GC", "V": "GCA", "W": "AT",
    "Y": "TC", "H": "ACT", "K": "GT", "D": "GAT", "B": "GTC", "N": "ATGC",
}


@dataclass
class Assay:
    name: str = ""
    forward_oligo: str = None
    reverse_oligo: str = None
    probe_oligo: str = None

    amplicon_def: str = None
    amplicon: str = None
    forward_align: str = ""
    reverse_align: str = ""
    probe_align: str = ""

    amplicon_range: tuple = (0, 0)
    probe_range: tuple = (0, 0)
    id: int = -1
    degen_id: int = -1
    seq_index: int = -1

    forward_tm: float = -1.0
    reverse_tm: float = -1.0
    probe_tm: float = -1.0
    forward_hairpin_tm: float = -1.0
    reverse_hairpin_tm: float = -1.0
    forward_dimer_tm: float = -1.0
    reverse_dimer_tm: float = -1.0
    primer_dimer_tm: float = -1.0
    probe_hairpin_tm: float = -1.0
    probe_dimer_tm: float = -1.0

    forward_dH: float = 100.0
    forward_dS: float = 0.0
    reverse_dH: float = 100.0
    reverse_dS: float = 0.0
    probe_dH: float = 100.0
    probe_dS: float = 0.0

    primer_strand: int = PLUS
    probe_strand: int = PLUS
    forward_primer_clamp: int = -1
    reverse_primer_clamp: int = -1
    forward_degen: int = 1
    reverse_degen: int = 1
    probe_degen: int = 1
    forward_mm: int = -1
    forward_gap: int = -1
    reverse_mm: int = -1
    reverse_gap: int = -1
    probe_mm: int = -1
    probe_gap: int = -1

    def copy(self):
        return replace(self)

    def has_primers(self):
        return self.forward_oligo is not None and self.reverse_oligo is not None

    def has_probe(self):
        return self.probe_oligo is not None

    def min_primer_tm(self):
        return max(0.0, min(self.forward_tm, self.reverse_tm))

    def max_primer_tm(self):
        return max(self.forward_tm, self.reverse_tm)

    def min_primer_clamp(self):
        return min(self.forward_primer_clamp, self.reverse_primer_clamp)

    def max_primer_clamp(self):
        return max(self.forward_primer_clamp, self.reverse_primer_clamp)

    def offset_ranges(self, off):
        if self.has_primers():
            self.amplicon_range = (self.amplicon_range[0] + off,
                                   self.amplicon_range[1] + off)
        if self.has_probe():
            self.probe_range = (self.probe_range[0] + off,
                                self.probe_range[1] + off)

    def start_overlap(self, start):
        if self.has_primers():
            return self.amplicon_range[0] <= start
        return self.probe_range[0] <= start

    def stop_overlap(self, stop):
        if self.has_primers():
            return self.amplicon_range[1] >= stop
        return self.probe_range[1] >= stop


def hit_less(a: Assay, b: Assay):
    """hybrid_sig::operator< (reference hybrid_sig.h:328-357): by id, then
    descending min primer Tm, probe Tm, max primer Tm, ascending target."""
    if a.id == b.id:
        if a.min_primer_tm() == b.min_primer_tm():
            if a.probe_tm == b.probe_tm:
                if a.max_primer_tm() == b.max_primer_tm():
                    return a.seq_index < b.seq_index
                return a.max_primer_tm() > b.max_primer_tm()
            return a.probe_tm > b.probe_tm
        return a.min_primer_tm() > b.min_primer_tm()
    return a.id < b.id


def sort_by_match_less(a, b):
    if a.id == b.id:
        return a.seq_index < b.seq_index
    return a.id < b.id


def sort_by_loc_less(a, b):
    if a.id == b.id:
        if a.seq_index == b.seq_index:
            if a.has_primers():
                return a.amplicon_range < b.amplicon_range
            return a.probe_range < b.probe_range
        return a.seq_index < b.seq_index
    return a.id < b.id


# ---------------------------------------------------------------------------

def read_input_file(path, ignore_probe=False, force_probe=False):
    """Tab/space-delimited assay parser (reference input.cpp:43-168)."""
    if ignore_probe and force_probe:
        raise ValueError("Can not both ignore and force probes at the same time!")
    assays = []
    count = 0
    with open(path) as fh:
        for line in fh:
            pos = line.find("#")
            if pos >= 0:
                line = line[:pos]
            fields = line.split()
            if not fields:
                continue
            if len(fields) == 2:
                if ignore_probe:
                    raise ValueError(
                        "ignore_probe is true but only probes have been provided!")
                assays.append(Assay(name=fields[0], probe_oligo=fields[1],
                                    id=count, degen_id=count)); count += 1
            elif len(fields) == 3:
                if force_probe:
                    assays.append(Assay(name=fields[0] + "_F",
                                        probe_oligo=fields[1],
                                        id=count, degen_id=count)); count += 1
                    assays.append(Assay(name=fields[0] + "_R",
                                        probe_oligo=fields[2],
                                        id=count, degen_id=count)); count += 1
                else:
                    assays.append(Assay(name=fields[0],
                                        forward_oligo=fields[1],
                                        reverse_oligo=fields[2],
                                        id=count, degen_id=count)); count += 1
            elif len(fields) == 4:
                if ignore_probe:
                    assays.append(Assay(name=fields[0],
                                        forward_oligo=fields[1],
                                        reverse_oligo=fields[2],
                                        id=count, degen_id=count)); count += 1
                elif force_probe:
                    for suffix, oligo in (("_F", fields[1]), ("_R", fields[2]),
                                          ("_P", fields[3])):
                        assays.append(Assay(name=fields[0] + suffix,
                                            probe_oligo=oligo,
                                            id=count, degen_id=count)); count += 1
                else:
                    assays.append(Assay(name=fields[0],
                                        forward_oligo=fields[1],
                                        reverse_oligo=fields[2],
                                        probe_oligo=fields[3],
                                        id=count, degen_id=count)); count += 1
            else:
                raise ValueError("Invalid number of arguments input file")
    return assays


def expand_nucleic_acid(seq):
    """IUPAC cartesian expansion in the reference's odometer order
    (reference degenerate_na.cpp:70-173: index 0 varies fastest)."""
    choices = []
    for ch in seq.upper():
        if ch not in _DEGEN_EXPANSION:
            raise ValueError(f"Unknown base {ch!r}")
        choices.append(_DEGEN_EXPANSION[ch])
    out = []
    n = 1
    for c in choices:
        n *= len(c)
    idx = [0] * len(choices)
    for _ in range(n):
        out.append("".join(c[i] for c, i in zip(choices, idx)))
        for j in range(len(choices)):
            idx[j] += 1
            if idx[j] == len(choices[j]):
                idx[j] = 0
            else:
                break
    return out


def degeneracy(oligo):
    d = 1
    for ch in oligo.upper():
        d *= len(_DEGEN_EXPANSION[ch])
    return d


def expand_degenerate_signatures(assays, rescale_ct=True, verbose=False):
    """Expand degenerate assays into concrete oligos (reference
    tntblast_util.cpp:579-713): parent `id` kept, unique `degen_id`, strand
    concentration divided by degeneracy at search time."""
    out = []
    next_id = 0
    for a in assays:
        if a.has_primers():
            fwd = expand_nucleic_acid(a.forward_oligo)
            rev = expand_nucleic_acid(a.reverse_oligo)
            # reference pairs expand with primer2 (reverse) varying fastest
            primers = [(f, r) for f in fwd for r in rev]
        else:
            primers = []
        probes = expand_nucleic_acid(a.probe_oligo) if a.has_probe() else []

        # reference tntblast_util.cpp:622-628: the message uses the literal
        # product |primers|*|probes| (0 when either list is empty, so
        # primer-only expansions are never announced) and is NOT gated on
        # the verbose flag
        num_expanded = len(primers) * len(probes)
        if num_expanded > 1:
            print(f"Expanded degenerate bases in {a.name} to make "
                  f"{num_expanded} non-degenerate assays")

        dg_f = degeneracy(a.forward_oligo) if (rescale_ct and a.forward_oligo) else 1
        dg_r = degeneracy(a.reverse_oligo) if (rescale_ct and a.reverse_oligo) else 1
        dg_p = degeneracy(a.probe_oligo) if (rescale_ct and a.probe_oligo) else 1

        if not primers:
            for p in probes:
                t = Assay(name=a.name, probe_oligo=p, id=a.id,
                          degen_id=next_id, probe_degen=dg_p)
                next_id += 1
                out.append(t)
        else:
            for f, r in primers:
                if not probes:
                    t = Assay(name=a.name, forward_oligo=f, reverse_oligo=r,
                              id=a.id, degen_id=next_id,
                              forward_degen=dg_f, reverse_degen=dg_r)
                    next_id += 1
                    out.append(t)
                else:
                    for p in probes:
                        t = Assay(name=a.name, forward_oligo=f,
                                  reverse_oligo=r, probe_oligo=p, id=a.id,
                                  degen_id=next_id, forward_degen=dg_f,
                                  reverse_degen=dg_r, probe_degen=dg_p)
                        next_id += 1
                        out.append(t)
    return out


def multiplex_expansion(assays, assay_format, verbose=False):
    """All-pairs multiplex expansion (reference tntblast_util.cpp:715-915)."""
    ret = []
    next_id = 0

    if assay_format in (C.ASSAY_PADLOCK, C.ASSAY_MIPS):
        for i in assays:
            for j in assays:
                name = i.name if i is j else f"{i.name}(5')/{j.name}(3')"
                ret.append(Assay(name=name, forward_oligo=i.forward_oligo,
                                 reverse_oligo=j.reverse_oligo,
                                 id=next_id, degen_id=next_id))
                next_id += 1

    if assay_format == C.ASSAY_PCR:
        has_probes = False
        for i in assays:
            if i.forward_oligo is None:
                continue
            if i.probe_oligo is not None:
                has_probes = True
            for j in assays:
                if i.forward_oligo == j.reverse_oligo:
                    continue
                name = f"{i.name}(F)/{j.name}(R)"
                ret.append(Assay(name=name, forward_oligo=i.forward_oligo,
                                 reverse_oligo=j.reverse_oligo,
                                 id=next_id, degen_id=next_id))
                next_id += 1
        for i in assays:
            if i.forward_oligo is None:
                continue
            for j in assays:
                if i.forward_oligo == j.forward_oligo:
                    continue
                name = f"{i.name}(F)/{j.name}(F)"
                ret.append(Assay(name=name, forward_oligo=i.forward_oligo,
                                 reverse_oligo=j.forward_oligo,
                                 id=next_id, degen_id=next_id))
                next_id += 1
        for i in assays:
            if i.forward_oligo is None:
                continue
            for j in assays:
                if i.reverse_oligo == j.reverse_oligo:
                    continue
                name = f"{i.name}(R)/{j.name}(R)"
                ret.append(Assay(name=name, forward_oligo=i.reverse_oligo,
                                 reverse_oligo=j.reverse_oligo,
                                 id=next_id, degen_id=next_id))
                next_id += 1

        if has_probes:
            with_probe = []
            next_id = 0
            for i in ret:
                for j in assays:
                    if j.probe_oligo is None:
                        continue
                    name = f"{i.name}+{j.name}(P)"
                    with_probe.append(Assay(
                        name=name, forward_oligo=i.forward_oligo,
                        reverse_oligo=i.reverse_oligo,
                        probe_oligo=j.probe_oligo,
                        id=next_id, degen_id=next_id))
                    next_id += 1
            ret = with_probe

    if assay_format == C.ASSAY_AFFYMETRIX:
        return assays

    # Deduplicate assays that share oligos: impose a consistent order on the
    # primer pair (reference sort_by_seq / compare_by_seq use the string
    # table indices; equal oligo strings map to equal indices, so comparing
    # by an interning order over the strings is equivalent).
    intern = {}

    def sidx(s):
        # INVALID_INDEX (None) sorts above every real index, as 0xFFFF... does
        if s is None:
            return (1, 0)
        if s not in intern:
            intern[s] = len(intern)
        return (0, intern[s])

    # Build interning in input order like the reference string table: names
    # first then oligos as encountered during parsing. Good enough for a
    # *consistent* order; the reference only requires consistency to dedup.
    for a in assays:
        for s in (a.name, a.forward_oligo, a.reverse_oligo, a.probe_oligo):
            if s is not None:
                sidx(s)

    def key_of(a):
        fa, ra = sidx(a.forward_oligo), sidx(a.reverse_oligo)
        if fa < ra:
            fa, ra = ra, fa
        return (fa, ra, sidx(a.probe_oligo))

    ret = list_sort(ret, lambda x, y: key_of(x) < key_of(y))
    dedup = []
    for a in ret:
        if dedup and key_of(dedup[-1]) == key_of(a):
            continue
        dedup.append(a)
    ret = dedup
    for i, a in enumerate(ret):
        a.id = a.degen_id = i
    # reference tntblast_util.cpp:911-912: printed unconditionally to stderr
    import sys
    print(f"Multiplexing has created {len(ret)} assays from "
          f"{len(assays)} input assays", file=sys.stderr)
    return ret
