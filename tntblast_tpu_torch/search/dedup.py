# Copy of tntblast_tpu/search/dedup.py with the package name changed.
"""Best-match selection and fragment-overlap deduplication.

Mirrors the reference post-processing (reference: tntblast_util.cpp:1482-1547
select_best_match, :1555-1755 uniquify_results, :1758-1775 top_strand).
The exact iteration/erase order is load-bearing for hit-list parity when
equal-scoring matches exist, so both functions are literal translations.
"""

from tntblast_tpu_torch.model import sort_by_match_less, sort_by_loc_less
from tntblast_tpu_torch.utils.listsort import list_sort

_NO_MATCH, _A_CONTAINS_B, _B_CONTAINS_A = 0, 1, 2


def top_strand(align):
    """Extract the query strand text from a rendered alignment
    (reference tntblast_util.cpp:1758-1775)."""
    start = align.find("5' ")
    if start < 0:
        raise ValueError("top_strand: Unable to parse alignment")
    start += 3
    stop = align.find(" 3'")
    if stop < 0:
        raise ValueError("top_strand: Unable to parse alignment")
    return align[start:stop]


def select_best_match(results):
    """Keep only the best match per (assay id, target) pair
    (reference tntblast_util.cpp:1482-1547).  Mutates and returns the list."""
    if not results:
        return results
    res = list_sort(results, sort_by_match_less)

    best = 0
    curr = 1
    while curr < len(res):
        a, b = res[best], res[curr]
        if a.id == b.id and a.seq_index == b.seq_index:
            delete_curr = False
            if b.has_primers():
                if b.min_primer_tm() == a.min_primer_tm():
                    if b.probe_tm < a.probe_tm:
                        delete_curr = True
                    if b.max_primer_tm() < a.max_primer_tm():
                        delete_curr = True
                else:
                    if b.min_primer_tm() < a.min_primer_tm():
                        delete_curr = True
            else:
                if b.probe_tm < a.probe_tm:
                    delete_curr = True
            if delete_curr:
                del res[curr]
            else:
                del res[best]
                best = curr - 1
                # curr index value is unchanged: it now names the element
                # after the old curr (reference curr_iter++)
        else:
            best = curr
            curr += 1
    return res


def uniquify_results(results):
    """Remove duplicate/contained matches induced by overlapping target
    fragments (reference tntblast_util.cpp:1555-1755): within each
    (id, degen_id, seq) run after sort_by_loc, a match that is contained in
    another (amplicon range containment + primer-site proximity + top-strand
    substring tests, with nested-amplicon and probe-location carve-outs) is
    dropped in favor of the containing match."""
    if len(results) < 2:
        return results
    res = list_sort(results, sort_by_loc_less)
    n = len(res)
    reaper = set()

    start = 0
    while True:
        stop = start
        while (stop < n and res[start].id == res[stop].id
               and res[start].degen_id == res[stop].degen_id
               and res[start].seq_index == res[stop].seq_index):
            stop += 1

        valid = []
        for i in range(start, stop):
            if not valid:
                valid.append(i)
                continue
            it = res[i]
            forward_primer_len = (len(it.forward_oligo or "")) // 2
            reverse_primer_len = (len(it.reverse_oligo or "")) // 2
            match_status = _NO_MATCH

            for vpos in range(len(valid)):
                vt = res[valid[vpos]]
                same = _NO_MATCH
                if it.has_primers():
                    primers_overlap = (
                        abs(it.amplicon_range[0] - vt.amplicon_range[0])
                        < forward_primer_len
                        and abs(it.amplicon_range[1] - vt.amplicon_range[1])
                        < reverse_primer_len)
                    if primers_overlap:
                        if (it.amplicon_range[0] <= vt.amplicon_range[0]
                                and it.amplicon_range[1] >= vt.amplicon_range[1]
                                and top_strand(vt.forward_align)
                                in top_strand(it.forward_align)
                                and top_strand(vt.reverse_align)
                                in top_strand(it.reverse_align)):
                            same = _A_CONTAINS_B
                        elif (vt.amplicon_range[0] <= it.amplicon_range[0]
                              and vt.amplicon_range[1] >= it.amplicon_range[1]
                              and top_strand(it.forward_align)
                              in top_strand(vt.forward_align)
                              and top_strand(it.reverse_align)
                              in top_strand(vt.reverse_align)):
                            same = _B_CONTAINS_A
                        if (it.has_probe() and vt.has_probe()
                                and it.probe_range != vt.probe_range):
                            same = _NO_MATCH
                else:
                    if (it.probe_range[0] <= vt.probe_range[0]
                            and it.probe_range[1] >= vt.probe_range[1]
                            and top_strand(vt.probe_align)
                            in top_strand(it.probe_align)):
                        same = _A_CONTAINS_B
                    elif (vt.probe_range[0] <= it.probe_range[0]
                          and vt.probe_range[1] >= it.probe_range[1]
                          and top_strand(it.probe_align)
                          in top_strand(vt.probe_align)):
                        same = _B_CONTAINS_A

                if same == _NO_MATCH:
                    continue
                if same == _A_CONTAINS_B:
                    valid[vpos] = i
                    match_status = _A_CONTAINS_B
                else:
                    match_status = _B_CONTAINS_A
                    break

            if match_status == _NO_MATCH:
                valid.insert(0, i)

        kept = set(valid)
        for i in range(start, stop):
            if i not in kept:
                reaper.add(i)

        start = stop
        if stop == n:
            break

    return [x for i, x in enumerate(res) if i not in reaper]
