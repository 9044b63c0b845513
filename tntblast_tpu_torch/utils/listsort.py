# Copy of tntblast_tpu/utils/listsort.py with the package name changed.
"""std::list::sort / std::list::merge equivalents.

Some reference comparators (notably sort_by_oligo_loc, which switches
comparison keys between bound and unbound entries) are not strict weak
orders; different stable sorting algorithms can then produce different
permutations.  To keep hit-list parity we reproduce libstdc++'s
binary-counter bottom-up mergesort exactly.
"""


def list_merge(a, b, less):
    """std::list::merge: stable; on ties the element of `a` comes first."""
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        if less(b[j], a[i]):
            out.append(b[j]); j += 1
        else:
            out.append(a[i]); i += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return out


def list_sort(items, less):
    """libstdc++ std::list::sort: binary-counter merge of singletons."""
    counter = []
    for x in items:
        carry = [x]
        i = 0
        while i < len(counter) and counter[i]:
            carry = list_merge(counter[i], carry, less)
            counter[i] = []
            i += 1
        if i == len(counter):
            counter.append(carry)
        else:
            counter[i] = carry
    # Final fold: counter[i].merge(counter[i-1]) — the higher bin (earlier
    # elements) is *this* and wins ties.
    result = []
    for run in counter:
        if run:
            result = list_merge(run, result, less)
    return result


def list_unique(items, equal):
    """std::list::unique: drop consecutive duplicates, keeping the first."""
    out = []
    for x in items:
        if out and equal(out[-1], x):
            continue
        out.append(x)
    return out
