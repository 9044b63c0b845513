# Copy of tntblast_tpu/search/seed.py with the package name changed.
"""Exact k-mer seeding over a target fragment.

Semantics mirror the reference DNAHash (reference: seq_hash.h): 2-bit packed
words of length w (2..8) over A/C/G/T only; any non-ATGC base breaks the
word run.  A query "find" enumerates, for every valid word of the oligo (in
scan order), all target positions holding that word; "find_complement"
scans the oligo 3'->5' complementing each base.

The reference reports the *index in the compacted word list* as the query
offset (seq_hash.h DNAHash_iterator::offset) — not the sequence position —
and downstream code derives seed diagonals from it; we reproduce that
exactly.

Implementation is vectorized numpy over the fragment (the TPU path replaces
the scan with a jnp convolution-style packing; see ops/seed_jax.py).
"""

import numpy as np

from tntblast_tpu_torch.constants import DB_MAX_ATGC


class FragmentIndex:
    """Word table over one target fragment (db codes uint8)."""

    def __init__(self, seq_codes, word_len):
        self.word_len = int(word_len)
        self.n = len(seq_codes)
        w = self.word_len

        if self.n < w:
            self.words = np.zeros(0, dtype=np.int32)
            self.positions = np.zeros(0, dtype=np.int64)
            self.order = np.zeros(0, dtype=np.int64)
            self.bucket_start = np.zeros((1 << (2 * w)) + 1, dtype=np.int64)
            return

        codes = seq_codes.astype(np.int64)
        two_bit = codes & 3
        valid = codes <= DB_MAX_ATGC

        # word value at position p covers bases [p, p+w-1]
        word = np.zeros(self.n - w + 1, dtype=np.int64)
        for k in range(w):
            word = word | (two_bit[k:self.n - w + 1 + k] << (2 * (w - 1 - k)))

        # valid iff all w bases are ATGC: prefix-sum of validity
        vc = np.cumsum(np.concatenate([[0], valid.astype(np.int64)]))
        allvalid = (vc[w:] - vc[:-w]) == w

        self.positions = np.nonzero(allvalid)[0].astype(np.int64)
        self.words = word[self.positions].astype(np.int32)

        # counting-sort into buckets (positions within a bucket stay in
        # ascending order — matches the reference two-pass build)
        self.order = np.argsort(self.words, kind="stable")
        counts = np.bincount(self.words, minlength=1 << (2 * w))
        self.bucket_start = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.bucket_start[1:])

    def lookup_word(self, w):
        """Target positions holding word w, ascending."""
        s, e = self.bucket_start[w], self.bucket_start[w + 1]
        return self.positions[self.order[s:e]]


def oligo_word_list(oligo_codes, word_len, complement):
    """Word list of an oligo (melt/db codes both work: low 2 bits + <=3 test).

    Returns int32 array of words in the reference's scan order; offsets into
    this array are the seed "query offsets".
    """
    w = word_len
    n = len(oligo_codes)
    words = []
    mask = (1 << (2 * w)) - 1
    word = 0
    cur = 0
    if complement:
        for i in range(n - 1, -1, -1):
            b = int(oligo_codes[i])
            if b <= DB_MAX_ATGC:
                word = ((word << 2) | (3 - b)) & 0xFFFFFFFF
                cur += 1
            else:
                cur = 0
            if cur >= w:
                words.append(word & mask)
    else:
        for i in range(n):
            b = int(oligo_codes[i])
            if b <= DB_MAX_ATGC:
                word = ((word << 2) | b) & 0xFFFFFFFF
                cur += 1
            else:
                cur = 0
            if cur >= w:
                words.append(word & mask)
    return np.asarray(words, dtype=np.int64)


def find_seeds(frag: FragmentIndex, oligo_codes, complement):
    """All (query_offset, target_pos) seed hits in reference iteration order.

    query_offset k = index in the oligo's compacted word list; hits for word
    k are ordered by ascending target position.
    """
    words = oligo_word_list(oligo_codes, frag.word_len, complement)
    if len(words) == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    q_offs = []
    t_positions = []
    for k, wv in enumerate(words):
        pos = frag.lookup_word(int(wv))
        if len(pos):
            q_offs.append(np.full(len(pos), k, dtype=np.int64))
            t_positions.append(pos)
    if not q_offs:
        return (np.zeros(0, dtype=np.int64),) * 2
    return np.concatenate(q_offs), np.concatenate(t_positions)


def unique_diagonal_seeds(q_off, t_pos):
    """Deduplicate seeds by diagonal delta = q_off - t_pos, keeping the first
    hit (in iteration order) per diagonal, output sorted by ascending delta.

    Matches the reference's stable sort_by_delta + unique_by_delta over the
    enumeration order (bind_oligo.cpp:33-47).
    """
    if len(q_off) == 0:
        return q_off, t_pos
    delta = q_off - t_pos
    # np.unique returns the index of the first occurrence of each value
    _, first = np.unique(delta, return_index=True)
    first.sort()
    # re-sort representatives by delta ascending
    rep_q = q_off[first]
    rep_t = t_pos[first]
    order = np.argsort(rep_q - rep_t, kind="stable")
    return rep_q[order], rep_t[order]
