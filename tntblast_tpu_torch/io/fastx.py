# Copy of tntblast_tpu/io/fastx.py with the package name changed.
"""Sequence database readers (FASTA/FASTQ, transparently gzipped).

Semantics mirror the reference loader (reference: sequence_data_fastx.cpp,
sequence_data.cpp:695-754):

  - Record index = byte offsets of each '>' (FASTA) / '@' (FASTQ) defline.
  - The *approximate* sequence length used by the fragmentation scheduler is
    the record's byte span (defline + newlines included) — an overestimate,
    but the fragment boundaries derived from it are part of the output
    contract (edge culling + dedup depend on them).
  - read(idx, start, stop) yields bases [start, stop] (inclusive) after
    dropping whitespace, '*' and '-' characters; bases are DB_* codes.
  - GBK/EMBL annotation formats live in io/annot.py (later phase).
"""

import gzip

import numpy as np

from tntblast_tpu_torch.constants import ASCII_TO_DB


def seq_len_increment(length, max_len):
    """(fragment length increment, number of fragments) for a sequence.

    Reference: sequence_data.cpp:739-754 — the smallest n with len/n <=
    max_len; fragment delta = ceil-ish division.
    """
    if length <= max_len:
        return length - 1, 1
    n = 2
    while length > n * max_len:
        n += 1
    return length // n + (1 if length % n else 0), n


def _is_gzip(path):
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


def file_type(path):
    """Auto-detect FASTA / FASTQ / GBK / EMBL from the first 511 bytes
    (reference annotation.cpp:296-380)."""
    if _is_gzip(path):
        with gzip.open(path, "rb") as fh:
            head = fh.read(511)
    else:
        with open(path, "rb") as fh:
            head = fh.read(511)
    text = head.decode("latin1")

    gbk_hint = False
    first = None
    for ch in text:
        if ch.isspace():
            continue
        if first is None:
            first = ch
        if ch == ">":
            return "FASTA"
        if ch.isupper():
            gbk_hint = True
    if first is None:
        raise ValueError("file_type: empty file")
    if first == "@":
        return "FASTQ"
    if "LOCUS" in text and "DEFINITION" in text:
        return "GBK"
    if gbk_hint:
        if text.lstrip().startswith("ID") or "\nFT" in text:
            return "EMBL"
        return "GBK"
    raise ValueError("file_type: unable to determine file type")


def open_database(path, blast_include=None, blast_exclude=None):
    """sequence_data::open (reference sequence_data.cpp:28-267) — pick the
    reader by detected format.  Like CSeqDB, a BLAST database is named by
    its base path (a `<base>.nin` volume next to it)."""
    import os
    if os.path.exists(path + ".nin") or path.endswith(".nin"):
        from tntblast_tpu_torch.io.blastdb import BlastDb
        base = path[:-4] if path.endswith(".nin") else path
        return BlastDb(base, include=blast_include, exclude=blast_exclude)
    fmt = file_type(path)
    if fmt in ("FASTA", "FASTQ"):
        return SequenceDatabase(path)
    from tntblast_tpu_torch.io.annot import AnnotatedDatabase
    return AnnotatedDatabase(path, fmt)


class SequenceDatabase:
    """FASTA/FASTQ database with byte-offset record index.

    The whole (decompressed) file is held in memory; at multi-GB scale the
    sharded multi-host layout in parallel/ divides the records across hosts
    before this object is built.
    """

    FASTA, FASTQ = 0, 1

    def __init__(self, path):
        self.path = path
        if _is_gzip(path):
            with gzip.open(path, "rb") as fh:
                self.data = fh.read()
        else:
            with open(path, "rb") as fh:
                self.data = fh.read()

        self.format = self._detect_format()
        if self.format == self.FASTA:
            self._index_fasta()
        else:
            self._index_fastq()

        # (approx length, index) like the reference seq_length table
        n = len(self.offsets) - 1
        self.approx_len = [self.offsets[i + 1] - self.offsets[i]
                           for i in range(n)]

    def _detect_format(self):
        for ch in self.data[:4096]:
            c = chr(ch)
            if c.isspace():
                continue
            if c == ">":
                return self.FASTA
            if c == "@":
                return self.FASTQ
            break
        # Fall back to FASTA semantics (reference rejects unknown types; the
        # CLI layer raises before we get here for non-sequence files).
        return self.FASTA

    def _index_fasta(self):
        # '>' at line starts only (a '>' inside a defline doesn't start a new
        # record; reference fastx:37-53 uses a read_fasta flag reset on \n)
        data = self.data
        offsets = []
        read_fasta = False
        arr = np.frombuffer(data, dtype=np.uint8)
        gt = np.nonzero(arr == ord(">"))[0]
        nl = np.nonzero(arr == ord("\n"))[0]
        # a '>' opens a record if no other '>' was seen since the last newline
        j = 0
        last_nl = -1
        ni = 0
        for pos in gt:
            while ni < len(nl) and nl[ni] < pos:
                last_nl = nl[ni]
                ni += 1
            if not offsets or last_nl > offsets[-1]:
                offsets.append(int(pos))
            elif offsets and offsets[-1] <= last_nl:
                offsets.append(int(pos))
        del j
        # The scan above adds a '>' only when a newline separates it from the
        # previously added one — equivalent to the reference flag logic.
        self.offsets = offsets + [len(data)]

    def _index_fastq(self):
        # reference fastx:94-185: '@' at line start opens a record unless the
        # previous line-start header was '+' (quality line may start with '@')
        data = self.data
        offsets = []
        last_header = "-"
        read_eol = True
        for i, ch in enumerate(data):
            c = chr(ch)
            if c == "@":
                if read_eol:
                    if last_header != "+":
                        offsets.append(i)
                    last_header = "@"
                read_eol = False
            elif c == "+":
                if read_eol:
                    last_header = "-" if last_header == "+" else "+"
                read_eol = False
            elif c in " \t":
                pass
            elif c in "\n\r":
                read_eol = True
            else:
                if read_eol:
                    last_header = "-"
                read_eol = False
        self.offsets = offsets + [len(data)]

    # ------------------------------------------------------------------
    def is_annot_format(self):
        """GBK/EMBL annotation support lives in io/annot.py (later phase)."""
        return False

    def size(self):
        return max(0, len(self.offsets) - 1)

    def effective_size(self, max_len):
        total = 0
        for L in self.approx_len:
            if max_len >= L:
                total += 1
            else:
                total += seq_len_increment(L, max_len)[1]
        return total

    def approx_seq_len(self, i):
        if i >= len(self.approx_len):
            return 0
        return self.approx_len[i]

    def defline(self, idx):
        rec = self.data[self.offsets[idx]:self.offsets[idx + 1]]
        p = 1  # skip '>' / '@'
        while p < len(rec) and chr(rec[p]).isspace():
            p += 1
        e = p
        while e < len(rec) and rec[e] not in (10, 13):
            e += 1
        return rec[p:e].decode("latin1")

    def read(self, idx, start=0, stop=-1):
        """Return (defline, base codes uint8 array) for bases [start, stop].

        stop < 0 means the whole record.  Whitespace, '*' and '-' are
        skipped before indexing (reference fastx:366).  The parsed record
        is cached so consecutive fragment reads of the same target slice
        without re-parsing.
        """
        cached = getattr(self, "_read_cache", None)
        if cached is not None and cached[0] == idx:
            _, defline, codes = cached
        else:
            rec = self.data[self.offsets[idx]:self.offsets[idx + 1]]
            p = 1
            while p < len(rec) and chr(rec[p]).isspace():
                p += 1
            e = p
            while e < len(rec) and rec[e] not in (10, 13):
                e += 1
            defline = rec[p:e].decode("latin1")

            if self.format == self.FASTQ:
                # sequence is the single line after the defline
                s = e
                while s < len(rec) and rec[s] in (10, 13):
                    s += 1
                e2 = s
                while e2 < len(rec) and rec[e2] not in (10, 13):
                    e2 += 1
                body = np.frombuffer(rec[s:e2], dtype=np.uint8)
            else:
                body = np.frombuffer(rec[e:], dtype=np.uint8)

            # Drop whitespace / '*' / '-'
            keep = ~((body == ord(" ")) | (body == ord("\t"))
                     | (body == ord("\n")) | (body == ord("\r"))
                     | (body == 11) | (body == 12)
                     | (body == ord("*")) | (body == ord("-")))
            codes = ASCII_TO_DB[body[keep]]
            self._read_cache = (idx, defline, codes)

        if stop is not None and stop >= 0:
            return defline, codes[start:stop + 1]
        if start:
            return defline, codes[start:]
        return defline, codes
