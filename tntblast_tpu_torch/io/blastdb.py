# Copy of tntblast_tpu/io/blastdb.py with the package name changed.
"""NCBI BLAST nucleotide database (v4) reader + writer.

The reference reads BLAST databases through the NCBI C++ toolkit's CSeqDB
(reference sequence_data.cpp:28-267, 419-610, compile-gated behind
USE_BLAST_DB) as its recommended fast path (reference README.md:26).
This module provides a native reader for the classic v4 volume format
(.nin/.nhr/.nsq) with the same observable behavior:

  * `read(oid, start, stop)` decodes the 2-bit packed sequence plus the
    ambiguity-correction records into DB_* codes — the analogue of
    CSeqDB::GetAmbigSeq + the NcbiNA8 -> DB_* remap
    (sequence_data.cpp:509-610),
  * deflines come from the .nhr ASN.1 Blast-def-line-set (title + ids),
  * `--blast-include/--blast-exclude` accession filtering restricts the
    visible OIDs (sequence_data.cpp:49-240).

A writer (`create_db`, a makeblastdb-lite) exists so databases can be
produced and the reader tested hermetically: this environment has no NCBI
toolkit or makeblastdb to cross-validate against, so round-trip tests +
hit-list equality against the same data in FASTA form are the correctness
contract (tests/test_blastdb.py).  The on-disk layout follows the
published v4 format (big-endian index fields, the little-endian total-
length quirk, ncbi2na packing with remainder-in-last-byte, old/new
ambiguity records).
"""

import struct

import numpy as np

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.io.fastx import seq_len_increment

# ncbi4na ambiguity nibble -> DB_* code.  ncbi4na is a 4-bit base bitmask
# (A=1, C=2, G=4, T=8); combinations map onto the IUPAC degenerate codes
# (reference sequence_data.cpp:509-610 remap table).
NCBI4NA_TO_DB = np.array([
    C.DB_GAP,   # 0000 gap
    C.DB_A,     # 0001 A
    C.DB_C,     # 0010 C
    C.DB_M,     # 0011 AC
    C.DB_G,     # 0100 G
    C.DB_R,     # 0101 AG
    C.DB_S,     # 0110 CG
    C.DB_V,     # 0111 ACG
    C.DB_T,     # 1000 T
    C.DB_W,     # 1001 AT
    C.DB_Y,     # 1010 CT
    C.DB_H,     # 1011 ACT
    C.DB_K,     # 1100 GT
    C.DB_D,     # 1101 AGT
    C.DB_B,     # 1110 CGT
    C.DB_N,     # 1111 ACGT
], dtype=np.uint8)

DB_TO_NCBI4NA = np.zeros(18, dtype=np.uint8)
for _i, _db in enumerate(NCBI4NA_TO_DB):
    DB_TO_NCBI4NA[_db] = _i
DB_TO_NCBI4NA[C.DB_I] = 15        # inosine has no 4na code; N like CSeqDB
DB_TO_NCBI4NA[C.DB_UNKNOWN] = 15

_2BIT = {C.DB_A: 0, C.DB_C: 1, C.DB_G: 2, C.DB_T: 3}


# ---------------------------------------------------------------------------
# Minimal BER (NCBI binary ASN.1) for Blast-def-line-set:
#   Blast-def-line-set ::= SEQUENCE OF Blast-def-line
#   Blast-def-line ::= SEQUENCE { title [0] VisibleString,
#                                 seqid [1] SEQUENCE OF Seq-id }
#   Seq-id ::= CHOICE { ... local [1] Object-id ... }
#   Object-id ::= CHOICE { id [0] INTEGER, str [1] VisibleString }
# NCBI tools emit indefinite-length constructed BER; so do we.

def _ber_str(tag, s):
    raw = s.encode()
    out = bytearray([tag])
    n = len(raw)
    if n < 128:
        out.append(n)
    else:
        nb = (n.bit_length() + 7) // 8
        out.append(0x80 | nb)
        out += n.to_bytes(nb, "big")
    out += raw
    return bytes(out)


def _ctx(tag_no, content, constructed=True):
    head = 0xA0 | tag_no if constructed else 0x80 | tag_no
    return bytes([head, 0x80]) + content + b"\x00\x00"


def _seq(content):
    return b"\x30\x80" + content + b"\x00\x00"


def encode_deflines(deflines):
    """[(title, local_id_str)] -> Blast-def-line-set BER bytes."""
    body = b""
    for title, sid in deflines:
        fields = _ctx(0, _ber_str(0x1A, title))           # title
        seqid = _ctx(1, _ctx(1, _ber_str(0x1A, sid)))     # local Object-id.str
        fields += _ctx(1, _seq(seqid))                    # seqid SEQUENCE OF
        body += _seq(fields)
    return _seq(body)


class _Ber:
    def __init__(self, data):
        self.d = data
        self.p = 0

    def _head(self):
        tag = self.d[self.p]
        self.p += 1
        ln = self.d[self.p]
        self.p += 1
        if ln == 0x80:
            return tag, -1                                # indefinite
        if ln & 0x80:
            nb = ln & 0x7F
            ln = int.from_bytes(self.d[self.p:self.p + nb], "big")
            self.p += nb
        return tag, ln

    def parse(self):
        """One TLV -> (tag, value): nested list for constructed, bytes for
        primitive."""
        tag, ln = self._head()
        if tag & 0x20:                                    # constructed
            items = []
            if ln < 0:
                while not (self.d[self.p] == 0 and self.d[self.p + 1] == 0):
                    items.append(self.parse())
                self.p += 2
            else:
                end = self.p + ln
                while self.p < end:
                    items.append(self.parse())
            return tag, items
        val = self.d[self.p:self.p + max(ln, 0)]
        self.p += max(ln, 0)
        return tag, val


def decode_deflines(raw):
    """Blast-def-line-set bytes -> [(title, first_id_str_or_None)]."""
    _, dls = _Ber(raw).parse()
    out = []
    for _, fields in dls:
        title = ""
        sid = None
        for tag, val in fields:
            tno = tag & 0x1F
            if tno == 0:                                  # title
                v = val[0][1] if isinstance(val, list) else val
                title = bytes(v).decode("latin1")
            elif tno == 1 and sid is None:                # seqid list
                sid = _first_string(val)
        out.append((title, sid))
    return out


def _first_string(node):
    if isinstance(node, (bytes, bytearray)):
        return bytes(node).decode("latin1")
    if isinstance(node, list):
        for _, child in node:
            got = _first_string(child)
            if got is not None:
                return got
    return None


# ---------------------------------------------------------------------------

def create_db(base, records, title="tntblast_tpu_torch db", version=4,
              taxids=None):
    """Write a v4 or v5 nucleotide volume (.nin/.nhr/.nsq).

    records: [(defline, db_codes uint8 array)]; the defline's first word
    becomes the sequence id (the accession used by --blast-include).
    version=5 additionally writes the `<base>.ndb` LMDB accession index
    (sub-database ACC2OID: accession -> u32 OID) and, when `taxids` is
    given ([taxid_per_record]), the TAXID2OIDS taxonomy index
    (u32 taxid -> packed u32 OID array) used for numeric
    --blast-include/--blast-exclude entries (reference
    sequence_data.cpp:49-240 TaxIdsToOids semantics).
    """
    import datetime

    nhr = bytearray()
    nsq = bytearray(b"\x00")      # CSeqDB volumes start with a NUL byte
    hdr_off = [len(nhr)]
    seq_off = [len(nsq)]
    amb_off = []
    max_len = 0
    total = 0

    for defline, codes in records:
        sid = defline.split()[0] if defline.split() else "lcl|seq"
        nhr += encode_deflines([(defline, sid)])
        hdr_off.append(len(nhr))

        codes = np.asarray(codes, dtype=np.uint8)
        n = len(codes)
        max_len = max(max_len, n)
        total += n
        # 2-bit packing; ambiguous bases packed as their 2-bit low bits
        # with a correction record (matches formatdb/makeblastdb)
        two = np.zeros(n, dtype=np.uint8)
        amb_runs = []                 # (ncbi4na, start, length)
        for i, c in enumerate(codes):
            b = _2BIT.get(int(c))
            if b is None:
                ch = int(DB_TO_NCBI4NA[c])
                two[i] = 0            # arbitrary packed bits under a mask
                if (amb_runs and amb_runs[-1][0] == ch
                        and amb_runs[-1][1] + amb_runs[-1][2] == i
                        and amb_runs[-1][2] < 4096):
                    amb_runs[-1][2] += 1
                else:
                    amb_runs.append([ch, i, 1])
            else:
                two[i] = b
        npack = (n + 3) // 4
        packed = np.zeros(npack, dtype=np.uint8)
        for k in range(4):
            seg = two[k::4]
            packed[:len(seg)] |= seg << (2 * (3 - k))
        # last byte layout: remainder bases in high bits, count in low 2
        rem = n % 4
        if rem == 0:
            packed = np.concatenate([packed, np.zeros(1, np.uint8)])
        else:
            packed[-1] = (int(packed[-1]) & 0xFC) | rem
        nsq += packed.tobytes()
        amb_off.append(len(nsq))
        # new-format (64-bit) ambiguity records
        words = [np.uint32(0x80000000 | (2 * len(amb_runs)))]
        for ch, start, length in amb_runs:
            words.append(np.uint32((ch << 28) | ((length - 1) << 16)
                                   | (start >> 32)))
            words.append(np.uint32(start & 0xFFFFFFFF))
        nsq += b"".join(struct.pack(">I", int(w)) for w in words)
        seq_off.append(len(nsq))

    date = datetime.date(2026, 1, 1).strftime("%b %d, %Y")
    volname = base.rsplit("/", 1)[-1]
    nin = bytearray()
    nin += struct.pack(">I", version)             # format version
    nin += struct.pack(">I", 0)                   # 0 = nucleotide
    nin += struct.pack(">I", len(title)) + title.encode()
    if version == 5:
        # v5 inserts the LMDB volume-name string after the title
        nin += struct.pack(">I", len(volname)) + volname.encode()
    nin += struct.pack(">I", len(date)) + date.encode()
    nin += struct.pack(">I", len(records))
    nin += struct.pack("<Q", total)               # the little-endian quirk
    nin += struct.pack(">I", max_len)
    for off in hdr_off:
        nin += struct.pack(">I", off)
    for off in seq_off:
        nin += struct.pack(">I", off)
    for i in range(len(records)):
        nin += struct.pack(">I", amb_off[i])
    nin += struct.pack(">I", seq_off[-1])         # trailing amb sentinel

    open(base + ".nin", "wb").write(nin)
    open(base + ".nhr", "wb").write(nhr)
    open(base + ".nsq", "wb").write(nsq)

    if version == 5:
        from tntblast_tpu_torch.io.lmdb import write_env
        acc2oid = {}
        for oid, (defline, _) in enumerate(records):
            words = defline.split()
            acc = words[0] if words else f"lcl|seq{oid}"
            acc2oid[acc.encode()] = struct.pack("<I", oid)
            if "." in acc:
                # versionless alias, like the NCBI index
                acc2oid.setdefault(acc.rsplit(".", 1)[0].encode(),
                                   struct.pack("<I", oid))
        dbs = {"ACC2OID": acc2oid}
        if taxids is not None:
            tax = {}
            for oid, t in enumerate(taxids):
                tax.setdefault(int(t), []).append(oid)
            dbs["TAXID2OIDS"] = {
                struct.pack("<I", t): struct.pack(f"<{len(oids)}I", *oids)
                for t, oids in tax.items()}
        write_env(base + ".ndb", dbs)


class BlastDb:
    """Random-access reader over one v4 nucleotide volume, presenting the
    SequenceDatabase interface the engine consumes (io/fastx.py)."""

    def __init__(self, base, include=None, exclude=None):
        nin = open(base + ".nin", "rb").read()
        p = 0

        def be32():
            nonlocal p
            v = struct.unpack_from(">I", nin, p)[0]
            p += 4
            return v

        version = be32()
        if version not in (4, 5):
            raise ValueError(f"unsupported BLAST db version {version}")
        seqtype = be32()
        if seqtype != 0:
            raise ValueError("not a nucleotide BLAST database")
        tl = be32()
        self.title = nin[p:p + tl].decode("latin1")
        p += tl
        if version == 5:
            # v5 inserts an LMDB volume-name string after the title
            vl = be32()
            p += vl
        dl = be32()
        p += dl
        nseq = be32()
        self.total_length = struct.unpack_from("<Q", nin, p)[0]
        p += 8
        self.max_len = be32()
        offs = np.frombuffer(nin, dtype=">u4", count=3 * (nseq + 1),
                             offset=p)
        self.hdr_off = offs[:nseq + 1].astype(np.int64)
        self.seq_off = offs[nseq + 1:2 * nseq + 2].astype(np.int64)
        self.amb_off = offs[2 * nseq + 2:].astype(np.int64)

        self.nhr = open(base + ".nhr", "rb").read()
        self.nsq = np.frombuffer(open(base + ".nsq", "rb").read(),
                                 dtype=np.uint8)
        self.n_vol = nseq

        # v5 LMDB indices (reference CSeqDB AccessionToOids /
        # TaxIdsToOids, sequence_data.cpp:89-196): accession -> OID and
        # numeric taxid -> OID-list lookups.
        self._lmdb = None
        if version == 5:
            try:
                from tntblast_tpu_torch.io.lmdb import LmdbEnv
                self._lmdb = LmdbEnv(base + ".ndb")
            except (OSError, ValueError):
                self._lmdb = None

        # OID filtering (reference sequence_data.cpp:49-240): entries
        # that parse as unsigned integers are taxids, everything else is
        # an accession; include restricts, exclude removes.
        oid_include = set()
        oid_exclude = set()
        for entries, out, kind in ((include or [], oid_include, "included"),
                                   (exclude or [], oid_exclude, "excluded")):
            for entry in entries:
                if entry.isdigit():
                    oids = self._taxid_to_oids(int(entry))
                    if oids is None:
                        raise ValueError(
                            f"Unable to find an {kind} TaxID in BLAST "
                            "database")
                else:
                    oids = self._accession_to_oids(entry)
                    if not oids:
                        raise ValueError(
                            f"Unable to find an {kind} accession in BLAST "
                            "database")
                out.update(oids)

        self.oids = [oid for oid in range(nseq)
                     if (not include or oid in oid_include)
                     and oid not in oid_exclude]

        self._lens = [int(self._seq_len(o)) for o in self.oids]

    def _accession_to_oids(self, acc):
        """CSeqDB::AccessionToOids: v5 resolves through the LMDB ACC2OID
        index; v4 falls back to a defline scan (the stand-in for the v4
        ISAM string index)."""
        if self._lmdb is not None:
            raw = self._lmdb.get(acc.encode(), db="ACC2OID")
            if raw is None:
                return []
            return [struct.unpack_from("<I", raw, i)[0]
                    for i in range(0, len(raw), 4)]
        out = []
        for oid in range(self.n_vol):
            title, sid = self._defline(oid)
            first = title.split()[0] if title.split() else ""
            if acc in (sid, first):
                out.append(oid)
        return out

    def _taxid_to_oids(self, taxid):
        """CSeqDB::TaxIdsToOids via the TAXID2OIDS LMDB table; None when
        the database carries no taxonomy index or the taxid is absent
        (the reference THROWs in both cases).

        Supported schema (documented limitation): taxonomy lives as a
        TAXID2OIDS sub-db inside the .ndb LMDB volume, as written by
        blastdb.create_db.  Genuine makeblastdb v5 databases keep
        taxid->OID mappings in separate .nto/.ntf files with different
        sub-db naming; reading those needs a real NCBI fixture to
        validate against, which this environment cannot produce (no
        makeblastdb/liblmdb, no network).  --blast-include/-exclude with
        a numeric taxid on such a database raises the same loud
        'Unable to find TaxID' error the reference raises for databases
        without taxonomy."""
        if self._lmdb is None:
            return None
        try:
            raw = self._lmdb.get(struct.pack("<I", taxid), db="TAXID2OIDS")
        except ValueError:
            return None
        if raw is None:
            return None
        return [struct.unpack_from("<I", raw, i)[0]
                for i in range(0, len(raw), 4)]

    # -- SequenceDatabase interface ------------------------------------
    def is_annot_format(self):
        return False

    def size(self):
        return len(self.oids)

    def effective_size(self, max_len):
        total = 0
        for L in self._lens:
            total += 1 if max_len >= L else seq_len_increment(L, max_len)[1]
        return total

    def approx_seq_len(self, i):
        if i >= len(self._lens):
            return 0
        return self._lens[i]

    def _seq_len(self, oid):
        # final packed byte carries the base-count remainder in its low
        # 2 bits (a whole extra byte when the length is a multiple of 4)
        npack = int(self.amb_off[oid] - self.seq_off[oid])
        rem = int(self.nsq[self.amb_off[oid] - 1]) & 0x03
        return (npack - 1) * 4 + rem

    def _defline(self, oid):
        raw = self.nhr[self.hdr_off[oid]:self.hdr_off[oid + 1]]
        dl = decode_deflines(raw)
        return dl[0] if dl else ("", None)

    def defline(self, idx):
        title, _ = self._defline(self.oids[idx])
        return title

    def read(self, idx, start=0, stop=-1):
        oid = self.oids[idx]
        title, _ = self._defline(oid)
        n = self._seq_len(oid)

        packed = self.nsq[self.seq_off[oid]:self.amb_off[oid]]
        base2 = np.zeros(len(packed) * 4, dtype=np.uint8)
        for k in range(4):
            base2[k::4] = (packed >> (2 * (3 - k))) & 3
        codes = np.array([C.DB_A, C.DB_C, C.DB_G, C.DB_T],
                         np.uint8)[base2[:n]]

        # ambiguity corrections
        amb = self.nsq[self.amb_off[oid]:self.seq_off[oid + 1]]
        if len(amb) >= 4:
            words = np.frombuffer(amb.tobytes(), dtype=">u4")
            count = int(words[0])
            new_fmt = bool(count & 0x80000000)
            count &= 0x7FFFFFFF
            i = 1
            while i <= count:
                w = int(words[i])
                ch = w >> 28
                if new_fmt:
                    length = ((w >> 16) & 0xFFF) + 1
                    off = ((w & 0xFFFF) << 32) | int(words[i + 1])
                    i += 2
                else:
                    length = ((w >> 24) & 0xF) + 1
                    off = w & 0xFFFFFF
                    i += 1
                codes[off:off + length] = NCBI4NA_TO_DB[ch]

        if stop is not None and stop >= 0:
            codes = codes[start:stop + 1]
        elif start:
            codes = codes[start:]
        return title, codes
