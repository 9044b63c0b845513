# Copy of tntblast_tpu/io/annot.py with the package name changed.
"""GBK / EMBL annotated-sequence databases.

Reimplements the reference's flat-file parsers (reference:
annotation_gbk.cpp, annotation_embl.cpp, annotation.cpp,
sequence_data_annot.cpp) with the same observable behavior:

  - features recognized by the first word of the 21-column key field:
    CDS / SOURCE (skipped) / GENE / TRNA / *RNA* (substring) / USER /
    everything else = misc (IMP); BASE, CONTIG, ORIGIN, WGS and "//"
    end the feature block (annotation_gbk.cpp next_key_GBK),
  - 1-based locations parsed to 0-based [start, stop]; complement(),
    join()/order() (+ join(complement()) ) with multi-line continuation;
    segment lists sorted; "<"/">" ignored (annotation_util.cpp:17-291),
  - qualifier values: single-line, boolean, or multi-line quoted strings
    joined with single spaces (annotation_gbk.cpp parse_field_GBK),
  - a CDS / RNA / tRNA immediately following a gene with the identical
    range merges its qualifiers into that gene; a standalone CDS is
    promoted to GENE by /product; /pseudo makes a PSEUDO_GENE
    (annotation_gbk.cpp:244-310, 342-400),
  - after the sequence is read, annotations are sorted and intergenic
    spaces inserted into gaps (annotation.cpp processGeneList; the
    reference's tail-space branch is dead code — no tail space),
  - per-record defline = accession + " " + source-organism
    (sequence_data.cpp read_bio_seq_annot:652).

The reference's EMBL reader is broken upstream (next_key_EMBL throws on
every call because `if(gzread(..)) THROW` fires on *success*,
annotation_embl.cpp; verified empirically: every EMBL input dies with
":next_key_EMBL: Unable to read next annotation key").  This module
implements EMBL per the format spec / the reference's intent instead of
reproducing the crash.
"""

import gzip

import numpy as np

from tntblast_tpu_torch.constants import ASCII_TO_DB
from tntblast_tpu_torch.io.fastx import seq_len_increment

# GeneAnnotation types (annotation.h:29-52)
A_NONE, A_CDS, A_GENE, A_PSEUDO, A_RNA, A_tRNA, A_IMP, A_PRIMER, \
    A_TFBS, A_USER = range(10)

TYPE_LABEL = {
    A_CDS: "CDS", A_GENE: "gene", A_PSEUDO: "pseudo-gene", A_RNA: "RNA",
    A_tRNA: "tRNA", A_TFBS: "TFBS", A_IMP: "misc", A_PRIMER: "primer",
    A_USER: "user", A_NONE: "intergenic space",
}


class GeneAnnotation:
    __slots__ = ("type", "start", "stop", "complement", "segments",
                 "info", "ids")

    def __init__(self):
        self.type = A_NONE
        self.start = 0
        self.stop = 0
        self.complement = False
        self.segments = []
        self.info = {}
        self.ids = []

    # reference annotation.h:163-176 / 207-210
    def seq_id_str(self):
        return "|".join(self.ids)

    def name(self):
        return self.info.get("LOCUS") or self.info.get("LOCUS_TAG", "")

    def overlaps_origin(self):
        return self.start > self.stop

    def sort_key(self):
        # operator< (annotation.h:101-125): origin-overlappers first
        return (0 if self.overlaps_origin() else 1, self.start, self.stop)

    def handle_gene_start_overlap(self, genome_len):
        """annotation.h:374-412"""
        if self.start == 0 and self.segments:
            tmp_start = tmp_stop = 0
            for s, e in self.segments:
                if s == 0:
                    tmp_stop = e
                if e == genome_len - 1:
                    tmp_start = s
            if tmp_start != 0 and tmp_stop != 0:
                self.segments = []
                self.start = tmp_start
                self.stop = tmp_stop
                return True
        if self.stop >= genome_len:
            self.stop -= genome_len
            return True
        return False


class DNAMol:
    def __init__(self):
        self.accession = ""
        self.taxa_name = ""
        self.seq = None           # uint8 DB codes
        self.annotations = []

    def defline(self):
        return self.accession + " " + self.taxa_name

    def num_bases(self):
        return 0 if self.seq is None else len(self.seq)

    def process_gene_list(self):
        """annotation.cpp:158-252 (loading=True path)."""
        n = self.num_bases()
        for g in self.annotations:
            g.handle_gene_start_overlap(n)
        self.annotations.sort(key=GeneAnnotation.sort_key)

        if not self.annotations:
            if n != 0:
                space = GeneAnnotation()
                space.start, space.stop = 0, n - 1
                self.annotations.append(space)
            return

        out = []
        last_stop_plus_1 = 0
        for g in self.annotations:
            if g.start <= g.stop and g.start > last_stop_plus_1:
                space = GeneAnnotation()
                space.start = last_stop_plus_1
                space.stop = g.start - 1
                out.append(space)
            last_stop_plus_1 = max(last_stop_plus_1, g.stop + 1)
            out.append(g)
        # The reference's tail-space branch can never fire
        # (annotation.cpp:225-250 compares seq_len-1 != seq_len-1).
        self.annotations = out


# ---------------------------------------------------------------------------
# location + qualifier parsing (shared by GBK and EMBL)

def parse_location(text, more_lines):
    """(start, stop, complement, segments) from a feature location.

    `text` is the location field; `more_lines` is a callable returning the
    next continuation line (feature-content column already stripped) when
    the parenthesis are unbalanced (annotation_util.cpp read_range).
    """
    buf = text
    while buf.count("(") != buf.count(")"):
        buf += more_lines()

    i = 0
    s = buf.strip()
    is_complement = False
    if s.startswith("complement("):
        is_complement = True
        s = s[len("complement("):]
    if s.startswith("join("):
        s = s[len("join("):]
    elif s.startswith("order("):
        s = s[len("order("):]
    if s.startswith("complement("):   # join(complement( -- NC_005213 case
        is_complement = True
        s = s[len("complement("):]
    del i

    # walk digit runs, pairing them into segments; a number followed by
    # ',' or ')' (or end) is a single-base segment
    segs = []
    num = ""
    pending = None
    k = 0
    while k <= len(s):
        c = s[k] if k < len(s) else ","
        if c.isdigit():
            num += c
        else:
            if num:
                v = int(num) - 1
                num = ""
                if pending is None:
                    pending = [v, v]
                    # look ahead: does a second number belong to this seg?
                    # ".." continues the segment; ',' or ')' closes it
                    j = k
                    closed = False
                    while j < len(s) and not s[j].isdigit():
                        if s[j] in ",)":
                            closed = True
                        j += 1
                    if closed or j >= len(s):
                        segs.append((pending[0], pending[1]))
                        pending = None
                else:
                    pending[1] = v
                    segs.append((pending[0], pending[1]))
                    pending = None
        k += 1
    if pending is not None:
        segs.append((pending[0], pending[1]))

    if not segs:
        raise ValueError("read_range: Unable to read location: " + buf)

    if len(segs) == 1:
        start, stop = segs[0]
        return start, stop, is_complement, []
    segs.sort()
    return segs[0][0], segs[-1][1], is_complement, segs


class _FieldParser:
    """Qualifier parsing over a line stream (parse_field_GBK semantics).

    `next_content` yields the next continuation line with any
    format-prefix ("FT" for EMBL) already stripped."""

    def __init__(self, next_content):
        self.next_content = next_content

    def parse(self, first):
        """Parse one qualifier starting at `first` (content text).
        Returns (key, value)."""
        text = first
        p = text.find("/")
        if p < 0:
            raise ValueError("parse_field: Unable to find key start")
        text = text[p + 1:]
        eq = text.find("=")
        if eq < 0:
            return text.split()[0] if text.split() else "", ""
        key = text[:eq].rstrip()
        val = text[eq + 1:].lstrip()

        paren = 1 if val.startswith("(") else 0
        if paren == 0 and not val.startswith('"'):
            return key, val.rstrip()

        if paren == 0:
            val = val[1:]
        out = ""
        cur = val
        while True:
            cur = cur.rstrip()
            if paren == 0 and cur.endswith('"') and (cur or out):
                out += cur[:-1]
                return key, out
            if paren and cur.endswith(")"):
                bal = paren + cur[1:].count("(") - cur[1:].count(")")
                if bal == 0:
                    out += cur
                    return key, out
            if cur:
                out += cur + " "
            nxt = self.next_content()
            if nxt is None:
                raise ValueError("Unexpected end of file in qualifier")
            cur = nxt.strip()


class _LineReader:
    def __init__(self, lines, pos=0):
        self.lines = lines
        self.pos = pos

    def next_line(self):
        if self.pos >= len(self.lines):
            return None
        s = self.lines[self.pos]
        self.pos += 1
        return s

    def peek(self):
        if self.pos >= len(self.lines):
            return None
        return self.lines[self.pos]

    def push_back(self):
        self.pos -= 1


# ---------------------------------------------------------------------------
# GBK

GBK_KEY_COL = 21       # feature key field width (next_key_GBK reads 21 bytes)

_GBK_SEQ_MAP = ASCII_TO_DB   # same letter->code mapping as FASTA


def _classify_feature(word):
    w = word.upper()
    if w.startswith(("BASE", "CONTIG", "ORIGIN")) or w.startswith("//"):
        return "END"
    if w.startswith("CDS"):
        return "CDS"
    if w.startswith("SOURCE"):
        return "SOURCE"
    if w.startswith("GENE"):
        return "GENE"
    if w.startswith("TRNA"):
        return "tRNA"
    if "RNA" in w:
        return "RNA"
    if w.startswith("USER"):
        return "USER"
    if w.startswith("WGS"):
        return "WGS"
    return "IMP"


_FEATURE_TYPE = {"CDS": A_CDS, "GENE": A_GENE, "RNA": A_RNA,
                 "tRNA": A_tRNA, "IMP": A_IMP, "USER": A_USER}


def _apply_field(annot, key, val, merged):
    """Qualifier -> annotation fields (parse_cds_GBK etc.).  `merged` is
    True when copying into a preceding gene record (no /product
    promotion in that overload)."""
    if key == "gene":
        annot.info["LOCUS"] = val
    elif key == "locus_tag":
        annot.info["LOCUS_TAG"] = val
    elif key == "note":
        annot.info["NOTE"] = val
    elif key == "product":
        if not merged and annot.type == A_CDS:
            annot.type = A_GENE
        annot.info["PRODUCT"] = val
    elif key == "EC_number":
        annot.info["EC"] = val
    elif key in ("protein_id", "db_xref"):
        annot.ids.append(val)
    elif key == "pseudo":
        annot.type = A_PSEUDO


def _parse_features(reader, key_col, is_feature_line, strip_prefix):
    """Shared GBK/EMBL feature-block parser.

    is_feature_line(line) -> False when the block ends at this line;
    strip_prefix(line) -> the 80-column feature text (EMBL drops "FT").
    """
    annotations = []
    last_was_gene = False

    while True:
        raw = reader.peek()
        if raw is None:
            break
        if not is_feature_line(raw):
            break
        reader.next_line()
        line = strip_prefix(raw)
        keyfield = line[:key_col]
        if keyfield.strip() == "":
            # stray qualifier/continuation outside a feature: discarded
            # (loadGBKFeatures GBK_ANNOT_NONE path)
            continue
        word = keyfield.split()[0]
        kind = _classify_feature(word)
        if kind == "END":
            reader.push_back()
            break
        if kind in ("SOURCE", "WGS"):
            last_was_gene = False
            continue

        def more():
            nxt = reader.next_line()
            if nxt is None:
                raise ValueError("read_range: unexpected EOF")
            return strip_prefix(nxt)

        start, stop, comp, segs = parse_location(line[key_col:], more)

        merged = False
        if kind in ("CDS", "RNA", "tRNA") and last_was_gene and annotations:
            prev = annotations[-1]
            if prev.start == start and prev.stop == stop:
                target = prev
                merged = True
        if not merged:
            target = GeneAnnotation()
            target.type = _FEATURE_TYPE[kind]
            target.start, target.stop = start, stop
            target.complement = comp
            target.segments = segs
            annotations.append(target)

        # qualifiers: following lines with a blank key field
        fp = _FieldParser(more)
        while True:
            nxt = reader.peek()
            if nxt is None:
                break
            if not is_feature_line(nxt):
                break
            content = strip_prefix(nxt)
            if content[:key_col].strip() != "":
                break
            reader.next_line()
            body = content[key_col:]
            if "/" not in body:
                continue
            k, v = fp.parse(body)
            _apply_field(target, k, v, merged)

        last_was_gene = (kind == "GENE")

    return annotations


def _read_text(path):
    with open(path, "rb") as fh:
        head = fh.read(2)
    if head == b"\x1f\x8b":
        with gzip.open(path, "rb") as fh:
            data = fh.read()
    else:
        with open(path, "rb") as fh:
            data = fh.read()
    return data.decode("latin1").splitlines()


def _seq_from_lines(lines):
    txt = "".join(lines)
    arr = np.frombuffer(txt.encode("latin1"), np.uint8)
    letter = ((arr >= ord("A")) & (arr <= ord("Z"))) \
        | ((arr >= ord("a")) & (arr <= ord("z")))
    return ASCII_TO_DB[arr[letter]]


def parse_gbk(path):
    reader = _LineReader(_read_text(path))
    mols = []
    mol = None
    feature_lines_end = ("ORIGIN", "BASE", "CONTIG", "//")

    while True:
        line = reader.next_line()
        if line is None:
            break
        word = line[:12].split()[0].upper() if line[:12].split() else ""
        if word.startswith("LOCUS"):
            mol = DNAMol()
            # reference defaults info_map[SOURCE]="Unknown"; TAXA_NAME
            # stays empty unless a SOURCE key is read
        elif mol is None:
            continue
        elif word.startswith("ACCESSION"):
            toks = line.split()
            if len(toks) > 1:
                mol.accession = toks[1]
            else:
                # accession token may be on the next line
                nxt = reader.peek()
                if nxt and nxt.split():
                    mol.accession = nxt.split()[0]
                    reader.next_line()
        elif word.startswith("SOURCE"):
            mol.taxa_name = " ".join(line.split()[1:])
        elif word.startswith("FEATURES"):
            def is_feat(l):
                w = l[:12].split()[0].upper() if l[:12].split() else None
                if w is None:
                    return True
                return not any(w.startswith(e) for e in feature_lines_end)
            mol.annotations = _parse_features(
                reader, GBK_KEY_COL,
                is_feature_line=is_feat,
                strip_prefix=lambda l: l)
        elif word.startswith("ORIGIN"):
            seq_lines = []
            while True:
                l = reader.next_line()
                if l is None or l.startswith("//"):
                    break
                seq_lines.append("".join(
                    c for c in l if not (c.isdigit() or c.isspace())))
            mol.seq = _seq_from_lines(seq_lines)
            mol.process_gene_list()
            mols.append(mol)
            mol = None
    # The reference's load_gbk loop keeps the trailing empty DNAMol it
    # allocated before hitting EOF (sequence_data_annot.cpp:27-37: the
    # pop-if-empty check is unreachable once load() returns false), so a
    # GBK database reports one extra, empty sequence.  load_embl pops it
    # (sequence_data_annot.cpp:82-84).
    mols.append(DNAMol())
    return mols


# ---------------------------------------------------------------------------
# EMBL

EMBL_KEY_COL = 19      # feature key field width after the "FT" prefix


def parse_embl(path):
    reader = _LineReader(_read_text(path))
    mols = []
    mol = DNAMol()

    while True:
        line = reader.next_line()
        if line is None:
            break
        code = line[:2].upper()
        if code == "ID":
            mol = DNAMol()
        elif code == "AC":
            toks = line[2:].split()
            if toks:
                mol.accession = toks[0].rstrip(";")
        elif code == "OS":
            mol.taxa_name = " ".join(line[2:].split())
        elif code == "FT":
            reader.push_back()
            mol.annotations = _parse_features(
                reader, EMBL_KEY_COL,
                is_feature_line=lambda l: l[:2].upper() == "FT",
                strip_prefix=lambda l: l[2:])
        elif code == "SQ":
            seq_lines = []
            while True:
                l = reader.next_line()
                if l is None or l.startswith("//"):
                    break
                seq_lines.append("".join(
                    c for c in l if not (c.isdigit() or c.isspace())))
            mol.seq = _seq_from_lines(seq_lines)
            mol.process_gene_list()
            mols.append(mol)
            mol = DNAMol()
    return mols


# ---------------------------------------------------------------------------

class AnnotatedDatabase:
    """sequence_data facade for GBK/EMBL files (sequence_data_annot.cpp)."""

    def __init__(self, path, fmt):
        self.path = path
        self.format = fmt
        self.mols = parse_gbk(path) if fmt == "GBK" else parse_embl(path)

    def is_annot_format(self):
        return True

    def size(self):
        return len(self.mols)

    def effective_size(self, max_len):
        total = 0
        for m in self.mols:
            L = m.num_bases()
            total += 1 if max_len >= L else seq_len_increment(L, max_len)[1]
        return total

    def approx_seq_len(self, i):
        if i >= len(self.mols):
            return 0
        return self.mols[i].num_bases()

    def annot(self, i):
        return self.mols[i]

    def defline(self, idx):
        return self.mols[idx].defline()

    def read(self, idx, start=0, stop=-1):
        m = self.mols[idx]
        n = m.num_bases()
        if stop < 0 or stop >= n:
            stop = n - 1
        if start > stop:
            return m.defline(), np.zeros(0, dtype=np.uint8)
        return m.defline(), m.seq[start:stop + 1]

    def write_annotation(self, fout, sig):
        """Print every annotation overlapping the hit (reference
        tntblast_util.cpp:1337-1450 write_annotation)."""
        if sig.seq_index < 0:
            return
        mol = self.mols[sig.seq_index]
        if sig.amplicon_range == (0, 0):
            start, stop = sig.probe_range
        else:
            start, stop = sig.amplicon_range
        for g in mol.annotations:
            if g.start > stop or g.stop < start:
                continue
            label = TYPE_LABEL.get(g.type, "unknown")
            if g.type == A_NONE:
                fout.write(f"annotation({label})[{g.start}..{g.stop}]")
            else:
                strand = "-" if g.complement else "+"
                fout.write(
                    f"annotation({label})[{g.start}..{g.stop}]{strand}:")
            for txt in (g.seq_id_str(), g.name(),
                        g.info.get("PRODUCT", "")):
                if txt:
                    fout.write(" " + txt)
            note = g.info.get("NOTE", "")
            if note:
                fout.write(" " + note.replace("\n", "").replace("\r", ""))
            fout.write("\n")
