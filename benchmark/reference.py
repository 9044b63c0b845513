"""The plain reference that judges a search's hit list.

It imports nothing of the program.  It reads the database and the queries
the benchmark generated, and the output file a search wrote, and works
out again what the output states:

  - every record: its target sequence is the database's at the printed
    range (either strand; a range over a record's end reads its last
    bases), each oligo's aligned target bases lie in the database beside
    it, each oligo's Tm is at or above its role's minimum (`-e` primers,
    `-E` probes and padlock arms), no two records are the same, and each
    oligo's Tm, dH, dS, dG, mismatches and gaps are those of its printed
    alignment as the nearest-neighbour model scores it
    (benchmark/nucruc.py), whatever its mismatches, loops and bulges;
  - slices of the database drawn from the run's seed: there the
    reference works the hit list out again on its own.  It seeds each
    oligo on each strand by its exact words (`-W`, 7 by default), takes
    each seed diagonal's window (the oligo and 4 bases each side),
    aligns and scores it (nucruc), keeps the bindings that pass the
    search's thresholds (one a pair of ends, the highest Tm), and pairs
    them as the assay does: a PCR product from a primer bound on the
    minus strand and one bound on the plus strand after it, at most `-l`
    bases end to end (any two of the assay's primers, as a single primer
    can prime both ends); a padlock from its two arms bound back to back
    on one strand.  Every record whose range lies in a slice's interior
    has to be one the reference finds there, and every product the
    reference finds there has to be a record;
  - planted sites: every site the generator planted for an assay of the
    searched panel is a record of that assay at that range.

A product the reference cannot call for certain is allowed but not
required: one of an oligo bound where its score reads one base past the
oligo's 3' end from a buffer that the program fills from earlier oligos
(nucruc's "stale slot"), one whose ends tie in Tm with another alignment
of different content, and a PCR product within 100 bases of `-l`, where
the program's pruning of seeds by their positions may drop it.  The
slices keep `GUARD` bases from the ends of the search's fragments, so
that no product there is seen by two fragments or cut by one.

`dtype` "bfloat16" scores the printed alignments with every operation
rounded to bfloat16: the control, which has to fail.
"""

import numpy as np

import nucruc

f32 = np.float32

# search defaults (tntblast README): salt, primer and probe strand
# concentrations, forward/reverse ratio, temperature, thresholds, the
# longest product and the seed word
DEFAULTS = {"-s": 0.05, "-t": 9e-7, "-T": 2.5e-7, "-y": 1.0,
            "--temperature": 310.15, "-e": 0.0, "-E": 0.0, "-l": 2000,
            "-W": 7}
FLANK = 4               # target bases each side of an oligo's window
FRAGMENT = 500000       # the length the search cuts long records to
GUARD = 3000            # bases a slice keeps from a fragment's ends
MARGIN = 2300           # bases of a slice's edges whose records are not
                        # compared (a product's ends and the seeds near)
_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s):
    return s.translate(_COMP)[::-1]


def codes(s):
    """ACGT text as codes 0-3."""
    lut = np.full(256, 255, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    out = lut[np.frombuffer(s.encode("latin1"), np.uint8)]
    if (out == 255).any():
        raise ValueError("bases other than A, C, G, T")
    return out


# -- the output ------------------------------------------------------------

ROLES = ("forward primer", "reverse primer", "5' probe", "3' probe",
         "probe")


def parse_records(text):
    """The records of a standard output file: a list of dicts with the
    assay `name`, the `range` (lo, hi, 0-based inclusive), `strand`,
    `defline`, `sequence` and per oligo role {seq, tm, dH, dS, dG, mm,
    gaps, align: (query, marks, target)}."""
    records = []
    for block in text.split("\nname = ")[1:]:
        lines = block.split("\n")
        rec = {"name": lines[0], "oligos": {}, "range": None,
               "strand": None, "defline": None, "sequence": None}
        align = {}
        for i, ln in enumerate(lines[1:], 1):
            if ln.startswith(">"):
                rec["defline"] = ln[1:].split()[0]
                rec["sequence"] = lines[i + 1]
                break
            if " range = " in ln and rec["range"] is None:
                lo, hi = ln.split(" = ")[1].split(" .. ")
                rec["range"] = (int(lo), int(hi))
            elif ln.endswith("(+)") or ln.endswith("(-)"):
                rec["strand"] = ln[-2]
            for role in ROLES:
                if not ln.startswith(role + " "):
                    continue
                rest = ln[len(role) + 1:]
                o = rec["oligos"].setdefault(role, {})
                if rest.startswith("= 5' "):
                    o["seq"] = rest[5:-3]
                elif rest.startswith("tm = "):
                    o["tm"] = float(rest[5:])
                elif rest.startswith("dG["):
                    dg, dh, ds = (float(x.split("]")[0])
                                  for x in rest.split("[")[1:])
                    o.update(dG=dg, dH=dh, dS=ds)
                elif rest.startswith("mismatches = "):
                    o["mm"] = int(rest.split(" = ")[1])
                elif rest.startswith("gaps = "):
                    o["gaps"] = int(rest.split(" = ")[1])
                elif rest.startswith("align "):
                    align.setdefault(role, []).append(rest[6:])
                break
        for role, rows in align.items():
            if len(rows) == 3:
                rec["oligos"][role]["align"] = (rows[0][3:-3], rows[1][3:],
                                                rows[2][3:-3])
        records.append(rec)
    return records


def search_params(argv):
    """The reference's own reading of a search's options."""
    p = dict(DEFAULTS, **{"-A": "PCR"})
    for i, a in enumerate(argv):
        if a in p and i + 1 < len(argv):
            p[a] = argv[i + 1] if a == "-A" else float(argv[i + 1])
    fwd = p["-t"] * p["-y"]
    conc = {"forward primer": fwd, "reverse primer": p["-t"],
            "5' probe": fwd, "3' probe": p["-t"], "probe": p["-T"]}
    min_tm = {"forward primer": p["-e"], "reverse primer": p["-e"],
              "5' probe": p["-E"], "3' probe": p["-E"], "probe": p["-E"]}
    return {"format": p["-A"], "conc": conc, "min_tm": min_tm,
            "salt": p["-s"], "temperature": p["--temperature"],
            "max_len": int(p["-l"]), "word": int(p["-W"])}


def read_queries(path):
    """[(assay name, first oligo, second oligo)] of a query file."""
    out = []
    with open(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) >= 3:
                out.append((f[0], f[1].upper(), f[2].upper()))
    return out


def read_fasta(path):
    """{first word of the defline: uppercase sequence}."""
    out, name, parts = {}, None, []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(parts).upper()
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line.strip())
    if name is not None:
        out[name] = "".join(parts).upper()
    return out


# -- the slices ------------------------------------------------------------

def fasta_spans(path):
    """{first word of the defline: the record's bytes in the file, from its
    '>' to the next one}: the length the search cuts a FASTA record by
    (tntblast's sequence_data reads it as the record's approximate
    length)."""
    out, name, start, pos = {}, None, 0, 0
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    out[name] = pos - start
                name, start = line[1:].split()[0].decode("latin1"), pos
            pos += len(line)
    if name is not None:
        out[name] = pos - start
    return out


def fragments(length, approx=None, max_len=FRAGMENT):
    """[(start, stop)] of the bases of the fragments the search cuts a
    record of `length` bases into: the fewest n with approx / n <=
    max_len, fragments of approx / n (rounded up) counted on the
    record's `approx` length, as far as its bases reach."""
    approx = length if approx is None else approx
    if approx <= max_len:
        return [(0, length - 1)]
    n = 2
    while approx > n * max_len:
        n += 1
    delta = approx // n + (1 if approx % n else 0)
    out, start, stop = [], 0, delta
    while start <= length - 1:
        out.append((start, min(stop, length - 1)))
        if stop == approx - 1:
            break
        start, stop = stop + 1, min(stop + delta, approx - 1)
    return out


def draw_slices(records, seed, count, size):
    """`count` slices [(record, lo, hi)] of `size` bases (hi exclusive),
    drawn from `seed`, each `GUARD` bases inside one fragment;
    `records` is {name: (bases, approximate length)}."""
    rng = np.random.default_rng([seed % (1 << 63), 0x5EED])
    spots = []
    for name, (n, approx) in records.items():
        for a, b in fragments(n, approx):
            if b - a + 1 >= size + 2 * GUARD:
                spots.append((name, a + GUARD, b - GUARD - size + 1))
    if not spots:
        return []
    out = []
    for k in rng.choice(len(spots), count, replace=len(spots) < count):
        name, lo, hi = spots[k]
        start = int(rng.integers(lo, hi + 1))
        out.append((name, start, start + size))
    return sorted(out)


class Binding:
    __slots__ = ("oligo", "minus", "loc5", "loc3", "r", "sure", "alts")


def _window_locs(rng, start, stop, n, minus):
    qr0, qr1, tr0, tr1 = rng
    if minus:
        return (start + (stop - start - 1 - tr1) - qr0,
                start + (stop - start - 1 - tr0) + (n - 1) - qr1)
    return start + tr0 - ((n - 1) - qr1), start + tr1 + qr0


def _windows(seq, lo, hi, oligo, minus, word):
    """{window start: seed position} of `oligo`'s seed diagonals on one
    strand of seq[lo:hi] (codes) whose windows lie wholly inside it."""
    n = len(oligo)
    q = codes(oligo)
    sq = q if minus else (3 - q)[::-1]
    span = seq[lo:hi].astype(np.int64)
    if len(span) < word or n < word:
        return {}
    w = np.zeros(len(span) - word + 1, np.int64)
    for k in range(word):
        w = (w << 2) | span[k:len(span) - word + 1 + k]
    starts = {}
    for k in range(n - word + 1):
        v = 0
        for b in sq[k:k + word]:
            v = (v << 2) | int(b)
        for p in np.nonzero(w == v)[0]:
            s = lo + int(p) - k - FLANK
            if s >= lo and s + n + 2 * FLANK <= hi and s not in starts:
                starts[s] = lo + int(p)
    return starts


def bindings(seq, lo, hi, jobs, melt, word, match=False):
    """The bindings of each job (oligo, minus, conc, min_tm) to one strand
    of seq[lo:hi] (codes), from windows wholly inside it: a list, a job
    each, of {(loc5, loc3): Binding}; `match` where the assay pairs
    primers (PCR).  A binding the search could take in more than one
    form is not sure, and lists each form in `alts`.  Windows of one
    length are scored together."""
    wins = []                       # (job, start)
    for ji, (oligo, minus, _, _) in enumerate(jobs):
        wins += [(ji, s) for s in sorted(_windows(seq, lo, hi, oligo,
                                                  minus, word))]
    groups = [{} for _ in jobs]
    by_len = {}
    for ji, s in wins:
        by_len.setdefault(len(jobs[ji][0]), []).append((ji, s))
    for n, items in by_len.items():
        stop = n + 2 * FLANK
        q = np.stack([codes(jobs[ji][0]) for ji, _ in items])
        tg = np.stack([seq[s:s + stop] for _, s in items]).astype(np.int64)
        minus = np.array([jobs[ji][1] for ji, _ in items])
        tg[minus] = (3 - tg[minus])[:, ::-1]
        concs = np.array([jobs[ji][2] for ji, _ in items], np.float32)
        mins = np.array([jobs[ji][3] for ji, _ in items], np.float32)
        for (ji, s), outs in zip(items, melt.batch(q, tg, concs, mins)):
            oligo, mi, _, min_tm = jobs[ji]
            ok = [r for r in outs if r["valid"] and r["tm"] >= f32(min_tm)
                  and r["tm"] <= f32(9999) and f32(-9999) <= r["dG"] <= 0]
            for r in ok:
                loc = _window_locs(r["range"], s, s + stop, n, mi)
                b = Binding()
                b.oligo, b.minus, (b.loc5, b.loc3), b.r = oligo, mi, loc, r
                b.sure = len(outs) == 1
                groups[ji].setdefault(loc, []).append(b)
    out = []
    for g in groups:
        picked = {}
        for loc, bs in g.items():
            # the search keeps one binding a pair of ends: the highest Tm;
            # where it pairs the primers of a product, on a tie the most
            # mismatches and then the longest printed alignment
            # (tntblast's sort_by_bound_match)
            rank = [(-b.r["tm"],) + ((-b.r["mm"], -len(b.r["align"][0]))
                                      if match else ()) for b in bs]
            top = min(rank)
            best = [b for b, k in zip(bs, rank) if k == top]
            alts = {(b.r["dH"], b.r["dS"], b.r["align"], b.r["mm"]): b
                    for b in best}
            pick = best[0]
            pick.alts = list(alts.values())
            pick.sure = all(b.sure for b in bs) and len(alts) == 1
            picked[loc] = pick
        out.append(picked)
    return out


def products(seq, lo, hi, params, assays, melt):
    """{record key: (sure, its two Bindings)} of the products the
    reference finds in seq[lo:hi]."""
    fmt = params["format"]
    roles = ("forward primer", "reverse primer") if fmt == "PCR" \
        else ("5' probe", "3' probe")
    jobs = sorted({(o, minus, params["conc"][role], params["min_tm"][role])
                   for _, x, y in assays for o, role in zip((x, y), roles)
                   for minus in (True, False)})
    found = dict(zip(jobs, bindings(seq, lo, hi, jobs, melt,
                                    params["word"], fmt == "PCR")))

    def bound(oligo, minus, role):
        return list(found[(oligo, minus, params["conc"][role],
                           params["min_tm"][role])].values())

    out = {}

    def add(name, a, b, rng, sure):
        for x in a.alts:
            for y in b.alts:
                key = record_key(name, rng, [(x.oligo, x.r["align"]),
                                             (y.oligo, y.r["align"])])
                if key not in out or sure:
                    out[key] = (sure, (x, y))

    for name, x, y in assays:
        if fmt == "PCR":
            minus = bound(x, True, "forward primer") \
                + bound(y, True, "reverse primer")
            plus = bound(x, False, "forward primer") \
                + bound(y, False, "reverse primer")
            for f in minus:
                for r in plus:
                    span = r.loc3 - f.loc5 + 1
                    if f.loc3 >= r.loc5 or span > params["max_len"]:
                        continue
                    sure = f.sure and r.sure \
                        and span <= params["max_len"] - 100
                    add(name, f, r, (f.loc5, r.loc3), sure)
        elif fmt == "PADLOCK":
            for minus in (True, False):
                downs = bound(x, minus, "5' probe")
                ups = bound(y, minus, "3' probe")
                for up in ups:
                    for dn in downs:
                        gap = (up.loc5 - dn.loc3 - 1) if minus \
                            else (dn.loc5 - up.loc3 - 1)
                        if gap != 0:
                            continue
                        rng = (dn.loc5, up.loc3) if minus \
                            else (up.loc5, dn.loc3)
                        add(name, dn, up, rng, up.sure and dn.sure)
        else:
            raise ValueError(f"assay format {fmt}")
    return out


def record_key(name, rng, oligos):
    """A record as the slices compare it: assay, range and each oligo with
    its printed alignment."""
    return (name, tuple(rng), tuple(sorted((o, tuple(al))
                                           for o, al in oligos)))


# -- scoring a printed alignment --------------------------------------------

def printed_core(align):
    """The aligned core of printed rows (query, marks, target): the
    columns from the first Watson-Crick mark to the last, as codes."""
    q, marks, t = align
    a, b = marks.find("|"), marks.rfind("|")
    if a < 0 or len(q) != len(marks) or len(t) != len(marks):
        return None
    try:
        return ([nucruc.CODE[c] for c in q[a:b + 1]],
                [nucruc.CODE[c] for c in t[a:b + 1]])
    except KeyError:
        return None


def oligo_thermo(o, conc, params, dtype="float32"):
    """(Tm, dH, dS, dG, mismatches, gaps) of oligo `o`'s printed
    alignment, or None where it prints none that can be scored."""
    core = printed_core(o.get("align", ("", "", "")))
    if core is None or "seq" not in o:
        return None
    al = nucruc.Alignment()
    al.q, al.t = core
    ar = nucruc.Arith(dtype)
    if not nucruc.evaluate(al, params["salt"], f32(conc), ar):
        return None
    dg = ar.c(ar.c(al.dH) - ar.c(f32(params["temperature"]) * al.dS))
    mm = nucruc.mismatches(al, len(o["seq"]))
    gaps = sum(b == nucruc.GAP for b in al.q + al.t)
    return float(al.tm), float(al.dH), float(al.dS), float(dg), mm, gaps


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-3)


class Verdict:
    """The numbers one or more outputs are judged by, each the worst over
    what was judged."""

    def __init__(self):
        self.records = 0
        self.bad_records = 0
        self.below_threshold = 0
        self.duplicates = 0
        self.missing_planted = 0
        self.thermo_gap = 0.0       # relative: Tm, dH, dS, dG
        self.missing_hits = 0
        self.extra_hits = 0
        self.slice_records = 0
        self.slice_bases = 0
        self.unsure = 0

    def numbers(self):
        return {k: getattr(self, k) for k in (
            "records", "slice_records", "slice_bases", "unsure",
            "bad_records", "below_threshold", "duplicates",
            "missing_planted", "missing_hits", "extra_hits", "thermo_gap")}

    def add(self, other):
        for k, v in other.numbers().items():
            setattr(self, k, max(getattr(self, k), v) if k == "thermo_gap"
                    else getattr(self, k) + v)


def _site_ok(r, seq):
    if seq is None or r["range"] is None:
        return False
    lo, hi = r["range"]
    if lo >= 0 and hi < len(seq):
        plus = seq[lo:hi + 1]
        ok = r["sequence"] in (plus, revcomp(plus))
    else:
        # a range over a record's end: the sequence is read from the
        # record's last (or first) hi - lo + 1 bases, and what lies past
        # it is printed as gaps
        n = hi - lo + 1
        plus = seq[max(len(seq) - n, 0):] if hi >= len(seq) else seq[:n]
        s = r["sequence"].strip("-")
        ok = bool(s) and (s in plus or s in revcomp(plus))
    win = seq[max(lo - 80, 0):hi + 81]
    for o in r["oligos"].values():
        if "align" not in o:
            continue
        t = o["align"][2].replace("-", "").replace("$", "")
        u = t.translate(_COMP)
        ok = ok and (u in win or revcomp(u) in win)
    return ok


def judge(text, db, params, planted=(), assays=(), slices=(),
          verdict=None, dtype="float32", melt=None):
    """Judges one output `text` of a search with `params` (search_params)
    over `db` ({record name: sequence}): every record, the generator's
    `planted` sites ([(assay, record, lo, hi)]) and, in each of `slices`
    ([(record, lo, hi)]), the hit list against the one the reference
    works out for the `assays` ([(name, oligo, oligo)]); adds to
    `verdict`."""
    v = Verdict() if verdict is None else verdict
    recs = parse_records(text)
    v.records += len(recs)
    found, keys = set(), {}
    for r in recs:
        seq = db.get(r["defline"])
        bad = not _site_ok(r, seq)
        found.add((r["name"], r["defline"], r["range"]))
        oligos = [(o["seq"], o["align"]) for o in r["oligos"].values()
                  if "seq" in o and "align" in o]
        for role, o in r["oligos"].items():
            if "tm" not in o:
                continue
            if o["tm"] < params["min_tm"][role]:
                v.below_threshold += 1
            got = oligo_thermo(o, params["conc"][role], params, dtype)
            if got is None or "dG" not in o:
                bad = True
                continue
            tm, dh, ds, dg, mm, gaps = got
            bad = bad or mm != o.get("mm") or gaps != o.get("gaps")
            v.thermo_gap = max(v.thermo_gap, *(
                _rel(a, b) for a, b in zip(
                    (o["tm"], o["dH"], o["dS"], o["dG"]), (tm, dh, ds, dg))))
        v.bad_records += bad
        key = (r["defline"],) + record_key(r["name"], r["range"] or (0, 0),
                                           oligos)
        keys[key] = keys.get(key, 0) + 1
    v.duplicates += sum(n - 1 for n in keys.values())
    for site in planted:
        if (site[0], site[1], (site[2], site[3])) not in found:
            v.missing_planted += 1
    if slices:
        melt = melt or nucruc.Melt(params["temperature"], params["salt"])
        for name, lo, hi in slices:
            _judge_slice(v, keys, db[name], name, lo, hi, params, assays,
                         melt)
    return v


def _judge_slice(v, keys, text_seq, name, lo, hi, params, assays, melt):
    seq = codes(text_seq[lo:hi])
    ref = products(seq, 0, hi - lo, params, assays, melt)
    a, b = lo + MARGIN, hi - MARGIN
    inside = {k[1:] for k in keys
              if k[0] == name and a <= k[2][0] and k[2][1] < b}
    mine = {}
    for (nm, (x, y), ol), (sure, _) in ref.items():
        if a <= x + lo and y + lo < b:
            mine[(nm, (x + lo, y + lo), ol)] = sure
    v.slice_bases += b - a
    v.slice_records += len(inside)
    v.unsure += sum(not s for s in mine.values())
    v.missing_hits += sum(1 for k, s in mine.items()
                          if s and k not in inside)
    v.extra_hits += sum(1 for k in inside if k not in mine)
