"""The ARTIC nCoV-2019 V3 amplicon panel over a collection of
SARS-CoV-2-length genomes.

A fixed ancestral genome of `genome_len` bases (GC share `gc`) is drawn
from `ancestor_seed`; the panel's 98 tiled amplicons sit on it at the
positions `amplicons` lists ([name, pool, left start, left length, right
end, right length], 0-based, the right end inclusive), and each primer is
the ancestor's own sequence at its site (the right primer its reverse
complement).  `draw_panel` draws those positions and lengths once, to the
scheme's shape, and the configuration keeps what it drew.

From the run's seed: `lineages` lineages, each with `lineage_subs`
substitutions from the ancestor and `lineage_dels` deletions of
`del_len` bases (each a closed range, drawn uniformly); then `genomes`
genomes, each a lineage drawn uniformly plus `private_subs` substitutions
of its own.  A substitution changes a base to one of the three others.
The database is one FASTA of the genomes; the queries one PCR file of the
panel.  `planted` lists, for each genome, the amplicons whose two primer
sites are intact there (no substituted and no deleted base), at their
range in that genome's own coordinates.
"""

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
LINE = 70
FLANK = 4               # target bases each side of an oligo's window
DEFAULTS = dict(genome_len=29903, gc=0.38, ancestor_seed=20200110,
                genomes=1024, lineages=16, lineage_subs=[20, 60],
                lineage_dels=[0, 2], del_len=[3, 9], private_subs=[0, 15])
# draw_panel's design: the scheme's amplicon count, span, amplicon and
# primer lengths, and the Tm a primer is lengthened to reach
DESIGN = dict(n_amplicons=98, first=30, last=29866, amp_len=[380, 420],
              jitter=8, primer_len=[22, 30], tm_goal=56.0, tm_floor=50.0,
              max_shift=20)


def _revcomp(codes):
    return (3 - codes)[::-1]


def _to_str(codes):
    return BASES[codes].tobytes().decode()


def fasta_lines(codes):
    """The bases of `codes` as LINE-wide lines, each ending in a newline."""
    txt = BASES[codes]
    full, rest = divmod(len(txt), LINE)
    out = np.empty(full * (LINE + 1) + (rest + 1 if rest else 0), np.uint8)
    rows = out[:full * (LINE + 1)].reshape(full, LINE + 1)
    rows[:, :LINE] = txt[:full * LINE].reshape(full, LINE)
    rows[:, LINE] = ord("\n")
    if rest:
        out[full * (LINE + 1):-1] = txt[full * LINE:]
        out[-1] = ord("\n")
    return out


def ancestor(genome_len, gc, ancestor_seed):
    """The fixed ancestral genome: codes 0-3, G and C each gc / 2."""
    rng = np.random.default_rng(ancestor_seed)
    at, cg = (1 - gc) / 2, gc / 2
    return rng.choice(4, genome_len, p=[at, cg, cg, at]).astype(np.uint8)


def site_tm(genome, lo, n, minus, melt=None, conc=9e-7):
    """The perfect-match Tm of the oligo that is genome[lo:lo + n] (minus
    False: the reverse complement of it), with its window's flanks, under
    the search's defaults (benchmark/nucruc.py: 310.15 K, 0.05 M Na+, the
    primer strand at `conc`)."""
    import nucruc

    melt = melt or nucruc.Melt()
    win = genome[max(lo - FLANK, 0):lo + n + FLANK].astype(np.int64)
    q = genome[lo:lo + n].astype(np.int64)
    if minus:
        tg = (3 - win)[::-1]
    else:
        q = (3 - q)[::-1]
        tg = win
    outs = melt.batch(q[None], tg[None], np.array([conc], np.float32))[0]
    return max(float(o["tm"]) for o in outs if o["valid"])


def draw_panel(genome_len=29903, gc=0.38, ancestor_seed=20200110,
               **design):
    """The fixed panel, drawn once: ([name, pool, left start, left length,
    right end, right length] an amplicon, {"artic": [[name, left primer,
    right primer], ...]}, the panel's least perfect-match Tm).  Amplicon
    i starts near an even step from `first` so that the last ends near
    `last`, with a length drawn in `amp_len`; each primer takes the
    shortest length in `primer_len` whose Tm reaches `tm_goal` (else the
    length of the highest Tm), its site moved by up to `max_shift` bases
    where no length reaches `tm_floor`."""
    import nucruc

    d = dict(DESIGN, **design)
    g = ancestor(genome_len, gc, ancestor_seed)
    rng = np.random.default_rng([ancestor_seed, 98])
    melt = nucruc.Melt()
    n = d["n_amplicons"]
    lens = rng.integers(d["amp_len"][0], d["amp_len"][1] + 1, n)
    step = (d["last"] - lens[-1] + 1 - d["first"]) / (n - 1)
    starts = [d["first"] + int(round(i * step)) + (
        int(rng.integers(-d["jitter"], d["jitter"] + 1)) if 0 < i < n - 1
        else 0) for i in range(n)]

    def primer(anchor, minus):
        best = None
        for shift in sorted(range(-d["max_shift"], d["max_shift"] + 1),
                            key=lambda s: (abs(s), s)):
            for k in range(d["primer_len"][0], d["primer_len"][1] + 1):
                lo = anchor + shift if minus else anchor + shift - k + 1
                tm = site_tm(g, lo, k, minus, melt)
                if best is None or tm > best[2]:
                    best = (shift, k, tm)
                if tm >= d["tm_goal"]:
                    return shift, k, tm
            if best[2] >= d["tm_floor"]:
                return best
        raise ValueError(f"no primer of Tm {d['tm_floor']} near {anchor}")

    amplicons, rows, tms = [], [], []
    for i in range(n):
        ls, ll, lt = primer(starts[i], True)
        rs, rl, rt = primer(starts[i] + int(lens[i]) - 1, False)
        left = starts[i] + ls
        right_end = starts[i] + int(lens[i]) - 1 + rs
        name = f"nCoV-2019_{i + 1}"
        amplicons.append([name, 1 + i % 2, left, ll, right_end, rl])
        rows.append([name, _to_str(g[left:left + ll]),
                     _to_str(_revcomp(g[right_end - rl + 1:right_end + 1]))])
        tms += [lt, rt]
    for a, b in zip(amplicons, amplicons[1:]):
        # tiled: each amplicon's left primer lies inside the one before,
        # clear of that one's right primer
        if not (a[2] < b[2] <= a[4] and b[2] + b[3] <= a[4] - a[5] + 1):
            raise ValueError(f"amplicons {a[0]} and {b[0]} do not tile")
    return amplicons, {"artic": rows}, min(tms)


def _sites(amp):
    """(left, right) primer sites [lo, hi) of an amplicon row."""
    _, _, ls, ll, re, rl = amp
    return (ls, ls + ll), (re - rl + 1, re + 1)


def _substitute(rng, seq, n):
    """`n` substitutions at distinct positions of `seq`, in place."""
    pos = rng.choice(len(seq), n, replace=False)
    seq[pos] = (seq[pos] + rng.integers(1, 4, n)).astype(np.uint8) % 4


def generate(workdir, seed, **params):
    """Writes the database and the query file into `workdir`; `params`
    holds the configuration's `amplicons` and `panels`.  Returns {"db",
    "queries": {"artic"}, "planted": {"artic": [...]}, "bases"}; a planted
    site is (amplicon, record name, lo, hi), 0-based inclusive."""
    p = dict(DEFAULTS, **params)
    os.makedirs(workdir, exist_ok=True)
    anc = ancestor(p["genome_len"], p["gc"], p["ancestor_seed"])
    rng = np.random.default_rng(seed)
    lineages = []
    for _ in range(p["lineages"]):
        seq = anc.copy()
        _substitute(rng, seq, int(rng.integers(p["lineage_subs"][0],
                                               p["lineage_subs"][1] + 1)))
        keep = np.ones(len(anc), bool)
        for _ in range(int(rng.integers(p["lineage_dels"][0],
                                        p["lineage_dels"][1] + 1))):
            n = int(rng.integers(p["del_len"][0], p["del_len"][1] + 1))
            lo = int(rng.integers(0, len(anc) - n + 1))
            keep[lo:lo + n] = False
        lineages.append((seq, keep))

    stem = os.path.join(workdir, "artic")
    fna = stem + ".fna"
    planted = {"artic": []}
    bases = 0
    with open(fna, "wb") as fh:
        for k in range(p["genomes"]):
            lin = int(rng.integers(0, len(lineages)))
            seq, keep = lineages[lin]
            seq = seq.copy()
            _substitute(rng, seq, int(rng.integers(p["private_subs"][0],
                                                   p["private_subs"][1] + 1)))
            name = f"artic{k:04d}"
            # a base's position in this genome: its ancestral position less
            # the deleted bases before it
            at = np.cumsum(keep) - 1
            for amp in p["amplicons"]:
                sites = _sites(amp)
                if all(keep[a:b].all() and (seq[a:b] == anc[a:b]).all()
                       for a, b in sites):
                    planted["artic"].append(
                        (amp[0], name, int(at[sites[0][0]]),
                         int(at[sites[1][1] - 1])))
            genome = seq[keep]
            bases += len(genome)
            fh.write(f">{name} lineage {lin:02d} synthetic SARS-CoV-2-length "
                     f"genome\n".encode())
            fh.write(fasta_lines(genome).tobytes())
    queries = {"artic": stem + "_artic.txt"}
    with open(queries["artic"], "w") as fh:
        for name, x, y in p["panels"]["artic"]:
            fh.write(f"{name}\t{x}\t{y}\n")
    return {"db": fna, "queries": queries, "planted": planted,
            "bases": int(bases)}
