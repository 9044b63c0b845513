"""BASELINE config 5's data: a PCR panel and a padlock panel over a
database of long records with planted sites.

A copy of the draws of tntblast_tpu_torch/tools/scaled_bench.py::build
(itself byte-equal to the repository's tools/scaled_bench.py), with the
seed, the record count and lengths and the planting density taken as
parameters.  The rng draws the PCR assays (two primer lengths of 20-24 nt,
then their bases), the padlock assays (the same for the two arms), then
one record after another: its bases, then for each of the first `nplant`
PCR assays `plants_per_record` amplicons of `amplen` bases (forward primer
at the start, the reverse primer's reverse complement at the end), then
for each of the first `npad_plant` padlocks as many ligation sites (the
two arms back to back).  With seed 20260821 and the default parameters the
files are byte-equal to that tool's.

`panels` ({"pcr": [[name, f, r], ...], "padlock": [[name, a, b], ...]}),
where given, replaces the drawn assays (the draws are still made, so that
the records' draws are those of the same seed): every seed then searches
the same panels, and only the records and the sites move.  With seed
20260821 and the panels that seed draws, the files are those of the
source.
"""

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
LINE = 70
DEFLINE = "scaled_seq_{i} synthetic 128 Mb sequence"
DEFAULTS = dict(records=[128_000_000] * 8, nassay=10, nplant=5,
                npad=6, npad_plant=4, plants_per_record=40, amplen=150,
                panels=None)


def _to_str(codes):
    return BASES[codes].tobytes().decode()


def _revcomp(codes):
    return (3 - codes)[::-1]


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


def _codes(seq):
    """ACGT text as codes 0-3."""
    return np.searchsorted(BASES, np.frombuffer(seq.encode(), np.uint8)) \
        .astype(np.uint8)


def _oligos(rng, n, prefix, fixed):
    out = []
    for a in range(n):
        pair = [rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
                for _ in range(2)]
        if fixed is not None:
            name, x, y = fixed[a]
            out.append((name, _codes(x), _codes(y)))
        else:
            out.append((f"{prefix}{a:02d}", *pair))
    return out


def generate(workdir, seed, **params):
    """Writes the database and the two query files into `workdir`.
    Returns {"db", "queries": {"pcr",
    "padlock"}, "planted": {"pcr": [...], "padlock": [...]}, "bases"}; a
    planted site is (assay, record name, lo, hi), 0-based inclusive, and is
    listed only where no later site overwrote any of its bases."""
    p = dict(DEFAULTS, **params)
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    panels = p["panels"] or {}
    assays = _oligos(rng, p["nassay"], "SCPCR", panels.get("pcr"))
    pads = _oligos(rng, p["npad"], "SCPAD", panels.get("padlock"))

    stem = os.path.join(workdir, "scaled")
    fna = stem + ".fna"
    planted = {"pcr": [], "padlock": []}
    with open(fna, "wb") as fh:
        for s, seqlen in enumerate(p["records"]):
            name = DEFLINE.format(i=s)
            g = rng.integers(0, 4, seqlen, dtype=np.uint8)
            sites = []
            for a in range(p["nplant"]):
                label, f, r = assays[a]
                rrc = _revcomp(r)
                for _ in range(p["plants_per_record"]):
                    pos = int(rng.integers(0, seqlen - p["amplen"] - 1))
                    g[pos:pos + len(f)] = f
                    g[pos + p["amplen"] - len(rrc):pos + p["amplen"]] = rrc
                    sites.append(("pcr", label, pos, p["amplen"],
                                  ((0, f), (p["amplen"] - len(rrc), rrc))))
            for a in range(p["npad_plant"]):
                label, up, dn = pads[a]
                site = np.concatenate([up, dn])
                for _ in range(p["plants_per_record"]):
                    pos = int(rng.integers(0, seqlen - len(site) - 1))
                    g[pos:pos + len(site)] = site
                    sites.append(("padlock", label, pos, len(site),
                                  ((0, site),)))
            for fam, label, pos, n, parts in sites:
                if all(np.array_equal(g[pos + o:pos + o + len(b)], b)
                       for o, b in parts):
                    planted[fam].append((label, name.split()[0], pos,
                                         pos + n - 1))
            fh.write(f">{name}\n".encode())
            fh.write(fasta_lines(g).tobytes())
    queries = {}
    for fam, rows in (("pcr", assays), ("padlock", pads)):
        queries[fam] = f"{stem}_{fam}.txt"
        with open(queries[fam], "w") as fh:
            for name, x, y in rows:
                fh.write(f"{name}\t{_to_str(x)}\t{_to_str(y)}\n")
    return {"db": fna, "queries": queries, "planted": planted,
            "bases": int(sum(p["records"]))}
