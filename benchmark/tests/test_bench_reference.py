"""The plain reference agrees with the hit lists of the reference binary
that the repository records (tests/golden/e2e), works the same hit lists
out again on its own, and fails its control."""

import os

import numpy as np
import pytest

import nucruc
import reference
from conftest import ROOT

GOLDEN = os.path.join(ROOT, "tests", "golden", "e2e")
DATA = os.path.join(ROOT, "tests", "data")
CASES = ("pcr_small", "pcr_lowtm", "pcr_salt", "pcr_asym", "mm_gap_limits",
         "padlock", "mips", "probe_small", "probe_dg", "probe_minus_only",
         "taqman", "word5")
# the formats whose hit list the reference works out again
HIT_LISTS = ("pcr_small", "pcr_lowtm", "pcr_salt", "pcr_asym", "word5",
             "padlock")


def _case(name):
    with open(os.path.join(GOLDEN, name + ".cmd")) as fh:
        argv = fh.read().split()
    db = reference.read_fasta(os.path.join(DATA, argv[argv.index("-d") + 1]))
    with open(os.path.join(GOLDEN, name + ".out")) as fh:
        text = fh.read()
    queries = os.path.join(DATA, argv[argv.index("-i") + 1])
    return argv, db, text, queries


def _judge(name, dtype="float32", text=None):
    argv, db, golden, _ = _case(name)
    return reference.judge(text or golden, db, reference.search_params(argv),
                           dtype=dtype)


@pytest.mark.parametrize("name", CASES)
def test_reference_agrees_with_the_reference_binary(name):
    v = _judge(name)
    assert v.records > 0
    assert v.bad_records == 0 and v.below_threshold == 0
    assert v.duplicates == 0
    # the binary prints 6 significant digits
    assert v.thermo_gap < 1e-5


@pytest.mark.parametrize("name", HIT_LISTS)
def test_reference_works_out_the_binarys_hit_list(name):
    """Every record of the binary away from a sequence's ends is a product
    the reference finds on its own, and every product it is sure of
    there is a record."""
    argv, db, text, queries = _case(name)
    params = reference.search_params(argv)
    assays = reference.read_queries(queries)
    melt = nucruc.Melt(params["temperature"], params["salt"])
    edge = 60
    got, want = set(), {}
    for r in reference.parse_records(text):
        lo, hi = r["range"]
        if edge <= lo and hi < len(db[r["defline"]]) - edge:
            got.add((r["defline"],) + reference.record_key(
                r["name"], r["range"],
                [(o["seq"], o["align"]) for o in r["oligos"].values()]))
    for rec, seq in db.items():
        found = reference.products(reference.codes(seq), 0, len(seq),
                                   params, assays, melt)
        for key, (sure, _) in found.items():
            lo, hi = key[1]
            if edge <= lo and hi < len(seq) - edge:
                want[(rec,) + key] = sure
    assert got, name
    assert got <= set(want)
    assert {k for k, s in want.items() if s} <= got


@pytest.mark.parametrize("name", ("pcr_small", "padlock", "probe_small"))
def test_bfloat16_control_fails(name):
    assert _judge(name, "bfloat16").thermo_gap > 1e-3


def test_a_shifted_site_is_a_bad_record():
    _, _, text, _ = _case("probe_small")
    text = text.replace("probe range = 2268 .. 2291",
                        "probe range = 2269 .. 2292", 1)
    assert _judge("probe_small", text=text).bad_records == 1


def test_a_wrong_mismatch_count_is_a_bad_record():
    _, _, text, _ = _case("pcr_small")
    i = text.index("forward primer mismatches = ")
    j = text.index("\n", i)
    n = int(text[i:j].split(" = ")[1])
    text = text[:i] + f"forward primer mismatches = {n + 1}" + text[j:]
    assert _judge("pcr_small", text=text).bad_records == 1


def test_an_altered_tm_reads_in_thermo_gap():
    _, _, text, _ = _case("pcr_small")
    i = text.index("forward primer tm = ")
    j = text.index("\n", i)
    tm = float(text[i:j].split(" = ")[1])
    text = text[:i] + f"forward primer tm = {tm * 1.001:g}" + text[j:]
    assert _judge("pcr_small", text=text).thermo_gap > 5e-4


def test_a_repeated_record_is_a_duplicate():
    _, _, text, _ = _case("padlock")
    head, first, *rest = text.split("\nname = ")
    text = "\nname = ".join([head, first, first] + rest)
    assert _judge("padlock", text=text).duplicates == 1


def test_a_missing_planted_site_counts():
    argv, db, text, _ = _case("probe_small")
    planted = [("probeA", "synth_0", 2268, 2291),
               ("probeA", "synth_0", 100, 123)]
    v = reference.judge(text, db, reference.search_params(argv), planted)
    assert v.missing_planted == 1


def test_a_dropped_record_in_a_slice_is_missing():
    """A long random record with planted PCR sites: the slice's hit list
    finds each of them, and misses the one taken out."""
    rng = np.random.default_rng(5)
    seq = rng.integers(0, 4, 40_000).astype(np.uint8)
    f, r = "ATTATGGCGCTTTCTTTCGGA", "GTGGGCCGGAGTAACGTTACG"
    amp = f + "ACGT" * 20 + reference.revcomp(r)
    text = "".join("ACGT"[b] for b in seq)
    for pos in (10_000, 20_000, 30_000):
        text = text[:pos] + amp + text[pos + len(amp):]
    params = reference.search_params(["-A", "PCR", "-e", "40", "-l", "2000"])
    melt = nucruc.Melt()
    found = reference.products(reference.codes(text), 0, len(text), params,
                               [("A", f, r)], melt)
    sites = {k for k, (sure, _) in found.items() if sure}
    assert {k[1][0] for k in sites} >= {10_000, 20_000, 30_000}
    out = "\n".join(_record(k) for k in sorted(sites))
    db = {"rec": text}
    slices = [("rec", 3_000, 37_000)]
    v = reference.judge("#\n" + out, db, params, (), [("A", f, r)], slices)
    assert v.missing_hits == 0 and v.extra_hits == 0
    drop = "\n".join(_record(k) for k in sorted(sites)[1:])
    v = reference.judge("#\n" + drop, db, params, (), [("A", f, r)], slices)
    assert v.missing_hits == 1 and v.extra_hits == 0


def _record(key):
    """A minimal output record of a slice key (name, range, oligos)."""
    name, (lo, hi), oligos = key
    lines = [f"name = {name}"]
    for role, (seq, (q, m, t)) in zip(("forward primer", "reverse primer"),
                                       oligos):
        lines += [f"{role} = 5' {seq} 3'", f"{role} align 5' {q} 3'",
                  f"{role} align    {m}", f"{role} align 3' {t} 5'"]
    lines += [f"amplicon range = {lo} .. {hi}", ">rec", "-"]
    return "\n".join(lines)


def test_evaluate_by_hand():
    # 5'-GC-3' on its complement: init + the GC/CG stack + salt for one
    # phosphate, at [Na+] 1 M
    al = nucruc.Alignment()
    al.q, al.t = [nucruc.G, nucruc.C], [nucruc.C, nucruc.G]
    assert nucruc.evaluate(al, 1.0, np.float32(1e-6))
    assert abs(al.dH - (0.2 - 9.8)) < 1e-5
    s = (0.2 - 1.96) / 310.15 + (-9.8 + 2.24) / 310.15
    assert abs(al.dS - s) < 1e-6
