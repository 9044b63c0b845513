"""The generators are deterministic per seed, and with the original seeds
their files are byte-equal to those of the generators they copy."""

import filecmp
import os

from traffic import config5


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_config5_deterministic_per_seed(tmp_path):
    kw = dict(records=[50_000, 30_000], plants_per_record=3)
    a = config5.generate(str(tmp_path / "a"), 7, **kw)
    b = config5.generate(str(tmp_path / "b"), 7, **kw)
    c = config5.generate(str(tmp_path / "c"), 8, **kw)
    assert _read(a["db"]) == _read(b["db"])
    assert _read(a["db"]) != _read(c["db"])
    for fam in ("pcr", "padlock"):
        assert _read(a["queries"][fam]) == _read(b["queries"][fam])
    assert a["planted"] == b["planted"]
    assert a["bases"] == 80_000


def _config(name):
    import json

    from conftest import BENCH
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return json.load(fh)["params"]


def test_config5_fixed_panels_every_seed(tmp_path):
    panels = _config("config5")["panels"]
    texts = set()
    for seed in (1, 2, 3):
        d = config5.generate(str(tmp_path / str(seed)), seed,
                             records=[20_000], plants_per_record=2,
                             panels=panels)
        texts.add(tuple(_read(d["queries"][f]) for f in ("pcr", "padlock")))
    assert len(texts) == 1


def test_config5_byte_equal_with_the_configs_panels(tmp_path):
    from tntblast_tpu_torch.tools import scaled_bench

    fna, pcr, pad = scaled_bench.build(str(tmp_path / "orig"), nseq=1,
                                       seqlen=60_000)
    mine = config5.generate(str(tmp_path / "mine"), 20260821,
                            records=[60_000],
                            panels=_config("config5")["panels"])
    assert filecmp.cmp(fna, mine["db"], shallow=False)
    assert filecmp.cmp(pcr, mine["queries"]["pcr"], shallow=False)
    assert filecmp.cmp(pad, mine["queries"]["padlock"], shallow=False)


def test_config5_byte_equal_to_scaled_bench(tmp_path):
    from tntblast_tpu_torch.tools import scaled_bench

    fna, pcr, pad = scaled_bench.build(str(tmp_path / "orig"), nseq=2,
                                       seqlen=60_000)
    mine = config5.generate(str(tmp_path / "mine"), 20260821,
                            records=[60_000, 60_000])
    assert filecmp.cmp(fna, mine["db"], shallow=False)
    assert filecmp.cmp(pcr, mine["queries"]["pcr"], shallow=False)
    assert filecmp.cmp(pad, mine["queries"]["padlock"], shallow=False)


def test_config5_planted_sites_are_in_the_database(tmp_path):
    import reference

    d = config5.generate(str(tmp_path), 11, records=[40_000],
                         plants_per_record=4)
    db = reference.read_fasta(d["db"])
    rows = {fam: {ln.split()[0]: ln.split()[1:]
                  for ln in open(d["queries"][fam])}
            for fam in ("pcr", "padlock")}
    assert d["planted"]["pcr"] and d["planted"]["padlock"]
    for label, rec, lo, hi in d["planted"]["pcr"]:
        f, r = rows["pcr"][label]
        site = db[rec][lo:hi + 1]
        assert site.startswith(f) and site.endswith(reference.revcomp(r))
    for label, rec, lo, hi in d["planted"]["padlock"]:
        a, b = rows["padlock"][label]
        assert db[rec][lo:hi + 1] == a + b
