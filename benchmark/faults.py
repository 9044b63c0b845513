"""Faults planted under the timed path, to show that `correct` catches
them (benchmark/tests/test_bench_rehearsal.py on the CPU, control.py
on the card).  Each is a context manager over the program:

  stale_step      every device step returns the first step's state
                  (its kept windows and counts), not its own;
  half_batch      each device step's later half of fragments left out:
                  they come back with no candidate;
  altered_answer  the first hit of each assay search has its dH changed
                  by 1% where the search produces it;
  drop_window     one kept window that the device step hands the host
                  search is left out: the window of a binding at a site
                  no generator planted, whose product (a record no site
                  planted) lies in one of the run's slices.

Each is called with the cell (its data generated) and the run's seed.

A one-card cell has no exchange between chips to leave out.
"""

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(owner, attr, make):
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def stale_step(cell=None, seed=0):
    from tntblast_tpu_torch.parallel.device_search import DevicePanel

    first = {}

    def make(real):
        def resolve(dp, pending):
            res = real(dp, pending)
            old = first.setdefault(id(dp), res)
            return [dict(old[i % len(old)]) for i in range(len(res))]
        return resolve
    return _patched(DevicePanel, "resolve_fragments", make)


def half_batch(cell=None, seed=0):
    from tntblast_tpu_torch.parallel.device_search import DevicePanel

    def make(real):
        def resolve(dp, pending):
            res = real(dp, pending)
            for r in res[(len(res) + 1) // 2:]:
                none = np.zeros(0, np.int32)
                r.update(os_k=none, p_k=none, kmin_k=none,
                         counts=np.zeros_like(r["counts"]), n_kept=0)
                if r["eval"] is not None:
                    r["eval"] = r["eval"][:, :0]
            return res
        return resolve
    return _patched(DevicePanel, "resolve_fragments", make)


def altered_answer(cell=None, seed=0):
    from tntblast_tpu_torch import engine

    def make(real):
        def search(ctx, sig, opt):
            hits = real(ctx, sig, opt)
            if hits:
                attr = "forward_dH" if hits[0].has_primers() else "probe_dH"
                setattr(hits[0], attr, getattr(hits[0], attr) * 1.01)
            return hits
        return search
    return _patched(engine, "search_assay", make)


def unplanted_binding(cell, seed):
    """(record, oligo, minus, loc5, loc3) of a binding that the reference
    finds in one of the run's slices, that lies in no planted site, and
    whose product is a record the reference is sure of; None where the
    slices hold none."""
    import nucruc
    import reference

    db = reference.read_fasta(cell.data["db"])
    spans = reference.fasta_spans(cell.data["db"])
    slices = reference.draw_slices(
        {k: (len(x), spans[k]) for k, x in db.items()}, seed,
        cell.slices["count"], cell.slices["size"])
    for search in cell.traffic["searches"]:
        params = reference.search_params(search["argv"])
        fam = search["queries"]
        assays = reference.read_queries(cell.data["queries"][fam])
        planted = cell.data["planted"][fam]
        melt = nucruc.Melt(params["temperature"], params["salt"])
        for name, lo, hi in slices:
            seq = reference.codes(db[name][lo:hi])
            found = reference.products(seq, 0, hi - lo, params, assays, melt)
            for (_, (x, y), _), (sure, pair) in sorted(found.items()):
                if not sure or x < reference.MARGIN \
                        or y >= hi - lo - reference.MARGIN:
                    continue
                for b in pair:
                    a, z = b.loc5 + lo, b.loc3 + lo
                    if not any(r == name and p_lo <= z and a <= p_hi
                               for _, r, p_lo, p_hi in planted):
                        return name, b.oligo, b.minus, a, z, db[name]
    return None


def drop_window(cell, seed):
    from tntblast_tpu_torch import constants as C
    from tntblast_tpu_torch.search import native_assays

    target = unplanted_binding(cell, seed)
    if target is None:
        raise RuntimeError("no unplanted binding in the run's slices")
    name, oligo, minus, a, z, text = target
    # the bases around the site, as the fragments hold them
    site = C.ASCII_TO_DB[np.frombuffer(
        text[a - 40:z + 41].encode(), np.uint8)].tobytes()

    def make(real):
        def init(self, engine, seq_codes, word_len, defline="",
                 panel_result=None):
            if panel_result:
                off = np.asarray(seq_codes, np.uint8).tobytes().find(site)
                if off >= 0:
                    a0, z0 = off + 40, off + 40 + (z - a)
                    out = {}
                    for key, (q, t, n_scr, ev) in panel_result.items():
                        if key[0] == oligo and bool(key[1]) == minus:
                            s = np.asarray(t) - np.asarray(q) - 4
                            keep = (s + len(oligo) + 8 <= a0) | (s > z0)
                            q, t = np.asarray(q)[keep], np.asarray(t)[keep]
                            if ev is not None:
                                ev = np.asarray(ev)[:, keep]
                        out[key] = (q, t, n_scr, ev)
                    panel_result = out
            real(self, engine, seq_codes, word_len, defline, panel_result)
        return init
    return _patched(native_assays.NativeFragContext, "__init__", make)


FAULTS = {"stale_step": stale_step, "half_batch": half_batch,
          "altered_answer": altered_answer, "drop_window": drop_window}
