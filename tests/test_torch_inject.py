"""The hand-off of a resolved device step's kept seeds to the native fragment
contexts, against its plain version.

The program: `DevicePanel.resolve_fragments` finds each (slot, fragment) run
of the slot-major kept block with one bincount, `FragmentPanelManager`
hands each fragment one `GroupSeeds` a panel group, and `NativeFragContext`
injects a group in one native call (`FragSearch.inject_block`).  The plain
version, kept here: the split the port made before, a boolean mask a
fragment over the batch's block and a mask a slot over the fragment's
entries, reversed into reference order, then `set_seeds` and `set_evals`
slot by slot.  Every injected slot (its seeds in order, its conditions and
whether it was filtered) and the context's `screened` and `dev_evaluated`
counters must be equal.
"""

import struct
import threading
import types

import numpy as np
import pytest
import torch

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import native
from tntblast_tpu_torch import trace
from tntblast_tpu_torch.parallel import panel as P
from tntblast_tpu_torch.parallel.device_search import (
    DevicePanel, FragmentKept, PanelConfig, kept_runs)
from tntblast_tpu_torch.search.native_assays import NativeFragContext

WORD_LEN = 7
CAP = 4096


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


def _codes(oligo):
    return C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]


def _f32_bits(x):
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def _eval_words(rng, k, olen):
    """k packed evaluations (the five words of parallel/device_search.py):
    a third untrusted, some trusted with the engine's tm = 0 flag (w0 & 2),
    the rest trusted with counts, ranges, anchors and dH/dS around the
    filters' thresholds."""
    w = np.zeros((5, k), np.int32)
    for j in range(k):
        kind = rng.integers(0, 6)
        if kind < 2:
            w[0, j] = rng.integers(0, 1 << 16) << 2       # bit 0 clear
            continue
        if kind == 2:
            w[0, j] = 1 | 2
            continue
        num_base = 2 * olen
        mm = int(rng.integers(0, 5))
        w[0, j] = 1 | (num_base << 2) | (mm << 10)
        fm_q = int(rng.integers(0, 2))
        lm_q = olen - 1 - int(rng.integers(0, 2))
        w[1, j] = fm_q | (lm_q << 16)
        w[2, j] = int(rng.integers(0, 6)) | (int(rng.integers(0, 6)) << 8)
        dH = rng.uniform(-200.0, -120.0)
        tk = rng.uniform(300.0, 350.0)
        w[3, j] = _f32_bits(dH)
        w[4, j] = _f32_bits(dH / tk)
    return w


def _batch(rng, n, num_os, n_real, slot_len, eval_on, over=(),
           kept_over=False):
    """A resolved step's outputs (header, kept block) for n fragments, in
    the device's order: slot-major, fragment-major within a slot, rank
    (ascending p) within a (slot, fragment); some runs empty."""
    cols = []
    counts = np.zeros((n, num_os), np.int32)
    for s in range(n_real):
        for f in range(n):
            k = int(rng.choice([0, 0, 1, 2, 5, 11]))
            counts[f, s] = k + int(rng.integers(0, 4))
            if not k:
                continue
            ranks = np.sort(rng.choice(CAP, k, replace=False))
            p = np.sort(rng.choice(np.arange(-10, 16000), k, replace=False))
            ev = (_eval_words(rng, k, slot_len[s]) if eval_on
                  else np.zeros((5, k), np.int32))
            cols.append(np.vstack([f * CAP + ranks, np.full(k, s), p,
                                   rng.integers(0, 4, k), ev]))
    block = (np.hstack(cols) if cols else np.zeros((9, 0))).astype(np.int32)
    cfg = PanelConfig(word_len=WORD_LEN, num_os=num_os, max_words=16,
                      wq_max=max(slot_len), tile_len=16384, cap=CAP,
                      num_cond=1)
    bkcap = cfg.batch_kcap(n)
    n_kept = block.shape[1]
    assert n_kept <= bkcap
    if kept_over:
        n_kept = bkcap + 1
    overflow = np.zeros(n, np.int32)
    overflow[list(over)] = 1
    header = np.concatenate([
        [n_kept], overflow, np.zeros(num_os), counts.sum(axis=1),
        counts.ravel()]).astype(np.int32)
    out = np.zeros((9, bkcap), np.int32)
    out[:, :block.shape[1]] = block
    return cfg, (n, (torch.from_numpy(header), torch.from_numpy(out)))


def _panel(cfg, n_real, eval_on):
    """A DevicePanel with only what resolve_fragments reads."""
    dp = DevicePanel.__new__(DevicePanel)
    dp.config, dp.n_real, dp.eval_on = cfg, n_real, eval_on
    return dp


def _group(keys):
    return types.SimpleNamespace(keys=keys, table=native.SlotTable.of(
        [(_codes(o), m, f9, c) for o, m, f9, c in keys]))


def _keys(rng, n_slots, shared=()):
    """n_slots slot keys (oligo, minus, filt9, conc); `shared` oligos come
    first, on both strands, so that two groups hold one (oligo, strand)
    under other filters (the later slot's injection replaces the
    earlier's, as set_seeds does)."""
    keys = []
    oligos = list(shared)
    while len(keys) < n_slots:
        if not oligos:
            oligos.append("".join(rng.choice(list("ACGT"),
                                             int(rng.integers(18, 26)))))
        o = oligos.pop(0)
        for minus in (True, False):
            f9 = (float(rng.choice([0.0, 40.0, 50.0])), 90.0,
                  float(rng.choice([-1e9, -40.0])), 1e9,
                  0.0, float(rng.integers(0, 3)), float(rng.integers(2, 6)),
                  2.0, float(rng.integers(0, 3)))
            keys.append((o, minus, f9, float(rng.choice([2.5e-7, 5e-7]))))
    return keys[:n_slots]


# ---- the plain version: the split as the port made it before ------------

def _plain_resolve(dp, pending):
    """The per-fragment arrays by a boolean mask a fragment."""
    n, out = pending
    cfg = dp.config
    header = out[0].numpy()
    (n_kept, overflow, slot_over, n_cand,
     counts) = dp._unpack_header(n, header)
    bkcap = cfg.batch_kcap(n)
    kept = out[1][:, :min(n_kept, bkcap)].numpy()
    frag_of = kept[0] // cfg.cap
    res = []
    for i in range(n):
        sel = frag_of == i
        res.append({
            "os_k": kept[1][sel], "p_k": kept[2][sel], "kmin_k": kept[3][sel],
            "eval": kept[4:9][:, sel] if dp.eval_on else None,
            "counts": counts[i][:dp.n_real], "n_kept": int(sel.sum()),
            "slot_overflow": slot_over[:dp.n_real],
            "overflow": bool(overflow[i]) or n_kept > bkcap})
    return res


def _plain_merge(out, keys, res, stats):
    """slot key -> (q, t, n_screened, eval words) by a mask a slot."""
    if res["overflow"]:
        stats["fallback"] += 1
        return
    os_k = res["os_k"]
    p = res["p_k"].astype(np.int64)
    kmin = res["kmin_k"].astype(np.int64)
    counts, evw = res["counts"], res["eval"]
    stats["seeds"] += int(counts.sum())
    stats["kept"] += len(p)
    for i, key in enumerate(keys):
        sel = os_k == i
        q = kmin[sel][::-1]
        t = (p[sel] + kmin[sel])[::-1]
        ev = evw[:, sel][:, ::-1] if evw is not None else None
        out[key] = (q, t, int(counts[i]) - int(sel.sum()), ev)


def _plain_inject(frag, slots):
    for (oligo, minus, f9, conc), (q, t, n_scr, ev) in slots.items():
        codes = _codes(oligo)
        frag.set_seeds(codes, minus, f9[0], f9[3], conc, q, t, n_scr)
        if ev is not None and len(q):
            frag.set_evals(codes, minus, f9, conc, q, t, ev)


# ---- the program's path ---------------------------------------------------

def _manager():
    mgr = P.FragmentPanelManager.__new__(P.FragmentPanelManager)
    mgr.stats = {"seeds": 0, "kept": 0, "fallback": 0}
    mgr.stats_lock = threading.Lock()
    return mgr


def _slots_of(frag, keys):
    return {(o, m): frag.slot_seeds(_codes(o), m) for o, m, _, _ in keys}


def _same_contexts(block_frag, plain_frag, keys):
    got, want = _slots_of(block_frag, keys), _slots_of(plain_frag, keys)
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b, err_msg=str(k))
    assert block_frag.stats() == plain_frag.stats()


CASES = {
    # name: (fragments a batch, fragments resolved, groups' slot counts,
    #        eval on, overflowed fragments, kept_over)
    "two_groups": (8, 8, (40, 24), True, (), False),
    "partial_batch": (8, 3, (13, 8), True, (), False),
    "overflowed_fragment": (8, 8, (40, 24), True, (2, 5), False),
    "kept_over": (4, 4, (16, 9), True, (), True),
    "evaluator_off": (8, 8, (40, 24), False, (1,), False),
    "one_fragment": (1, 1, (5,), True, (), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [1, 2])
def test_block_injection_equals_the_plain_split(engine, case, seed):
    n, n_res, slot_counts, eval_on, over, kept_over = CASES[case]
    rng = np.random.default_rng(seed * 1000 + sorted(CASES).index(case))
    first = _keys(rng, slot_counts[0])
    shared = sorted({o for o, _, _, _ in first})[:3]
    groups = [_group(first)] + [_group(_keys(rng, c, shared))
                                for c in slot_counts[1:]]
    mgr = _manager()
    plain_stats = {"seeds": 0, "kept": 0, "fallback": 0}
    block_res = [P.PanelSeeds() for _ in range(n_res)]
    plain_res = [{} for _ in range(n_res)]
    for g in groups:
        n_real = len(g.keys)
        slot_len = [len(o) for o, _, _, _ in g.keys]
        cfg, pending = _batch(rng, n, -(-n_real // 8) * 8, n_real,
                              slot_len, eval_on, over, kept_over)
        dp = _panel(cfg, n_real, eval_on)
        got = dp.resolve_fragments(pending)[:n_res]
        want = _plain_resolve(dp, pending)[:n_res]
        for out, res in zip(block_res, got):
            mgr._merge_group(out, g, dp, res)
        for out, res in zip(plain_res, want):
            _plain_merge(out, g.keys, res, plain_stats)
    assert mgr.stats == plain_stats
    keys = [k for g in groups for k in g.keys]
    seq = rng.integers(0, 4, 3000).astype(np.uint8)
    for got, want in zip(block_res, plain_res):
        # the slot view of the program's result is the plain split
        view = dict(got.items())
        assert view.keys() == want.keys()
        for k in want:
            for a, b in zip(view[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        ctx = NativeFragContext(engine, seq, WORD_LEN, panel_result=got)
        plain = engine.frag_search(seq, WORD_LEN)
        _plain_inject(plain, want)
        _same_contexts(ctx.frag, plain, keys)
        ctx.close()
        plain.close()
    if kept_over:
        assert all(not r for r in block_res)
    if eval_on and not kept_over:
        assert plain_stats["kept"] > 0


def test_block_injection_drops_and_keeps_trusted_seeds(engine):
    """The evaluation filter both drops and keeps trusted seeds on these
    inputs (w0 & 2 entries under min_tm 0 and > 0 among them), so the
    parity above covers both outcomes."""
    rng = np.random.default_rng(7)
    keys = _keys(rng, 40)
    g = _group(keys)
    slot_len = [len(o) for o, _, _, _ in keys]
    cfg, pending = _batch(rng, 8, 40, 40, slot_len, True)
    dp = _panel(cfg, 40, True)
    out = P.PanelSeeds()
    mgr = _manager()
    for res in dp.resolve_fragments(pending):
        mgr._merge_group(out, g, dp, res)
    seq = rng.integers(0, 4, 3000).astype(np.uint8)
    totals = np.zeros(3, np.int64)
    for e in out:
        frag = engine.frag_search(seq, WORD_LEN)
        totals += frag.inject_block(e.group.table, e.kept, e.runs, e.counts,
                                    e.eval_on)
        frag.close()
    kept = out[0].kept
    trusted = (kept[4] & 1) != 0
    assert totals[0] == 8 * 40 and totals[1] == kept.shape[1]
    assert 0 < totals[2] < trusted.sum()
    assert ((kept[4] & 3) == 3).any()


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_runs_equal_the_mask_split(seed):
    """The offsets table of one bincount: each (slot, fragment) run of the
    kept block is the entries a fragment mask and a slot mask select, in
    the same order."""
    rng = np.random.default_rng(seed)
    n, n_real = 8, 21
    cfg, pending = _batch(rng, n, 24, n_real, [20] * n_real, True)
    dp = _panel(cfg, n_real, True)
    got = dp.resolve_fragments(pending)
    block = pending[1][1].numpy()[:, :int(pending[1][0][0])]
    for f, res in enumerate(got):
        assert isinstance(res, FragmentKept)
        assert res["runs"].shape == (n_real, 2)
        mine = block[0] // CAP == f
        assert res["n_kept"] == mine.sum()
        for s, (a, b) in enumerate(res["runs"]):
            np.testing.assert_array_equal(
                res["kept"][:, a:b], block[:, mine & (block[1] == s)])
        np.testing.assert_array_equal(res["os_k"], block[1][mine])
        np.testing.assert_array_equal(res["eval"], block[4:9][:, mine])


def test_arrays_set_by_hand_are_the_fragments_seeds(engine):
    """A fast resolve's result whose arrays were set by hand (os_k, p_k,
    kmin_k, eval) injects those entries, here none: every slot empty with
    its counts as given."""
    rng = np.random.default_rng(11)
    keys = _keys(rng, 12)
    cfg, pending = _batch(rng, 2, 16, 12, [len(k[0]) for k in keys], True)
    dp = _panel(cfg, 12, True)
    res = dp.resolve_fragments(pending)[1]
    ev = res["eval"]
    none = np.zeros(0, np.int32)
    res.update(os_k=none, p_k=none, kmin_k=none, eval=ev[:, :0],
               counts=np.zeros_like(res["counts"]), n_kept=0)
    kept, runs = kept_runs(res)
    assert kept.shape == (9, 0) and (runs == 0).all()
    out = P.PanelSeeds()
    _manager()._merge_group(out, _group(keys), dp, res)
    ctx = NativeFragContext(engine, rng.integers(0, 4, 500).astype(np.uint8),
                            WORD_LEN, panel_result=out)
    for (o, m, _, _) in keys:
        q, t, _ = ctx.frag.slot_seeds(_codes(o), m)
        assert len(q) == len(t) == 0
    assert ctx.frag.stats()["screened"] == 0
    ctx.close()


def test_injection_counters_on_the_traced_search(engine, monkeypatch):
    """A traced context's block injection adds its slots, seeds and drops
    to the search's counters host.inject.slots/seeds/dropped."""
    rng = np.random.default_rng(13)
    keys = _keys(rng, 24)
    cfg, pending = _batch(rng, 1, 24, 24, [len(k[0]) for k in keys], True)
    dp = _panel(cfg, 24, True)
    out = P.PanelSeeds()
    _manager()._merge_group(out, _group(keys), dp,
                            dp.resolve_fragments(pending)[0])
    monkeypatch.setenv("TNTBLAST_TPU_PROFILE", "1")
    seq = rng.integers(0, 4, 500).astype(np.uint8)
    with trace.search("test") as root:
        ctx = NativeFragContext(engine, seq, WORD_LEN, panel_result=out)
        dropped = ctx.frag.stats()["dev_evaluated"]
        ctx.close()
    counters = root.search.counters
    assert counters["host.inject.slots"] == 24
    assert counters["host.inject.seeds"] == out[0].kept.shape[1] > 0
    assert counters["host.inject.dropped"] == dropped
    assert "host.inject.slots 24" in trace.summary(root.search)
