"""The port's per-window DP and screen (tntblast_tpu_torch.ops.thermo_dp
dp_max_score / dp_delta_g / best_pair_table, TpuScreen.screen_windows, CPU
tensors) against the JAX package on the same numpy inputs from a seed.
Scores are int32 and must be equal exactly (tolerance 0); dp_delta_g must
be equal bit for bit as float32."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tntblast_tpu import native
from tntblast_tpu.ops import thermo_dp as J
from tntblast_tpu.screen import TpuScreen as JaxScreen
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import native as port_native
from tntblast_tpu_torch.ops import thermo_dp as T
from tntblast_tpu_torch.screen import TpuScreen, pack_windows
from tntblast_tpu_torch.search import bind

FWD = "TTGACCTAGATATTCAGCAAC"
DATA = pathlib.Path(__file__).resolve().parent / "data"
GOLD = DATA.parent / "golden" / "e2e"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


@pytest.fixture(scope="module")
def port_engine():
    return port_native.MeltEngine(n_threads=1)


def _both(fn_name, arrays, **kw):
    want = getattr(J, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    got = getattr(T, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    return got.numpy(), np.asarray(want)


def _batch(rng, B, wq, n_letters, ragged=True):
    wt = wq + 8
    qc = rng.integers(0, n_letters, (B, wq)).astype(np.int32)
    tc = rng.integers(0, n_letters, (B, wt)).astype(np.int32)
    if ragged:
        ql = rng.integers(0, wq + 1, B).astype(np.int32)
        tl = rng.integers(0, wt + 1, B).astype(np.int32)
        ql[:2], tl[:2] = wq, wt            # full rows among the ragged
    else:
        ql = np.full(B, wq, np.int32)
        tl = np.full(B, wt, np.int32)
    return qc, ql, tc, tl


def test_best_pair_table_matches_jax():
    got, want = T.best_pair_table(), J.best_pair_table()
    assert got.dtype == want.dtype == np.int32 and got.shape == (18, 18)
    np.testing.assert_array_equal(got, want)
    for base in range(18):
        for q in range(18):
            assert T._resolve_one(base, q) == J._resolve_one(base, q)


@pytest.mark.parametrize("temp", [313.15, 335.0])
@pytest.mark.parametrize("wq", [12, 24, 32])
def test_dp_max_score_matches_jax_over_the_alphabet(engine, wq, temp):
    """Random codes over all 18 letters, ragged q_len / t_len (0 among
    them) with arbitrary padding, the engine's real screening table."""
    rng = np.random.default_rng(1000 * wq + int(temp))
    dg = engine.delta_g_screen(np.float32(temp)).astype(np.int32).reshape(-1)
    arrays = (*_batch(rng, 96, wq, 18), dg)
    got, want = _both("dp_max_score", arrays, wq=wq, wt=wq + 8)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0 and (want == -1).any()


def test_dp_max_score_padded_rows_and_exact_table(engine):
    """A padded batch as screen_windows builds it (rows past the windows:
    the oligo against an empty target) on the exact, not the screening,
    table."""
    rng = np.random.default_rng(5)
    oligo = C.ASCII_TO_MELT[np.frombuffer(FWD.encode(), np.uint8)]
    wins = [rng.integers(0, 18, int(n)).astype(np.uint8)
            for n in rng.integers(5, len(oligo) + 9, 37)]
    dg = engine.delta_g().astype(np.int32).reshape(-1)
    arrays = (*pack_windows(oligo, wins, 64), dg)
    got, want = _both("dp_max_score", arrays, wq=len(oligo),
                      wt=len(oligo) + 8)
    np.testing.assert_array_equal(got, want)
    assert (got[37:] == -1).all()


def test_dp_delta_g_matches_jax_bit_for_bit(engine):
    rng = np.random.default_rng(9)
    dg = engine.delta_g_screen(np.float32(320.0)).astype(np.int32).reshape(-1)
    arrays = (*_batch(rng, 64, 20, 18), dg)
    got, want = _both("dp_delta_g", arrays, wq=20, wt=28)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("wq", [12, 24, 32, 130])
def test_dp_max_score_equals_dp_scores_canon_on_plain_codes(engine, wq):
    """Codes in {A, C, G, T, I}: the canonical-pair DP (the screen_dp
    kernel's plain version on the CPU) gives dp_max_score's score; at wq
    130 too, a window of 138 columns that TpuScreen.window_scores sends to
    the canonical leg since the kernel takes windows up to MAX_WT 1032."""
    rng = np.random.default_rng(77 + wq)
    qc, ql, tc, tl = _batch(rng, 80, wq, 5)
    ql = np.maximum(ql, 1)
    dg = engine.delta_g_screen(np.float32(313.15)).astype(np.int32).reshape(-1)
    full = T.dp_max_score(*(torch.from_numpy(a) for a in (qc, ql, tc, tl, dg)),
                          wq=wq, wt=wq + 8)
    qp = np.stack([
        T.build_qpair_rows([qc[i]], [ql[i]], wq=wq)[0] for i in range(80)])
    canon = T.dp_scores_canon(
        *(torch.from_numpy(a) for a in (qp, ql, tc, tl)),
        torch.from_numpy(T.build_t_canon(dg)))
    assert torch.equal(full, canon)
    assert int(full.max()) > 0


def _windows(rng, oligo, n, n_letters):
    """Windows around the oligo's site: its reverse complement with a few
    substitutions, flanked, of ragged length."""
    comp = np.array([3, 2, 1, 0], np.uint8)
    site = comp[oligo[::-1]]
    wins = []
    for _ in range(n):
        w = rng.integers(0, 4, len(oligo) + 8).astype(np.uint8)
        w[4:4 + len(site)] = site
        for pos in rng.integers(0, len(w), int(rng.integers(0, 9))):
            w[pos] = rng.integers(0, n_letters)
        wins.append(w[:int(rng.integers(len(w) - 6, len(w) + 1))])
    return wins


@pytest.mark.parametrize("n_letters,route", [(4, "canon"), (18, "full")])
def test_screen_windows_matches_jax(engine, port_engine, n_letters, route,
                                    monkeypatch):
    """Same keep / fail_tm / fail_dg masks and the same stats as the JAX
    TpuScreen, for both condition tags, on the route through the
    canonical-pair DP (plain codes) and through dp_max_score (degenerate
    codes)."""
    calls = {"canon": 0, "full": 0}
    plain_canon, plain_full = T.dp_scores_canon, T.dp_max_score
    monkeypatch.setattr(T, "dp_scores_canon", lambda *a, **k: (
        calls.__setitem__("canon", calls["canon"] + 1),
        plain_canon(*a, **k))[1])
    monkeypatch.setattr(T, "dp_max_score", lambda *a, **k: (
        calls.__setitem__("full", calls["full"] + 1),
        plain_full(*a, **k))[1])
    rng = np.random.default_rng(21 + n_letters)
    oligo = C.ASCII_TO_MELT[np.frombuffer(FWD.encode(), np.uint8)]
    jscr = JaxScreen(engine, dangle=False)
    pscr = TpuScreen(port_engine, dangle=False, device="cpu")
    assert pscr.slack == jscr.slack
    fired = set()
    for n, filt, conc in ((70, {"min_tm": 50.0, "max_dg": -6.0}, 9e-7),
                          (3, {"min_tm": 0.0, "max_dg": -12.0}, 9e-7),
                          (130, {"min_tm": 62.0, "max_dg": 0.0}, 2e-7)):
        conds = pscr.conditions(filt, conc)
        assert conds == jscr.conditions(filt, conc)
        wins = _windows(rng, oligo, n, n_letters)
        want = jscr.screen_windows(oligo, wins, filt, conc)
        got = pscr.screen_windows(oligo, wins, filt, conc)
        for g, w in zip(got, want):
            assert g.dtype == bool and g.shape == (n,)
            np.testing.assert_array_equal(g, w)
        if want[1].any():
            fired.add("tm")
        if want[2].any():
            fired.add("dg")
        assert {k: pscr.stats[k] for k in jscr.stats} == jscr.stats
    assert fired == {"tm", "dg"}
    assert pscr.stats["kept"] > 0 and pscr.stats["screened"] > 0
    other = "full" if route == "canon" else "canon"
    assert calls[route] > 0 and calls[other] == 0
    assert pscr.stats[route] == pscr.stats["batches"] == 3
    assert pscr.stats[other] == 0
    # one table pair per temperature, on the screen's device
    assert all(t.device.type == "cpu" for pair in
               pscr._device_tables.values() for t in pair)
    assert len(pscr._device_tables) == 3


def test_screen_windows_without_conditions_or_windows(port_engine):
    scr = TpuScreen(port_engine, device="cpu")
    oligo = C.ASCII_TO_MELT[np.frombuffer(FWD.encode(), np.uint8)]
    keep, ftm, fdg = scr.screen_windows(
        oligo, [], {"min_tm": 50.0, "max_dg": -6.0}, 9e-7)
    assert keep.shape == ftm.shape == fdg.shape == (0,)
    assert scr.stats == {"screened": 0, "kept": 0, "batches": 0,
                         "canon": 0, "full": 0}


def test_screen_windows_raises_without_a_card(port_engine):
    """The default device is the card: no DP on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scr = TpuScreen(port_engine)
    oligo = C.ASCII_TO_MELT[np.frombuffer(FWD.encode(), np.uint8)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scr.screen_windows(oligo, [oligo], {"min_tm": 50.0, "max_dg": -6.0},
                           9e-7)


@pytest.mark.parametrize("minus", [True, False])
def test_bind_oligo_with_a_screen_keeps_the_hit_list(port_engine, minus):
    """search/bind.py's caller: with a TpuScreen in the context the screen
    drops windows before the exact evaluator, leaves a ScreenStub for each,
    and the surviving list equals the one without a screen."""
    from tntblast_tpu_torch.io.fastx import open_database

    db = open_database(str(DATA / "small_db.fna"))
    filt = dict(min_tm=40.0, max_tm=9999.0, min_dg=-9999.0, max_dg=0.0,
                clamp_5=0, clamp_3=0, max_mm=999, max_gap=999,
                max_poly_degen=999)
    screened = hits = 0
    for tgt in range(db.size()):
        defline, seq = db.read(tgt, 0, db.approx_seq_len(tgt) - 1)
        lists = []
        for scr in (None, TpuScreen(port_engine, device="cpu")):
            ctx = bind.BindContext(port_engine, seq, 7, bind.MeltCaches(),
                                   defline, screen=scr)
            out = bind.bind_oligo(ctx, [], FWD, minus, 9e-7, filt)
            lists.append([(e.loc_5, e.loc_3, e.tm, e.dH, e.dS, e.anchor_5,
                           e.anchor_3, e.num_mm, e.num_gap, e.alignment)
                          for e in out])
        assert lists[0] == lists[1]
        hits += len(lists[0])
        screened += scr.stats["screened"]
        cache = ctx.caches.minus if minus else ctx.caches.plus
        stubs = [v for v in cache.values() if not isinstance(v, dict)]
        assert len(stubs) == scr.stats["screened"]
    assert screened > 0
    assert hits > 0 or not minus


@pytest.mark.parametrize("name", ["pcr_small", "probe_small"])
def test_window_screen_run_on_a_golden(name, monkeypatch):
    """The whole Python search layer over a golden configuration, as the
    smoke run drives it on the card: equal hits with and without the
    screen, and every batch's scores equal to dp_max_score over the padded
    rows (chip_smoke.window_screen_run raises otherwise)."""
    monkeypatch.chdir(DATA)
    args = (GOLD / f"{name}.cmd").read_text().split()
    res = chip_smoke.window_screen_run(torch, args, "cpu")
    assert res["hits"] > 0 and res["screened"] > 0 and res["batches"] > 0
    assert res["canon"] + res["full"] == res["batches"]
    assert res["rows_compared"] >= 64 * res["batches"]
    assert res["device"] == "cpu"


def test_checked_screen_catches_a_wrong_score(port_engine, monkeypatch):
    """The smoke run's checked screen fails when the DP behind
    screen_windows keeps too much on a padded partial batch."""
    rng = np.random.default_rng(3)
    oligo = C.ASCII_TO_MELT[np.frombuffer(FWD.encode(), np.uint8)]
    wins = _windows(rng, oligo, 25, 4)
    filt = {"min_tm": 50.0, "max_dg": -6.0}
    scr = chip_smoke.checked_screen(torch, port_engine, False, "cpu")
    scr.screen_windows(oligo, wins, filt, 9e-7)
    assert scr.rows == 2 * 64 and scr.stats["canon"] == 1
    plain = T.dp_scores_canon
    monkeypatch.setattr(T, "dp_scores_canon",
                        lambda *a, **k: plain(*a, **k) + 1)
    with pytest.raises(chip_smoke.SmokeFailure, match="differs from"):
        scr.screen_windows(oligo, wins, filt, 9e-7)


def test_window_screen_run_raises_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(DATA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chip_smoke.window_screen_run(
            torch, (GOLD / "pcr_small.cmd").read_text().split(), "cuda")
