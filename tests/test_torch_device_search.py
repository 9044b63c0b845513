"""The port's device search step (tntblast_tpu_torch.parallel.device_search,
CPU tensors) against the JAX panel_step_core on identical payloads: the
packed header and the used prefix of the kept block must be equal, and
with full=True every per-candidate array too.  Covers the word-table and
dense seeding paths, the N-run/exception payload, an exception-sideband
overflow, a fragment whose candidates overflow, multi-fragment batches,
pooled streams longer than the JAX step's 32768-entry chunk, and the
single-fragment interface of the panel and of the panel manager."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntblast_tpu import constants as C
from tntblast_tpu import native
from tntblast_tpu.parallel import device_search as J
from tntblast_tpu.screen import TpuScreen
from tntblast_tpu.search import seed
from tntblast_tpu.thermo.santa_lucia import build_tables
from tntblast_tpu_torch.ops import seed as S
from tntblast_tpu_torch.parallel import device_search as T

FWD = "TTGACCTAGATATTCAGCAAC"
REV = "GGGAGAGACTCACCCAAAGATC"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


def _mk_panel(oligos, word_len):
    panel = []
    for oligo, minus in oligos:
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        words = seed.oligo_word_list(codes, word_len, complement=not minus)
        panel.append({"words": words, "codes": codes, "minus": minus})
    return panel


def _db(s):
    return C.ASCII_TO_DB[np.frombuffer(s.encode(), np.uint8)]


def _port_of(jdp):
    return T.DevicePanel.from_tables(
        jdp.config, jdp.slot_meta, jdp.eval_const, jdp.s_max, jdp.k_max,
        J._PANEL_TABLES[jdp._tab_digest], "cpu", eval_on=jdp.eval_on)


def _compare_step(jdp, frags, full):
    payload = jdp._pack_host(frags)
    want = [np.asarray(x) for x in jdp._step(len(frags), full)(
        *(jnp.asarray(a) for a in payload), *jdp.args)]
    got = [x.numpy() for x in _port_of(jdp).step(payload, full=full)]
    np.testing.assert_array_equal(got[0], want[0], err_msg="header")
    n_kept = int(want[0][0])
    m = min(n_kept, jdp.config.batch_kcap(len(frags)))
    np.testing.assert_array_equal(got[1][:, :m], want[1][:, :m],
                                  err_msg="kept_block")
    if full:
        for name, g, w in zip(("slot", "p", "keep", "needs_host", "valid"),
                              got[2:], want[2:]):
            np.testing.assert_array_equal(g, w, err_msg=name)
    return want


@pytest.fixture(scope="module")
def table_panel(engine):
    """Word-table seeding, two screening conditions + the eval condition."""
    w = 7
    scr = TpuScreen(engine, dangle=False)
    conds = scr.conditions({"min_tm": 40.0, "max_dg": -9.0}, 9e-7)
    assert len(conds) == 2
    dg = np.stack([np.asarray(scr._dg_table(t)) for _, t, _ in conds])
    thr = np.array([[ms] * 4 for _, _, ms in conds], np.int32)
    cfg = J.PanelConfig(word_len=w, num_os=8, max_words=16, wq_max=22,
                        tile_len=16384, cap=1024, num_cond=2)
    oligos = [(FWD, True), (FWD, False), (REV, True), (REV, False)]
    ev_dg = np.ascontiguousarray(engine.delta_g().astype(np.int32).ravel())
    args = (_mk_panel(oligos, w), cfg, dg, thr)
    kw = dict(eval_dg=ev_dg, thermo_tables=build_tables())
    return J.DevicePanel(*args, **kw), args, kw


def test_port_builds_the_jax_panel_tables(table_panel):
    jdp, args, kw = table_panel
    pdp = T.DevicePanel(*args, **kw, device="cpu")
    assert pdp.slot_meta == jdp.slot_meta
    assert pdp.eval_const == jdp.eval_const
    assert (pdp.s_max, pdp.k_max, pdp.eval_on) == (jdp.s_max, jdp.k_max,
                                                   jdp.eval_on)
    for g, w in zip(pdp.host_tables, J._PANEL_TABLES[jdp._tab_digest]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_step_table_path_batch_with_n_runs_and_exceptions(table_panel):
    jdp = table_panel[0]
    rng = np.random.default_rng(41)
    planted = rng.integers(0, 4, 15000).astype(np.uint8)
    site = _db(FWD)
    for pos in (3000, 9000, 12000):
        planted[pos:pos + len(site)] = site
    rc = _db(REV)[::-1].copy()
    planted[6000:6000 + len(rc)] = 3 - rc
    # assembly-gap N runs + scattered degenerates, one next to a site
    gaps = rng.integers(0, 4, 16000).astype(np.uint8)
    gaps[2000:2000 + len(site)] = site
    gaps[1990:2000] = C.DB_N
    gaps[5000:5400] = C.DB_N
    for pos in rng.integers(0, 16000, 40):
        gaps[pos] = rng.integers(4, 16)
    # more scattered exceptions than the sideband holds: host fallback
    exc = rng.integers(0, 4, 12000).astype(np.uint8)
    exc[::5] = rng.integers(4, 16, len(exc[::5]))
    short = rng.integers(0, 4, 3000).astype(np.uint8)
    want = _compare_step(jdp, [planted, gaps, exc, short], full=True)
    header = want[0]
    assert header[0] > 0                       # windows were kept
    assert list(header[1:5]) == [0, 0, 1, 0]   # only `exc` overflowed


def test_step_table_path_batch_of_eight(table_panel):
    jdp = table_panel[0]
    rng = np.random.default_rng(7)
    frags = []
    for i in range(8):
        f = rng.integers(0, 4, int(rng.integers(1000, 16000))).astype(
            np.uint8)
        if i % 3 == 0:
            f[500:500 + len(FWD)] = _db(FWD)
        frags.append(f)
    frags[5] = np.zeros(0, np.uint8)           # an inert padding fragment
    _compare_step(jdp, frags, full=False)


def test_step_dense_path_fragment_overflow(engine):
    """Dense seeding (max_words > 31), no eval: a tandem-repeat fragment
    overflows its candidate capacity next to a clean batchmate."""
    rng = np.random.default_rng(33)
    oligo = "".join(rng.choice(list("ACGT"), 40))
    w = 7
    panel = _mk_panel([(oligo, True), (oligo, False)], w)
    max_words = max(len(p["words"]) for p in panel)
    cfg = J.PanelConfig(word_len=w, num_os=2, max_words=max_words,
                        wq_max=40, tile_len=16384, cap=256, num_cond=1)
    dg = engine.delta_g().astype(np.int32).reshape(1, -1)
    thr = np.full((1, 2), 120000, dtype=np.int32)
    jdp = J.DevicePanel(panel, cfg, dg, thr)
    assert jdp.args[1].shape[0] == 1 and not jdp.eval_on
    site = _db(oligo)
    frag_a = np.tile(site, 16000 // len(site)).astype(np.uint8)
    frag_b = rng.integers(0, 4, 16000).astype(np.uint8)
    for pos in (2000, 7000, 12000):
        frag_b[pos:pos + len(site)] = site
    want = _compare_step(jdp, [frag_a, frag_b], full=True)
    assert list(want[0][1:3]) == [1, 0]


@pytest.mark.parametrize("dense", [False, True])
def test_seed_fragments_match_jax(dense):
    import functools

    import jax

    rng = np.random.default_rng(11)
    L = 8192
    frag = rng.integers(0, 4, L).astype(np.uint8)
    for pos in rng.integers(0, L, 20):
        frag[pos] = rng.integers(4, 18)
    frag[100:100 + len(FWD)] = _db(FWD)
    w = 7
    panel = _mk_panel([(FWD, True), (FWD, False), (REV, True),
                       (REV, False)], w)
    num_os, max_words, cap = 4, 16, 512
    ow = np.full((num_os, max_words), -1, np.int32)
    w_tab = np.zeros((4 ** w, num_os), np.int32)
    for i, o in enumerate(panel):
        for k, v in enumerate(o["words"]):
            ow[i, k] = v
            w_tab[int(v), i] |= (1 << k)
    if dense:
        w_tab = np.zeros((1, num_os), np.int32)
    kw = dict(word_len=w, num_os=num_os, max_words=max_words, tile_len=L,
              cap=cap)
    want = jax.jit(functools.partial(J._seed_fragment, **kw))(
        jnp.asarray(frag), jnp.int32(7000), jnp.asarray(ow),
        jnp.asarray(w_tab))
    got = T.seed_fragments(
        torch.from_numpy(frag)[None], torch.tensor([7000], dtype=torch.int32),
        torch.from_numpy(ow), torch.from_numpy(w_tab), **kw)
    names = ["slot", "p", "n_cand", "counts", "overflow", "word",
             "word_valid"]
    for name, g, x in zip(names, got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(x),
                                      err_msg=name)
    assert int(want[2]) > 0


def test_low_bit_index_and_compaction():
    lanes = torch.tensor([1, 2, 3 << 4, 1 << 30, 1 << 31, (1 << 31) | 4,
                          0xFFFFFFFF], dtype=torch.int64)
    assert S._low_bit_index(lanes).tolist() == [0, 1, 4, 30, 31, 2, 0]
    mask = torch.tensor([[0, 1, 1, 0, 1], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]],
                        dtype=torch.bool)
    got = S.compact(mask, 3, 99)
    assert got.tolist() == [[1, 2, 4], [99, 99, 99], [0, 1, 2]]


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, T.FragmentKept):
            g = g.fields()
        assert g.keys() == w.keys()
        for k in g:
            if w[k] is None:
                assert g[k] is None, k
            else:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


def test_resolves_match_jax(table_panel):
    """Both resolve forms give the JAX panel's per-fragment results: the
    fast kept-only form and the full per-candidate form."""
    jdp = table_panel[0]
    pdp = _port_of(jdp)
    rng = np.random.default_rng(3)
    frags = [rng.integers(0, 4, n).astype(np.uint8) for n in (12000, 9000)]
    frags[0][4000:4000 + len(FWD)] = _db(FWD)
    _assert_results_equal(
        pdp.resolve_fragments(pdp.submit_fragments(frags)),
        jdp.resolve_fragments(jdp.submit_fragments(frags)))
    _assert_results_equal(
        pdp.resolve_fragments_full(pdp.submit_fragments(frags[:1],
                                                        full=True)),
        jdp.resolve_fragments_full(jdp.submit_fragments(frags[:1],
                                                        full=True)))


def test_step_wide_panel_shared_words(engine):
    """40 slots (both 32-bit occupancy lanes) with words shared between
    slots (a reverse-complement oligo pair: s_max > 1)."""
    rng = np.random.default_rng(19)
    oligos = ["".join(rng.choice(list("ACGT"), int(rng.integers(18, 25))))
              for _ in range(19)]
    oligos.append(oligos[0].translate(str.maketrans("ACGT", "TGCA"))[::-1])
    w = 7
    panel = _mk_panel([(o, m) for o in oligos for m in (True, False)], w)
    max_words = max(len(p["words"]) for p in panel)
    wq_max = max(len(o) for o in oligos)
    cfg = J.PanelConfig(word_len=w, num_os=40, max_words=max_words,
                        wq_max=wq_max, tile_len=16384, cap=4096, num_cond=1)
    dg = engine.delta_g_screen(np.float32(313.15)).astype(np.int32)
    thr = np.full((1, 40), 90000, np.int32)
    ev_dg = np.ascontiguousarray(engine.delta_g().astype(np.int32).ravel())
    jdp = J.DevicePanel(panel, cfg, dg.reshape(1, -1), thr, eval_dg=ev_dg,
                        thermo_tables=build_tables())
    assert jdp.s_max > 1 and jdp.args[1].shape[0] > 1
    frags = [rng.integers(0, 4, 16000).astype(np.uint8) for _ in range(2)]
    for i, o in enumerate(oligos[::4]):
        frags[i % 2][1000 + 700 * i:1000 + 700 * i + len(o)] = _db(o)
    want = _compare_step(jdp, frags, full=True)
    assert want[0][0] > 0


# ---- pooled streams longer than the JAX step's 32768-entry chunk --------

@pytest.fixture(scope="module")
def busy_panel(engine):
    """A panel that seeds on 4-base words: random sequence then gives some
    thousand candidates a fragment (dense seeding path: the slots share
    words), so a batch's pool can outgrow one JAX chunk of 32768."""
    w = 4
    scr = TpuScreen(engine, dangle=False)
    conds = scr.conditions({"min_tm": 40.0, "max_dg": -9.0}, 9e-7)
    dg = np.stack([np.asarray(scr._dg_table(t)) for _, t, _ in conds])
    thr = np.array([[ms] * 4 for _, _, ms in conds], np.int32)
    panel = _mk_panel([(FWD, True), (FWD, False), (REV, True),
                       (REV, False)], w)
    max_words = max(len(p["words"]) for p in panel)
    cfg = J.PanelConfig(word_len=w, num_os=8, max_words=max_words,
                        wq_max=22, tile_len=16384, cap=4096, num_cond=2)
    ev_dg = np.ascontiguousarray(engine.delta_g().astype(np.int32).ravel())
    return J.DevicePanel(panel, cfg, dg, thr, eval_dg=ev_dg,
                         thermo_tables=build_tables())


@pytest.mark.parametrize("frag_len,live_chunks", [(13500, 2), (3000, 1)])
def test_step_pool_longer_than_a_jax_chunk(busy_panel, frag_len,
                                           live_chunks):
    """Bp = 12 x 4096 entries > 32768: the port decodes, screens and
    evaluates the whole pooled stream in one launch of each stage, the JAX
    step runs two chunks of 32768 under lax.cond; with 13.5 kb fragments the
    pool reaches into the second chunk, with 3 kb ones that chunk lies past
    the pool and JAX skips it.  Every output is equal."""
    jdp = busy_panel
    cfg = jdp.config
    n = 12
    Bp = n * cfg.cap
    assert Bp > T.SCREEN_CHUNK
    assert T.chunk_entries(Bp, cfg.wq_max, cfg.wq_max + 8) == Bp
    rng = np.random.default_rng(frag_len)
    frags = [rng.integers(0, 4, frag_len).astype(np.uint8)
             for _ in range(n)]
    frags[0][500:500 + len(FWD)] = _db(FWD)
    frags[1][900:940] = C.DB_N
    want = _compare_step(jdp, frags, full=True)
    header = want[0]
    assert header[0] > 0 and not header[1:1 + n].any()
    n_pool = int(header[1 + n + cfg.num_os:1 + 2 * n + cfg.num_os].sum())
    assert -(-n_pool // T.SCREEN_CHUNK) == live_chunks


@pytest.mark.parametrize("frag_len", [13500])
def test_step_in_chunks_below_a_screen_chunk(busy_panel, monkeypatch,
                                             frag_len):
    """Where one SCREEN_CHUNK of M rows is over M_ROWS_BYTES (long oligos),
    chunk_entries takes whole blocks of KERNEL_BLOCK entries: with the
    budget cut to 300 entries' M rows the port's step screens and
    evaluates the stream in chunks of 256, and every output equals the JAX
    step's."""
    jdp = busy_panel
    cfg = jdp.config
    per = cfg.wq_max * (cfg.wq_max + 9) * 4
    monkeypatch.setattr(T, "M_ROWS_BYTES", 300 * per)
    n = 3
    Bp = n * cfg.cap
    ch = T.chunk_entries(Bp, cfg.wq_max, cfg.wq_max + 8)
    assert ch == 2 * T.KERNEL_BLOCK and Bp % ch == 0
    rng = np.random.default_rng(frag_len + 1)
    frags = [rng.integers(0, 4, frag_len).astype(np.uint8)
             for _ in range(n)]
    frags[2][700:700 + len(REV)] = _db(REV)
    want = _compare_step(jdp, frags, full=True)
    n_pool = int(want[0][1 + n + cfg.num_os:1 + 2 * n + cfg.num_os].sum())
    assert want[0][0] > 0 and n_pool > 4 * ch


@pytest.mark.parametrize("length", [140, 300])
def test_step_wide_probe_matches_jax(engine, length):
    """A probe of 140 or 300 nt on both strands (windows of 148 and 308
    columns, the dense seeding path): the port's step equals the JAX
    step, full outputs.  The 140-nt panel has the evaluator; the JAX
    package builds no evaluator tables past 256 nt, so the 300-nt panel
    screens only."""
    rng = np.random.default_rng(length)
    probe = "".join(rng.choice(list("ACGT"), length))
    w = 10
    panel = _mk_panel([(probe, True), (probe, False)], w)
    cfg = J.PanelConfig(word_len=w, num_os=8,
                        max_words=max(len(p["words"]) for p in panel),
                        wq_max=length, tile_len=8192, cap=512, num_cond=1)
    assert cfg.max_words > 31
    dg = engine.delta_g_screen(np.float32(313.15)).astype(np.int32)
    kw = {}
    if length <= 256:
        kw = dict(eval_dg=np.ascontiguousarray(
            engine.delta_g().astype(np.int32).ravel()),
            thermo_tables=build_tables())
    jdp = J.DevicePanel(panel, cfg, dg.reshape(1, -1),
                        np.full((1, 2), 100000, np.int32), **kw)
    frags = [rng.integers(0, 4, 6000).astype(np.uint8) for _ in range(2)]
    site = _db(probe)
    frags[0][300:300 + length] = site
    frags[1][500:500 + length] = (3 - site)[::-1]
    frags[1][500 + length // 2] ^= 1
    want = _compare_step(jdp, frags, full=True)
    assert want[0][0] > 0


# ---- the single-fragment interface ---------------------------------------

def test_single_fragment_interface_matches_jax(table_panel):
    """submit_fragment / resolve_fragment / resolve_fragment_fast /
    run_fragment give the JAX panel's results."""
    jdp = table_panel[0]
    pdp = _port_of(jdp)
    rng = np.random.default_rng(29)
    frag = rng.integers(0, 4, 11000).astype(np.uint8)
    frag[2500:2500 + len(FWD)] = _db(FWD)
    frag[6000:6000 + len(REV)] = 3 - _db(REV)[::-1]
    _assert_results_equal([pdp.run_fragment(frag)], [jdp.run_fragment(frag)])
    _assert_results_equal(
        [pdp.resolve_fragment(pdp.submit_fragment(frag, full=True))],
        [jdp.resolve_fragment(jdp.submit_fragment(frag, full=True))])
    got = pdp.resolve_fragment_fast(pdp.submit_fragment(frag))
    _assert_results_equal([got], [jdp.resolve_fragment_fast(
        jdp.submit_fragment(frag))])
    assert got["n_kept"] > 0


def _managers(monkeypatch):
    """The JAX FragmentPanelManager and the port's on pcr_small's
    configuration (tests/data), each with its own package's engine."""
    from tntblast_tpu import engine as jeng
    from tntblast_tpu import model as jmodel
    from tntblast_tpu.options import Options as JOptions
    from tntblast_tpu.parallel import panel as jpanel
    from tntblast_tpu_torch import engine as peng
    from tntblast_tpu_torch import model as pmodel
    from tntblast_tpu_torch.options import Options as POptions
    from tntblast_tpu_torch.parallel import panel as ppanel

    monkeypatch.chdir(pathlib.Path(__file__).resolve().parent / "data")
    argv = ["-i", "assay_pcr.txt", "-d", "small_db.fna", "-e", "40", "-E",
            "40"]
    out = []
    for Options, model, eng, mk in (
            (JOptions, jmodel, jeng,
             lambda o, e: jpanel.FragmentPanelManager(o, e)),
            (POptions, pmodel, peng,
             lambda o, e: ppanel.FragmentPanelManager(o, e, "cpu"))):
        opt = Options()
        opt.parse(argv)
        opt.sig_list = model.expand_degenerate_signatures(
            model.read_input_file(opt.input_filename, opt.ignore_probe,
                                  False), opt.degen_rescale_ct)
        out.append(mk(opt, eng.make_melt_engine(opt, n_threads=1)))
    return out


def test_manager_single_fragment_interface_matches_jax(monkeypatch):
    """FragmentPanelManager.submit / resolve / run_fragment: the port's
    slot dicts equal the JAX manager's, key for key, and its resolve
    equals the JAX manager's resolve_safe, which the port does not have
    (a resolve there has no deadline)."""
    jm, pm = _managers(monkeypatch)
    rng = np.random.default_rng(37)
    frag = rng.integers(0, 4, 9000).astype(np.uint8)
    frag[3000:3000 + len(FWD)] = _db(FWD)

    def same(got, want):
        got = dict(got.items())
        assert got.keys() == want.keys() and len(want) > 0
        for k in want:
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    same(pm.run_fragment(frag), jm.run_fragment(frag))
    same(pm.resolve(pm.submit(frag)), jm.resolve(jm.submit(frag)))
    same(pm.resolve(pm.submit(frag)), jm.resolve_safe(jm.submit(frag)))
    assert not hasattr(pm, "resolve_safe") and not hasattr(pm, "dead")
    assert pm.stats["fragments"] == jm.stats["fragments"] == 3
    assert pm.stats["seeds"] == jm.stats["seeds"] > 0
