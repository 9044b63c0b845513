"""The port's screen DP (tntblast_tpu_torch.ops.screen_dp, plain PyTorch
version on CPU) against the JAX package: the Pallas screen kernel in
interpret mode on slot-homogeneous blocks laid out as a flat stream, and
thermo_dp.dp_scores_canon for one condition.  Integer scores must be equal
exactly; the copied table functions must equal the originals."""

import numpy as np
import pytest
import torch

from tntblast_tpu import native
from tntblast_tpu.ops import thermo_dp as J
from tntblast_tpu.ops.pallas_screen import screen_blocks
from tntblast_tpu_torch.ops import thermo_dp as T
from tntblast_tpu_torch.ops.screen_dp import (
    MAX_WT, NEG_I32, REG_WIDTHS, TAB_Q_WORDS, TAB_WORDS, kernel_tables,
    kernel_width, screen_dp, screen_dp_reference)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engine():
    return native.MeltEngine(n_threads=1)


def test_copied_tables_match_jax(engine):
    for dg in (engine.delta_g(), engine.delta_g_screen(np.float32(313.15))):
        dg = dg.astype(np.int32).reshape(-1)
        np.testing.assert_array_equal(T.build_t_canon(dg),
                                      J.build_t_canon(dg))
    rng = np.random.default_rng(2)
    codes = [rng.integers(0, 5, int(rng.integers(6, 25))) for _ in range(9)]
    lens = [len(c) for c in codes]
    np.testing.assert_array_equal(T.build_qpair_rows(codes, lens, wq=24),
                                  J.build_qpair_rows(codes, lens, wq=24))


def _blocks_case(rng):
    """Random canonical tables (two screening conditions + eval), qpair
    rows and slot-homogeneous blocks; the Pallas operands plus the same
    windows as one flat stream."""
    BB, wq_max, wt_max = 32, 6, 14
    nc_all = 3
    n_real, n_blocks = 5, 4
    tcan = rng.integers(-60000, 60000,
                        (nc_all, 30, 30, 7)).astype(np.int32)
    qp = rng.integers(0, 30, (n_real, wq_max)).astype(np.int32)
    # the Pallas per-slot row table:
    # ts[s, r, v, c*7+k] = tcan[c, v, qp[s, r], k]
    ts = np.transpose(tcan[:, :, qp, :], (2, 3, 1, 0, 4)).reshape(
        n_real, wq_max, 30, nc_all * 7)
    meta = np.zeros((n_blocks, 4), np.int32)
    ptb_t = np.zeros((n_blocks, wt_max, BB), np.int32)
    for b in range(n_blocks):
        ql = int(rng.integers(3, wq_max + 1))
        meta[b] = (int(rng.integers(0, n_real)), ql, ql + 8,
                   0 if b == 2 else 1)
        ptb_t[b] = rng.integers(0, 30, (wt_max, BB))
    flat = {
        "ptb": np.ascontiguousarray(
            np.transpose(ptb_t, (0, 2, 1)).reshape(-1, wt_max)),
        "slot": np.repeat(np.where(meta[:, 3] == 1, meta[:, 0], 8), BB),
        "ql": np.repeat(meta[:, 1], BB),
        "wt_e": np.repeat(meta[:, 2], BB),
    }
    return tcan, qp, ts, meta, ptb_t, flat, nc_all


def _flat_screen(flat, qp, tcan, eval_on):
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in flat.items()}
    return screen_dp(t["ptb"], t["slot"], t["ql"], t["wt_e"],
                     torch.from_numpy(qp), torch.from_numpy(tcan),
                     eval_on=eval_on)


def test_screen_dp_matches_pallas_kernel():
    rng = np.random.default_rng(5)
    tcan, qp, ts, meta, ptb_t, flat, nc_all = _blocks_case(rng)
    n_blocks, wq_max, BB = meta.shape[0], qp.shape[1], ptb_t.shape[2]
    best_p, mg_p, mrows_p = (np.asarray(x) for x in screen_blocks(
        meta, ptb_t, ts, n_real=qp.shape[0], wq_max=wq_max,
        wt_max=ptb_t.shape[1], nc_all=nc_all, eval_on=True, BB=BB,
        interpret=True))
    best, mgmax, M_rows = _flat_screen(flat, qp, tcan, True)
    best = best.numpy().reshape(nc_all, n_blocks, BB)
    mgmax = mgmax.numpy().reshape(n_blocks, BB)
    for b in range(n_blocks):
        np.testing.assert_array_equal(best[:, b], best_p[b],
                                      err_msg=f"best block {b}")
        np.testing.assert_array_equal(mgmax[b], mg_p[b],
                                      err_msg=f"mgmax block {b}")
        if meta[b, 3] == 0:
            continue
        ql = int(meta[b, 1])
        rows = M_rows.numpy()[:ql, b * BB:(b + 1) * BB]   # (ql, BB, wt+1)
        assert (rows[:, :, 0] == -1).all()
        np.testing.assert_array_equal(
            rows[:, :, 1:], np.moveaxis(mrows_p[b], 2, 1)[:ql],
            err_msg=f"M_rows block {b}")
    assert (best[:, 2] == -1).all() and (mgmax[2] == NEG_I32).all()


def test_dp_scores_canon_matches_jax(engine):
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    B, wq, wt = 96, 24, 32
    dg = engine.delta_g().astype(np.int32).reshape(-1)
    tcan = J.build_t_canon(dg)
    comp = np.array([3, 2, 1, 0, 4])
    codes, tcodes = [], np.zeros((B, wt), np.int32)
    for b in range(B):
        q = rng.integers(0, 5, int(rng.integers(12, wq + 1)))
        codes.append(q)
        tcodes[b] = rng.integers(0, 5, wt)
        if b % 2:       # a (mutated) complementary site
            off = int(rng.integers(0, wt - len(q) + 1))
            tcodes[b, off:off + len(q)] = comp[q[::-1]]
            tcodes[b, int(rng.integers(0, wt))] = rng.integers(0, 5)
    ql = np.array([len(q) for q in codes], np.int32)
    tl = (ql + 8).astype(np.int32)
    qp = J.build_qpair_rows(codes, ql, wq=wq)
    want = np.asarray(J.dp_scores_canon(
        jnp.asarray(qp), jnp.asarray(ql), jnp.asarray(tcodes),
        jnp.asarray(tl), jnp.asarray(tcan), wq=wq, wt=wt))
    got = T.dp_scores_canon(torch.from_numpy(qp), torch.from_numpy(ql),
                            torch.from_numpy(tcodes), torch.from_numpy(tl),
                            torch.from_numpy(tcan)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > B // 4


def test_screen_dp_eval_off_keeps_scores():
    """Without the eval channel the per-condition scores are unchanged,
    the gapped-best channel is off and no M rows are produced."""
    rng = np.random.default_rng(4)
    tcan, qp, _, _, _, flat, _ = _blocks_case(rng)
    best_on, _, _ = _flat_screen(flat, qp, tcan, True)
    best_off, mg_off, rows_off = _flat_screen(flat, qp, tcan, False)
    assert torch.equal(best_on, best_off)
    assert (mg_off == NEG_I32).all() and rows_off is None


def test_screen_dp_cpu_runs_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    rng = np.random.default_rng(3)
    tcan, qp, _, _, _, flat, _ = _blocks_case(rng)
    before = screen_dp.launches
    got = _flat_screen(flat, qp, tcan, True)
    t = {k: torch.from_numpy(v.astype(np.int32)) for k, v in flat.items()}
    want = screen_dp_reference(t["ptb"], t["slot"], t["ql"], t["wt_e"],
                               torch.from_numpy(qp), torch.from_numpy(tcan),
                               eval_on=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert screen_dp.launches == before


def test_kernel_tables_layout():
    """The kernel's table is tcan re-laid: word q * 225 + k * 32 + v of
    condition c is -tcan[c, v, q, k] for every condition, target pair v,
    query pair q and energy k, and every other word is zero."""
    rng = np.random.default_rng(11)
    tcan = rng.integers(-60000, 60000, (3, 30, 30, 7)).astype(np.int32)
    tcan[tcan == 0] = 1
    tab = kernel_tables(torch.from_numpy(tcan))
    assert (TAB_Q_WORDS, TAB_WORDS) == (225, 6752)
    assert tab.shape == (3, TAB_WORDS) and tab.dtype == torch.int32
    assert tab.is_contiguous()
    got = tab.numpy()
    used = np.zeros(got.shape, bool)
    for c in range(3):
        for v in range(30):
            for q in range(30):
                for k in range(7):
                    at = q * TAB_Q_WORDS + k * 32 + v
                    assert got[c, at] == -tcan[c, v, q, k], (c, v, q, k)
                    used[c, at] = True
    assert used.sum() == tcan.size and (got[~used] == 0).all()


def test_kernel_width_for_every_wt_max():
    """Every window width the wrapper accepts (oligos up to 1024 nt) runs
    on the smallest register width that holds it, or on the strip path
    (0) beyond the widest."""
    assert REG_WIDTHS == tuple(sorted(REG_WIDTHS))
    for wt_max in range(1, MAX_WT + 1):
        w = kernel_width(wt_max)
        if wt_max > REG_WIDTHS[-1]:
            assert w == 0, wt_max
            continue
        assert w in REG_WIDTHS and wt_max <= w, wt_max
        assert not any(wt_max <= x < w for x in REG_WIDTHS), wt_max
    # the panels of tests/golden/e2e have wq_max 12, 22 and 24: no window
    # of theirs leaves the registers
    assert [kernel_width(wq + 8) for wq in (12, 22, 24)] == [24, 32, 32]
    for bad in (0, -3, MAX_WT + 1):
        with pytest.raises(ValueError):
            kernel_width(bad)


def test_register_widths_agree_with_the_sources():
    """REG_WIDTHS here and FOR_REG_WIDTHS in both .cu files name the same
    widths; screen_dp.cu takes MAX_WT columns (oligos up to 1024 nt), the
    probe PROBE_MAX_WT (its rows past the registers in shared memory)."""
    import os
    import re

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.ops.screen_probe import PROBE_MAX_WT

    assert MAX_WT == 1024 + 8
    for name, define, value in (("screen_dp.cu", "MAX_WT", MAX_WT),
                                ("screen_probe.cu", "PROBE_MAX_WT",
                                 PROBE_MAX_WT)):
        with open(os.path.join(_kernels.CSRC, name)) as fh:
            src = fh.read()
        line = re.search(r"#define FOR_REG_WIDTHS\(X\)(.*)", src).group(1)
        assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", line)) \
            == REG_WIDTHS, name
        assert re.search(rf"#define {define} {value}\b", src), name


# ---- windows past the register widths ------------------------------------

def _wide_case(rng, wt_max, B, nc_all=3, n_real=5):
    """A flat stream of B windows of wt_max columns: random tables, query
    pair rows and window pairs (some out of [0, 30): clamped), invalid
    slots on both sides of [0, n_real), oligo lengths from 1 to wq_max
    (the first three the longest), window widths from 1 to wt_max."""
    wq_max = wt_max - 8
    tcan = rng.integers(-3000, 3000, (nc_all, 30, 30, 7)).astype(np.int32)
    qp = rng.integers(0, 30, (n_real, wq_max)).astype(np.int32)
    ptb = rng.integers(-2, 32, (B, wt_max)).astype(np.int32)
    slot = rng.integers(-1, n_real + 1, B).astype(np.int32)
    ql = rng.integers(1, wq_max + 1, B).astype(np.int32)
    ql[:3] = wq_max
    slot[:3] = np.arange(3)
    wt_e = rng.integers(1, wt_max + 1, B).astype(np.int32)
    return [torch.from_numpy(a) for a in (ptb, slot, ql, wt_e, qp, tcan)]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/screen_dp.cu built by g++ with -DSCREEN_DP_HOST: its strip path,
    a block's warps one after another, a warp's lanes phase by phase."""
    import ctypes
    import os
    import pathlib
    import subprocess

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.ops.screen_dp import bind

    here = pathlib.Path(__file__).resolve().parent
    lib = tmp_path_factory.mktemp("screen_dp_host") / "libscreen_dp.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-DSCREEN_DP_HOST",
         f"-I{here / 'cuda_host_shim'}", "-shared", "-fPIC",
         os.path.join(_kernels.CSRC, "screen_dp.cu"), "-o", str(lib)],
        check=True)
    return bind(ctypes.CDLL(str(lib)))


def _run_host(host_kernel, case, eval_on, fill=12345):
    """The host build's strip path on a case; outputs and carry scratch
    start as junk."""
    launch, carry_words = host_kernel
    ptb, slot, ql, wt_e, qp, tcan = case
    B, wt_max = ptb.shape
    n_real, wq_max = qp.shape
    nc_all = tcan.shape[0]
    tab = kernel_tables(tcan)
    best = torch.full((nc_all, B), 7, dtype=torch.int32)
    mg = torch.full((B,), 7, dtype=torch.int32)
    M = (torch.full((wq_max, B, wt_max + 1), -77, dtype=torch.int32)
         if eval_on else None)
    carry = torch.full((carry_words(B, wq_max, nc_all, int(eval_on)),), fill,
                       dtype=torch.int32)
    rc = launch(*(t.data_ptr() for t in (ptb, slot, ql, wt_e, qp, tab, best,
                                         mg)),
                None if M is None else M.data_ptr(), carry.data_ptr(), B,
                wt_max, wq_max, nc_all, n_real, int(eval_on), 0, 0, None)
    assert rc == 0
    return best, mg, M


@pytest.mark.parametrize("wt_max,B", [(129, 70), (148, 70), (308, 70),
                                      (1032, 36)])
@pytest.mark.parametrize("eval_on", [True, False])
def test_kernel_source_strip_path_matches_reference(host_kernel, wt_max, B,
                                                    eval_on):
    """The strip path of csrc/screen_dp.cu against the plain version: best
    and mgmax of every window, the eval condition's M rows in contract, and
    nothing written out of contract (rows >= ql, invalid entries)."""
    assert kernel_width(wt_max) == 0
    case = _wide_case(np.random.default_rng(wt_max + B), wt_max, B,
                      nc_all=3 if eval_on else 2)
    want = screen_dp_reference(*case, eval_on=eval_on)
    best, mg, M = _run_host(host_kernel, case, eval_on)
    assert torch.equal(best, want[0]) and torch.equal(mg, want[1])
    if not eval_on:
        return
    ptb, slot, ql = case[:3]
    valid = (slot >= 0) & (slot < case[4].shape[0])
    rows = torch.arange(wt_max - 8)[:, None]
    keep = (rows < ql[None, :]) & valid[None, :]
    assert torch.equal(M[keep], want[2][keep])
    assert (M[~keep] == -77).all()
    assert int(valid.sum()) > B // 2 and (want[0][:, valid] > 0).any()


def test_kernel_source_strip_path_ignores_its_scratch(host_kernel):
    """The carry scratch needs no initial value: two fills, one result."""
    case = _wide_case(np.random.default_rng(3), 200, 40)
    a = _run_host(host_kernel, case, True, fill=0)
    b = _run_host(host_kernel, case, True, fill=-(1 << 30))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("wq_max", [140, 300])
def test_screen_dp_matches_the_jax_xla_screen_on_wide_windows(wq_max):
    """The plain version against the JAX step's XLA screen
    (tntblast_tpu/parallel/device_search.py::_screen_blocks_xla, the
    Pallas kernel's twin over its block layout) at wt_max 148 and 308:
    best, mgmax and M rows r < ql, exactly."""
    import jax.numpy as jnp

    from tntblast_tpu.parallel.device_search import _screen_blocks_xla

    rng = np.random.default_rng(wq_max)
    BB, wt_max, nc_all, n_real, n_blocks = 32, wq_max + 8, 3, 5, 3
    tcan = rng.integers(-60000, 60000, (nc_all, 30, 30, 7)).astype(np.int32)
    qp = rng.integers(0, 30, (n_real, wq_max)).astype(np.int32)
    ts = np.transpose(tcan[:, :, qp, :], (2, 3, 1, 0, 4)).reshape(
        n_real, wq_max, 30, nc_all * 7)
    meta = np.zeros((n_blocks, 4), np.int32)
    ptb_t = rng.integers(0, 30, (n_blocks, wt_max, BB)).astype(np.int32)
    for b in range(n_blocks):
        ql = int(rng.integers(wq_max - 20, wq_max + 1))
        meta[b] = (b, ql, ql + 8, 1)
    best_j, mg_j, rows_j = (np.asarray(x) for x in _screen_blocks_xla(
        jnp.asarray(meta), jnp.asarray(ptb_t), jnp.asarray(ts),
        wq_max=wq_max, wt_max=wt_max, nc_all=nc_all, eval_on=True, BB=BB,
        BPC=1))
    flat = {"ptb": np.ascontiguousarray(
                np.transpose(ptb_t, (0, 2, 1)).reshape(-1, wt_max)),
            "slot": np.repeat(meta[:, 0], BB), "ql": np.repeat(meta[:, 1], BB),
            "wt_e": np.repeat(meta[:, 2], BB)}
    best, mgmax, M_rows = _flat_screen(flat, qp, tcan, True)
    best = best.numpy().reshape(nc_all, n_blocks, BB)
    mgmax = mgmax.numpy().reshape(n_blocks, BB)
    for b in range(n_blocks):
        np.testing.assert_array_equal(best[:, b], best_j[b])
        np.testing.assert_array_equal(mgmax[b], mg_j[b])
        ql = int(meta[b, 1])
        rows = M_rows.numpy()[:ql, b * BB:(b + 1) * BB]
        np.testing.assert_array_equal(
            rows[:, :, 1:], np.moveaxis(rows_j[b], 2, 1)[:ql])
    assert (best > 0).any()
