"""The evaluation stage of the port's device step (ops/eval_pack.py).

On the CPU: `eval_pack_reference` (the plain PyTorch version, the kernel's
spec) against the JAX eval_flat + pack_eval word for word, tolerance zero;
and the CUDA kernel's own source (csrc/eval_pack.cu), built for the host
with g++ behind tests/cuda_host_shim/cuda_runtime.h and run one entry after
another, against the plain version on every entry: the kernel's arithmetic
is held here, its launch on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import ctypes
import os
import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntblast_tpu import native
from tntblast_tpu.ops import eval_gapless_jax as J
from tntblast_tpu.thermo.santa_lucia import build_tables
from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch.ops import eval_pack as P
from tntblast_tpu_torch.ops.screen_dp import screen_dp_reference
from tntblast_tpu_torch.tools.bench_inputs import (
    eval_inputs, eval_pack_args, synthetic_eval_panel)

from test_torch_eval_gapless import _flat_pool

HERE = pathlib.Path(__file__).resolve().parent


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
def tables():
    return build_tables()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_words(flat, ev_tabs, ev_loop, eval_const, needs_host, ent_valid):
    """JAX eval_flat + the packing of the JAX step's pack_eval (a closure of
    tntblast_tpu/parallel/device_search.py:584-610, restated here)."""
    n_slots = ev_tabs.shape[0]
    oh = (flat["sl"][:, None] == np.arange(n_slots)[None, :]).astype(
        np.float32)
    ev = J.eval_flat(flat["M"], flat["mg"], flat["t"], flat["q"],
                     flat["ql"], flat["wt"], oh, ev_tabs, ev_loop,
                     eval_const)
    trusted = ev["trusted"] & ~needs_host & ent_valid
    w0 = (trusted.astype(jnp.int32)
          | (ev["tm_zero"].astype(jnp.int32) << 1)
          | (jnp.clip(ev["num_base"], 0, 255) << 2)
          | (jnp.clip(ev["mm"], 0, 63) << 10)
          | (jnp.clip(ev["align_len"], 0, 63) << 16))
    w1 = ((ev["fm_q"] & 0xFF) | ((ev["fm_t"] & 0xFF) << 8)
          | ((ev["lm_q"] & 0xFF) << 16) | ((ev["lm_t"] & 0xFF) << 24))
    w2 = (ev["anchor5"] & 0xFF) | ((ev["anchor3"] & 0xFF) << 8)
    return np.asarray(jnp.stack(
        [w0, w1, w2, ev["dH"].view(jnp.int32), ev["dS"].view(jnp.int32)],
        axis=1))


def _pool_case(engine, tables, seed, qls, degenerate):
    """The mixed-slot pool of test_torch_eval_gapless (planted and mutated
    sites, junk in the M rows and columns out of contract) as eval_pack's
    arguments, with some entries needing the host, some invalid (their M
    rows all junk, as screen_dp leaves them) and, with `degenerate`, window
    codes 4 and 5 among the targets."""
    flat, ev_tabs, ev_loop, eval_const = _flat_pool(engine, tables, seed,
                                                    qls)
    rng = np.random.default_rng(seed + 1000)
    B = len(flat["ql"])
    n_slots, wq_max = ev_tabs.shape[:2]
    if degenerate:
        hit = rng.random(flat["t"].shape) < 0.04
        flat["t"] = np.where(hit, rng.integers(4, 6, flat["t"].shape),
                             flat["t"]).astype(np.int32)
    needs_host = rng.random(B) < 0.15
    ent_valid = rng.random(B) >= 0.1
    flat["M"][:, ~ent_valid] = rng.integers(
        -(1 << 31), 1 << 31, (wq_max, int((~ent_valid).sum()),
                              flat["M"].shape[2])).astype(np.int32)
    qc = np.zeros((n_slots + 1, wq_max), np.int32)
    for s in range(n_slots):
        qc[s] = flat["q"][np.flatnonzero(flat["sl"] == s)[0]]
    slot = np.where(ent_valid, flat["sl"], n_slots).astype(np.int32)
    args = [_t(flat["M"]), _t(flat["mg"]), _t(flat["t"]), _t(slot),
            _t(flat["ql"]), _t(flat["wt"]), _t(needs_host), _t(ent_valid),
            _t(qc), _t(ev_tabs), _t(ev_loop)]
    return flat, args, eval_const, needs_host, ent_valid


POOLS = [(23, (15, 19, 24), False), (31, (18, 21, 22, 25), False),
         (47, (9, 16, 30), True), (53, (12, 13, 20, 24), True)]


@pytest.mark.parametrize("seed,qls,degenerate", POOLS)
def test_reference_matches_jax_words(engine, tables, seed, qls, degenerate):
    flat, args, eval_const, needs_host, ent_valid = _pool_case(
        engine, tables, seed, qls, degenerate)
    got = P.eval_pack_reference(*args, eval_const).numpy()
    want = _jax_words(flat, args[9].numpy(), args[10].numpy(), eval_const,
                      needs_host, ent_valid)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[ent_valid], want[ent_valid])
    assert (got[~ent_valid] == 0).all() and (~ent_valid).sum() > 5
    trusted = got[:, 0] & 1
    assert trusted.sum() > 0.3 * len(trusted)
    assert not trusted[needs_host].any()
    # eval_pack on CPU tensors is the plain version, and launches nothing
    before = P.eval_pack.launches
    again = P.eval_pack(*args, eval_const)
    assert torch.equal(again, torch.from_numpy(got))
    assert P.eval_pack.launches == before


# ---- the kernel's source on the host -------------------------------------

@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/eval_pack.cu built by g++ with -DEVAL_PACK_HOST (the source then
    loops over the entries itself); no contraction of the f32 sums, as
    -fmad=false asks of nvcc."""
    lib = tmp_path_factory.mktemp("eval_pack_host") / "libeval_pack_host.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
         "-DEVAL_PACK_HOST", f"-I{HERE / 'cuda_host_shim'}", "-shared",
         "-fPIC", os.path.join(_kernels.CSRC, "eval_pack.cu"), "-o",
         str(lib)], check=True)
    fn = ctypes.CDLL(str(lib)).eval_pack_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(args, eval_const):
        wq_max, B, w1 = args[0].shape
        out = torch.full((B, 5), 7, dtype=torch.int32)
        rc = fn(*(a.data_ptr() for a in args), out.data_ptr(), B, wq_max,
                w1 - 1, args[8].shape[0], args[9].shape[0], *eval_const,
                None)
        assert rc == 0
        return out
    return run


def _assert_words_equal(got, want):
    bad = np.argwhere(got.numpy() != want.numpy())
    assert len(bad) == 0, (
        f"{len(bad)} words differ, first (entry, word) {bad[0].tolist()}: "
        f"kernel {got[bad[0][0]].tolist()} plain {want[bad[0][0]].tolist()}")


@pytest.mark.parametrize("seed,qls,degenerate", POOLS)
def test_kernel_source_matches_reference_on_pool(host_kernel, engine, tables,
                                                 seed, qls, degenerate):
    _, args, eval_const, _, ent_valid = _pool_case(engine, tables, seed, qls,
                                                   degenerate)
    want = P.eval_pack_reference(*args, eval_const)
    _assert_words_equal(host_kernel(args, eval_const), want)
    # every entry invalid: zeros, whatever the M rows hold
    args[7] = torch.zeros_like(args[7])
    got = host_kernel(args, eval_const)
    assert (got == 0).all()
    assert torch.equal(got, P.eval_pack_reference(*args, eval_const))


def _fuzz_case(rng, trial):
    """Random entries the pipeline would never make, to reach the corners:
    ql 0, windows narrower and wider than wt_max, M blocks without one
    non-negative cell, ties, diagonals that leave the block, zero and
    negative values on the diagonal, mismatched sites (loops)."""
    W = int(rng.integers(3, 30))
    wt_max = W + 8
    S = int(rng.integers(1, 6))
    B = int(rng.integers(1, 300))
    ql_s = rng.integers(max(1, W - 6), W + 1, S).astype(np.int32)
    if trial % 5 == 0:
        ql_s[0] = 0
    slot = rng.integers(0, S + 1, B).astype(np.int32)
    ent_valid = slot < S
    sc = np.clip(slot, 0, S - 1)
    ql = ql_s[sc].copy()
    wt_e = (ql + 8).astype(np.int32)
    if trial % 4 == 1:
        wt_e = rng.integers(0, wt_max + 3, B).astype(np.int32)
    top = int(rng.choice([3, 50, 100000]))
    M = rng.integers(-5, top, (W, B, wt_max + 1)).astype(np.int32)
    M[:, :, 0] = -1
    if trial % 3 == 0:
        M[:, ::2] = np.minimum(M[:, ::2], -1)
    mg = rng.integers(-5, top, B).astype(np.int32)
    tb5 = rng.integers(0, 6 if trial % 2 else 4, (B, wt_max)).astype(np.int32)
    qc = np.zeros((S + 1, W), np.int32)
    for s in range(S):
        qc[s, :ql_s[s]] = rng.integers(0, 5, ql_s[s])
    for b in range(0, B, 2):
        L = ql_s[sc[b]]
        if L == 0:
            continue
        off = int(rng.integers(0, 9))
        site = (3 - qc[sc[b], :L][::-1]) % 4
        for _ in range(int(rng.integers(0, 4))):
            site[int(rng.integers(0, L))] = rng.integers(0, 4)
        tb5[b, off:off + L] = site
        for r in range(L):
            if off + r + 1 <= wt_max:
                M[r, b, off + r + 1] = (10 + 5 * r if rng.random() > 0.05
                                        else int(rng.integers(-3, 2)))
    args = [_t(M), _t(mg), _t(tb5), _t(slot), _t(ql), _t(wt_e),
            _t(rng.random(B) < 0.2), _t(ent_valid), _t(qc),
            _t(rng.normal(size=(S, W, 25, 4)).astype(np.float32)),
            _t(rng.normal(size=(S, W + 2)).astype(np.float32))]
    return args, tuple(float(np.float32(x)) for x in rng.normal(size=4))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kernel_source_matches_reference_on_corners(host_kernel, seed):
    rng = np.random.default_rng(seed)
    n_trusted = n_closing = 0
    for trial in range(25):
        args, eval_const = _fuzz_case(rng, trial)
        want = P.eval_pack_reference(*args, eval_const)
        _assert_words_equal(host_kernel(args, eval_const), want)
        n_trusted += int((want[:, 0] & 1).sum())
        n_closing += int((((want[:, 0] >> 10) & 63) > 0).sum())
    assert n_trusted > 100 and n_closing > 100


@pytest.mark.parametrize("wq_max", [16, 24, 56])
def test_kernel_source_matches_reference_behind_screen_dp(host_kernel,
                                                          wq_max):
    """The stage as the step runs it, on the inputs the card tests and
    chip_smoke.py use (tools/bench_inputs.py): M rows and mgmax from
    screen_dp's plain version on slot-major windows with planted sites, the
    cells out of contract overwritten with junk, real thermodynamic
    tables."""
    rng = np.random.default_rng(100 + wq_max)
    B = 400
    pan = synthetic_eval_panel(rng, 6, wq_max, "cpu")
    dp_args, tb5, needs_host, ent_valid = eval_inputs(
        rng, B, pan["qp"], pan["qc"], pan["ql_slot"], pan["tcan"], "cpu",
        invalid=0.1, slot_major=True)
    _, slot, ql, wt_e = dp_args[:4]
    _, mgmax, M_rows = screen_dp_reference(*dp_args, eval_on=True)
    junk = torch.from_numpy(rng.integers(
        -9, 1 << 20, tuple(M_rows.shape)).astype(np.int32))
    rows = torch.arange(wq_max)[:, None, None]
    cols = torch.arange(wq_max + 9)[None, None, :]
    live = ((rows < ql[None, :, None]) & (cols <= wt_e[None, :, None])
            & ent_valid[None, :, None])
    M_rows = torch.where(live, M_rows, junk).contiguous()
    args = eval_pack_args(dp_args, M_rows, mgmax, tb5, needs_host, ent_valid,
                          pan["qc"], pan["ev_tabs"], pan["ev_loop"])
    want = P.eval_pack_reference(*args, pan["eval_const"])
    _assert_words_equal(host_kernel(args, pan["eval_const"]), want)
    w0 = want[:, 0]
    assert int((w0 & 1).sum()) > B // 4                # trusted
    assert int(((w0 & 3) == 1).sum()) > B // 8         # with a Tm to compute
    assert int((((w0 >> 10) & 63) > 0).sum()) > 20     # with mismatches
