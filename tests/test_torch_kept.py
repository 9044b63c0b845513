"""The kept-seed compaction of the port's device step (ops/kept.py).

On the CPU, three versions of the stage must be equal bit for bit on the
header and the (9, bkcap) kept block: the CUDA kernel's own source
(csrc/kept.cu), built for the host with g++ behind
tests/cuda_host_shim/cuda_runtime.h (-DKEPT_HOST: the head launch, then
the kept launch block by block in ticket order, odd tiles keeping their
own counts so that look-backs sum them, a block's threads phase by phase);
`kept_reference`, the plain PyTorch version; and the JAX step's keep flags
(run_chunk, with its select chain of thresholds) and kept compaction
(`jnp.nonzero(size=bkcap)`, its gathers, kmin and header), copied below jnp
for jnp from tntblast_tpu/parallel/device_search.py.

Cases: one and two screening conditions, with and without the eval
condition's row in best; the evaluator on and off (no ev tensor); n_kept
above bkcap, bkcap equal to the stream, a stream of one entry; every
entry invalid; every threshold off (INT_MIN) and thresholds nothing
passes; streams across
several of the kernel's tiles (KEPT_TILE, read from the source) and fill
tiles; the pooled prefix (sum of clamp(n_cand, 0, cap)) ending inside a
tile, on a tile's edge and at 0; bkcap between n_kept and n_pool and past
n_pool; every pooled entry kept (n_kept equal to n_pool); words that match
at k 0, at the last k, at k 31 and 33 and nowhere, over oligos of 1, 31,
32 and 40 words, and random words of 64 letters; diagonals before the
fragment and past its end; outputs and scratch of garbage; a stream that
is not n fragments of one cap, refused.
Also: a whole device step with the host-built pool and kept kernels behind
its plans (and none of the tensor code of those stages) equals the JAX
step, in one chunk of the screen and in several (the chunks' scores
concatenated, the last chunk short); the wrapper on CPU tensors is the
plain version and launches nothing; the plan refuses what the kernel does not take; the source's one
host switch.  The kernel's launch on the card is held by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import ctypes
import os
import pathlib
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntblast_tpu.parallel import device_search as J
from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.ops import kept as K
from tntblast_tpu_torch.ops import pool as P
from tntblast_tpu_torch.parallel import device_search as T
from tntblast_tpu_torch.tools.bench_inputs import (
    KEPT_ARGS as ARGS, kept_inputs as make_case)

HERE = pathlib.Path(__file__).resolve().parent
TILE = (_kernels.define("kept", "KEPT_THREADS")
        * _kernels.define("kept", "KEPT_ITEMS"))     # entries a tile
FILL = _kernels.define("kept", "KEPT_FILL")         # places a fill tile
INT_MIN = K.INT_MIN


def _build(tmp_path_factory, name):
    lib = tmp_path_factory.mktemp(f"{name}_host") / f"lib{name}.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", f"-D{name.upper()}_HOST",
         f"-I{HERE / 'cuda_host_shim'}", "-shared", "-fPIC",
         os.path.join(_kernels.CSRC, f"{name}.cu"), "-o", str(lib)],
        check=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/kept.cu built by g++ with -DKEPT_HOST."""
    return K.bind(_build(tmp_path_factory, "kept"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def run_host(lib, case, bkcap, fill=None):
    """The host-built kernel through its plan's C entries; `fill`, a byte,
    written over the outputs and the scratch first."""
    t = {k: (_t(case[k]) if case[k] is not None else None) for k in ARGS}
    Bp, n = case["slot_str"].shape[0], case["n_cand"].shape[0]
    plan = K.make_plan(lib, t["ow"], t["thr"], num_os=case["num_os"],
                       num_cond=case["num_cond"],
                       max_words=case["max_words"], nw_pos=case["nw_pos"],
                       index=0)
    out = K.empty_outputs(n, case["num_os"], bkcap, "cpu")
    scratch = torch.empty(lib.kept_scratch_words(Bp), dtype=torch.int32)
    if fill is not None:
        for x in (*out, scratch):
            x.view(torch.uint8).fill_(fill)
    rc = lib.kept_launch_plan(*K.launch_args(
        plan, t["best"], tuple(t[k] for k in ARGS[1:7]), t["ev_all"],
        (t["word_f"], t["word_valid_f"]),
        (t["overflow"], t["input_over"], t["n_cand"], t["counts"]), out,
        scratch, bkcap), None)
    assert rc == 0
    return [x.numpy() for x in out]


def run_reference(case, bkcap):
    args = [_t(case[k]) if case[k] is not None else None for k in ARGS]
    return [x.numpy() for x in K.kept_reference(
        *args, num_cond=case["num_cond"], num_os=case["num_os"],
        max_words=case["max_words"], nw_pos=case["nw_pos"], bkcap=bkcap)]


def run_jax(case, bkcap):
    """The JAX step's keep flags (run_chunk with slot_scalars' select
    chain, :517-527, :727-731) and kept compaction (:854-884), jnp for
    jnp, with pad_to = Bp."""
    num_cond, num_os = case["num_cond"], case["num_os"]
    max_words, nw_pos = case["max_words"], case["nw_pos"]
    sl = jnp.asarray(case["slot_str"])
    pad_to = sl.shape[0]
    best = jnp.asarray(case["best"])
    thresholds = jnp.asarray(case["thresholds"])
    thr_e = jnp.full((num_cond, pad_to), INT_MIN, jnp.int32)
    for s_ in range(case["n_real"]):
        m_s = sl == s_
        thr_e = jnp.where(m_s[None, :], thresholds[:, s_:s_ + 1], thr_e)
    keep = jnp.ones(pad_to, dtype=bool)
    for c in range(num_cond):
        keep = keep & ((best[c] >= thr_e[c]) | (thr_e[c] == INT_MIN))
    ent_valid = jnp.asarray(case["ent_valid"])
    keep_all = (keep | jnp.asarray(case["needs_host"])) & ent_valid
    ev_all = (jnp.asarray(case["ev_all"]) if case["ev_all"] is not None
              else jnp.zeros((pad_to, 5), jnp.int32))
    slot_str, p_str = sl, jnp.asarray(case["p_str"])
    frag_str = jnp.asarray(case["frag_str"])
    order_str = jnp.asarray(case["order_str"])
    word = jnp.asarray(case["word_f"])
    word_valid = jnp.asarray(case["word_valid_f"])
    oligo_words = jnp.asarray(case["ow"])
    overflow = jnp.asarray(case["overflow"] | case["input_over"])

    n_kept = keep_all.sum().astype(jnp.int32)
    (kept_idx,) = jnp.nonzero(keep_all, size=bkcap, fill_value=pad_to)
    kv = kept_idx < pad_to
    ks = jnp.clip(kept_idx, 0, pad_to - 1)
    os_k = jnp.where(kv, slot_str[ks], 0)
    p_k = jnp.where(kv, p_str[ks], 0)
    f_k = jnp.where(kv, frag_str[ks], 0)
    pool_idx = jnp.where(kv, order_str[ks], 0)
    kk = jnp.arange(max_words, dtype=jnp.int32)[None, :]
    tpos = p_k[:, None] + kk
    tin = (tpos >= 0) & (tpos < nw_pos)
    gidx = f_k[:, None] * nw_pos + jnp.clip(tpos, 0, nw_pos - 1)
    wv = word.reshape(-1)[gidx]
    wok = word_valid.reshape(-1)[gidx] & tin
    ow_sel = oligo_words[jnp.clip(os_k, 0, num_os - 1)]
    match = wok & (ow_sel >= 0) & (wv == ow_sel)
    kmin_k = jnp.min(jnp.where(match, kk, max_words), axis=1)
    kmin_k = jnp.where(kv, kmin_k, 0)
    ev_k = jnp.where(kv[:, None], ev_all[ks], 0)
    header = jnp.concatenate([
        n_kept[None], overflow.astype(jnp.int32),
        jnp.zeros(num_os, jnp.int32),
        jnp.asarray(case["n_cand"]), jnp.asarray(case["counts"]).reshape(-1)])
    kept_block = jnp.stack([
        pool_idx, os_k, p_k, kmin_k,
        ev_k[:, 0], ev_k[:, 1], ev_k[:, 2], ev_k[:, 3], ev_k[:, 4]])
    return [np.asarray(header), np.asarray(kept_block)]


def _check(lib, case, bkcap, fill=None):
    got = run_host(lib, case, bkcap, fill)
    ref = run_reference(case, bkcap)
    jx = run_jax(case, bkcap)
    for name, g, r, j in zip(("header", "kept_block"), got, ref, jx):
        np.testing.assert_array_equal(g, r, err_msg=f"kernel vs plain: "
                                                    f"{name}")
        np.testing.assert_array_equal(r, j, err_msg=f"plain vs JAX: {name}")
    return ref


@pytest.mark.parametrize("num_cond", [1, 2])
@pytest.mark.parametrize("eval_on", [True, False])
@pytest.mark.parametrize("rows_extra", [0, 1])
def test_kernel_reference_and_jax_agree(host_kernel, num_cond, eval_on,
                                        rows_extra):
    rng = np.random.default_rng(num_cond * 10 + eval_on * 2 + rows_extra)
    case = make_case(rng, num_cond=num_cond, rows=num_cond + rows_extra,
                     eval_on=eval_on)
    Bp = case["slot_str"].shape[0]
    ref = _check(host_kernel, case, 3 * Bp // 4)
    assert 0 < ref[0][0] < 3 * Bp // 4


@pytest.mark.parametrize("bkcap_of", [
    lambda k: max(k // 3, 1), lambda k: k, lambda k: k + 1])
def test_around_n_kept(host_kernel, bkcap_of):
    """n_kept above bkcap (the block holds the first bkcap; header[0] the
    whole count), at it, and one below it (one place of zeros)."""
    rng = np.random.default_rng(5)
    case = make_case(rng, n=3, cap=3 * TILE)
    n_kept = int(run_reference(case, 1)[0][0])
    bkcap = bkcap_of(n_kept)
    ref = _check(host_kernel, case, bkcap)
    assert ref[0][0] == n_kept and ref[1].shape == (9, bkcap)


def test_bkcap_is_the_stream(host_kernel):
    rng = np.random.default_rng(9)
    case = make_case(rng, n=2, cap=FILL + 100, valid_share=0.9)
    _check(host_kernel, case, 2 * (FILL + 100))


def test_one_entry(host_kernel):
    rng = np.random.default_rng(2)
    case = make_case(rng, n=1, cap=1, num_os=8, valid_share=1.5,
                     nh_share=1.0)
    ref = _check(host_kernel, case, 1)
    assert ref[0][0] == 1


def test_every_entry_invalid(host_kernel):
    """No pooled candidate: n_kept 0, the whole block zeros."""
    rng = np.random.default_rng(4)
    case = make_case(rng, n=3, cap=2 * TILE + 9, valid_share=0.0)
    ref = _check(host_kernel, case, 3 * TILE)
    assert ref[0][0] == 0 and not ref[1].any()


@pytest.mark.parametrize("off", [True, False])
def test_thresholds_all_off_and_none_passed(host_kernel, off):
    """Every threshold off (INT_MIN: every pooled entry kept, even with a
    score below INT_MIN) and thresholds no score reaches, on every slot
    (only needs_host entries kept)."""
    rng = np.random.default_rng(off)
    case = make_case(rng, n=2, cap=TILE + 50, n_real=16,
                     off_share=1.0 if off else 0.0)
    case["best"][:, ::7] = -(1 << 31)
    if not off:
        case["best"][:] = -1
    ref = _check(host_kernel, case, 2 * TILE + 100)
    want = case["ent_valid" if off else "needs_host"].sum()
    assert ref[0][0] == want


def test_kmin_at_the_first_the_last_and_no_word(host_kernel):
    """Oligo words that match only at k 0, only at the last k, or never;
    diagonals before the fragment and past its end."""
    rng = np.random.default_rng(8)
    case = make_case(rng, n=2, cap=1500, max_words=9, nw_pos=600)
    case["word_f"][:] = 1
    case["word_valid_f"][:] = True
    ow = np.full_like(case["ow"], 2)
    ow[0::3, 0] = 1
    ow[1::3, 8] = 1
    case["ow"] = ow
    case["needs_host"] = case["ent_valid"].copy()     # keep every entry
    ref = _check(host_kernel, case, 3000)
    kmin = ref[1][3, :ref[0][0]]
    assert {0, 8, 9} <= set(kmin.tolist())


@pytest.mark.parametrize("n_cand", [
    (TILE + 300, 600, 0),       # the pooled prefix ends inside a tile
    (TILE, TILE, 0),            # on a tile's edge
    (0, 0, 0)])                 # at 0
def test_pooled_prefix_inside_a_tile_on_its_edge_and_at_zero(host_kernel,
                                                            n_cand):
    """Tiles at or past the pooled prefix (sum of clamp(n_cand, 0, cap))
    read nothing and exit, the last pooled tile writes n_kept, and the fill
    tiles zero the places past the pool at once."""
    rng = np.random.default_rng(sum(n_cand) + 31)
    cap = TILE + 300
    case = make_case(rng, n=3, cap=cap, n_cand=n_cand)
    assert case["ent_valid"].sum() == sum(min(c, cap) for c in n_cand)
    ref = _check(host_kernel, case, 2 * TILE, fill=0xFF)
    assert not ref[1][:, ref[0][0]:].any()


@pytest.mark.parametrize("bkcap_of", [
    lambda k, np_: (k + np_) // 2,      # between n_kept and n_pool
    lambda k, np_: np_,
    lambda k, np_: np_ + 700])          # past the pool
def test_bkcap_below_and_above_the_pool(host_kernel, bkcap_of):
    """bkcap between n_kept and n_pool, at n_pool and past it: the places
    past n_pool are zeroed without a wait, those from n_kept to n_pool
    after it."""
    rng = np.random.default_rng(17)
    case = make_case(rng, n=3, cap=2 * TILE + 100)
    n_kept = int(run_reference(case, 1)[0][0])
    n_pool = int(case["ent_valid"].sum())
    assert n_kept < n_pool
    ref = _check(host_kernel, case, bkcap_of(n_kept, n_pool), fill=0xFF)
    assert ref[0][0] == n_kept


@pytest.mark.parametrize("bkcap_of", [
    lambda np_: np_ // 2, lambda np_: np_, lambda np_: np_ + 700])
def test_every_pooled_entry_kept(host_kernel, bkcap_of):
    """n_kept equal to n_pool (the host takes every candidate): no place
    between them waits to be zeroed; bkcap below, at and past n_pool."""
    rng = np.random.default_rng(19)
    case = make_case(rng, n=3, cap=2000)
    case["needs_host"] = case["ent_valid"].copy()
    n_pool = int(case["ent_valid"].sum())
    ref = _check(host_kernel, case, bkcap_of(n_pool))
    assert ref[0][0] == n_pool


@pytest.mark.parametrize("max_words", [1, 31, 32, 40])
def test_kmin_across_a_warp_of_words(host_kernel, max_words):
    """kmin over oligos of 1 and 31 words (the table path's most) and of 32
    and 40 (the dense path): words that match only at k 0, at the last k,
    at k 31, at k 33 (past the lanes' first 32) or never."""
    rng = np.random.default_rng(max_words)
    case = make_case(rng, n=2, cap=1500, max_words=max_words, nw_pos=600)
    case["word_f"][:] = 1
    case["word_valid_f"][:] = True
    ow = np.full_like(case["ow"], 2)
    for s_, k in enumerate((0, max_words - 1, 31, 33)):
        ow[s_::5, min(k, max_words - 1)] = 1
    case["ow"] = ow
    case["needs_host"] = case["ent_valid"].copy()     # keep every entry
    ref = _check(host_kernel, case, 3000)
    kmin = set(ref[1][3, :ref[0][0]].tolist())
    assert {0, max_words - 1, max_words} <= kmin
    if max_words == 40:
        assert {31, 33} <= kmin


@pytest.mark.parametrize("max_words", [32, 40])
def test_kmin_of_words_from_a_large_alphabet(host_kernel, max_words):
    """Random words of 64 letters: most kept entries match no word of the
    first 32, so kmin takes the lanes' second pass or is max_words."""
    rng = np.random.default_rng(max_words + 100)
    case = make_case(rng, n=3, cap=1800, max_words=max_words, alphabet=64)
    ref = _check(host_kernel, case, 4000)
    kmin = ref[1][3, :ref[0][0]]
    assert (kmin == max_words).any() and (kmin < max_words).any()


@pytest.mark.parametrize("fill", [0x00, 0xFF, 0x7F])
def test_outputs_and_scratch_of_garbage(host_kernel, fill):
    """Scratch of any value: the head launch resets the tile counter and
    the status words (as before every replay of a CUDA graph)."""
    rng = np.random.default_rng(fill + 1)
    case = make_case(rng, n=3, cap=2 * TILE + 1)
    _check(host_kernel, case, 5000, fill=fill)


def test_repeated_calls_on_one_scratch(host_kernel):
    """Two calls on the same scratch and outputs, as two replays of a
    graph: the second starts from the first's spent tickets and final
    status words and must give the same outputs."""
    rng = np.random.default_rng(13)
    case = make_case(rng, n=3, cap=2 * TILE + 3)
    Bp = case["slot_str"].shape[0]
    t = {k: (_t(case[k]) if case[k] is not None else None) for k in ARGS}
    plan = K.make_plan(host_kernel, t["ow"], t["thr"], num_os=16,
                       num_cond=2, max_words=12, nw_pos=4000, index=0)
    out = K.empty_outputs(3, 16, 5000, "cpu")
    scratch = torch.empty(host_kernel.kept_scratch_words(Bp),
                          dtype=torch.int32)
    want = run_reference(case, 5000)
    for _ in range(3):
        rc = host_kernel.kept_launch_plan(*K.launch_args(
            plan, t["best"], tuple(t[k] for k in ARGS[1:7]),
            t["ev_all"], (t["word_f"], t["word_valid_f"]),
            (t["overflow"], t["input_over"], t["n_cand"], t["counts"]), out,
            scratch, 5000), None)
        assert rc == 0
        for g, w in zip(out, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(12)
    case = make_case(rng, n=2, cap=500)
    args = [_t(case[k]) if case[k] is not None else None for k in ARGS]
    before = K.kept.launches
    got = K.kept(*args, num_cond=2, num_os=16, max_words=12, nw_pos=4000,
                 bkcap=600)
    want = run_reference(case, 600)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert K.kept.launches == before


@pytest.mark.parametrize("field, value", [
    ("num_os", 0), ("num_os", 65), ("num_cond", 0), ("max_words", 0),
    ("nw_pos", 0)])
def test_plan_refuses_what_the_kernel_does_not_take(host_kernel, field,
                                                    value):
    kw = dict(num_os=8, num_cond=1, max_words=4, nw_pos=100, index=0)
    kw[field] = value
    ow = torch.zeros((8, 4), dtype=torch.int32)
    thr = torch.zeros((1, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="refuses"):
        K.make_plan(host_kernel, ow, thr, **kw)


def test_launch_refuses_bkcap_past_the_stream(host_kernel):
    rng = np.random.default_rng(1)
    case = make_case(rng, n=1, cap=100)
    t = {k: (_t(case[k]) if case[k] is not None else None) for k in ARGS}
    plan = K.make_plan(host_kernel, t["ow"], t["thr"], num_os=16,
                       num_cond=2, max_words=12, nw_pos=4000, index=0)
    out = K.empty_outputs(1, 16, 101, "cpu")
    scratch = torch.empty(host_kernel.kept_scratch_words(100),
                          dtype=torch.int32)
    rc = host_kernel.kept_launch_plan(*K.launch_args(
        plan, t["best"], tuple(t[k] for k in ARGS[1:7]),
        t["ev_all"], (t["word_f"], t["word_valid_f"]),
        (t["overflow"], t["input_over"], t["n_cand"], t["counts"]), out,
        scratch, 101), None)
    assert rc != 0


def test_launch_refuses_a_stream_not_of_n_fragments(host_kernel):
    """The kernel takes the fragments' cap as Bp / n: a stream that is not
    n fragments of one cap is refused."""
    rng = np.random.default_rng(3)
    case = make_case(rng, n=3, cap=100)
    t = {k: (_t(case[k]) if case[k] is not None else None) for k in ARGS}
    plan = K.make_plan(host_kernel, t["ow"], t["thr"], num_os=16,
                       num_cond=2, max_words=12, nw_pos=4000, index=0)
    out = K.empty_outputs(3, 16, 200, "cpu")
    scratch = torch.empty(host_kernel.kept_scratch_words(300),
                          dtype=torch.int32)
    args = list(K.launch_args(
        plan, t["best"], tuple(t[k] for k in ARGS[1:7]),
        t["ev_all"], (t["word_f"], t["word_valid_f"]),
        (t["overflow"], t["input_over"], t["n_cand"], t["counts"]), out,
        scratch, 200))
    assert args[-3:-1] == [300, 3]
    args[-2] = 7
    assert host_kernel.kept_launch_plan(*args, None) != 0


def test_plan_serves_a_card():
    with pytest.raises(ValueError, match="card"):
        K.KeptPlan(torch.zeros((8, 4), dtype=torch.int32),
                   torch.zeros((1, 9), dtype=torch.int32), nw_pos=100)


def _step_panel():
    """A JAX panel with word-table seeding, the evaluator and a screening
    condition that keeps some windows, and the port's panel of its tables
    on the CPU."""
    from tntblast_tpu import native
    from tntblast_tpu.search import seed as jseed
    from tntblast_tpu.thermo.santa_lucia import build_tables

    eng = native.MeltEngine(n_threads=1)
    panel = []
    for oligo in ("TTGACCTAGATATTCAGCAAC", "GGGAGAGACTCACCCAAAGATC"):
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        for minus in (True, False):
            panel.append({"words": jseed.oligo_word_list(
                codes, 7, complement=not minus), "codes": codes,
                "minus": minus})
    cfg = J.PanelConfig(word_len=7, num_os=8, max_words=16, wq_max=22,
                        tile_len=8192, cap=1024, num_cond=1)
    dg = eng.delta_g_screen(np.float32(313.15)).astype(np.int32)
    jdp = J.DevicePanel(panel, cfg, dg.reshape(1, -1),
                        np.asarray([[0, INT_MIN, 5000, 0]], np.int32),
                        eval_dg=eng.delta_g().astype(np.int32).ravel(),
                        thermo_tables=build_tables())
    pdp = T.DevicePanel.from_tables(
        jdp.config, jdp.slot_meta, jdp.eval_const, jdp.s_max, jdp.k_max,
        J._PANEL_TABLES[jdp._tab_digest], "cpu", eval_on=jdp.eval_on)
    return jdp, pdp


@pytest.fixture(scope="module")
def host_pool(tmp_path_factory):
    """csrc/pool.cu built by g++ with -DPOOL_HOST."""
    return P.bind(_build(tmp_path_factory, "pool"))


def _step_frags(rng, sites=()):
    """Three fragments with the first oligo planted at three places (and
    at `sites`, (fragment, position) pairs), an N run and a base code
    past the alphabet."""
    frags = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (8000, 5000, 7000)]
    oligo = C.ASCII_TO_DB[np.frombuffer(b"TTGACCTAGATATTCAGCAAC", np.uint8)]
    for f, at in ((0, 1000), (1, 4000), (2, 30), *sites):
        frags[f][at:at + 21] = oligo
    frags[1][2000:2300] = C.DB_N
    frags[2][3000] = 9
    return frags


def _host_step(host_kernel, host_pool, monkeypatch, frags):
    """The port's CPU step with pool and kept plans in its tables (here the
    host-built kernels behind the plans' calls; the tensor code of those
    stages refuses to run) and the JAX step, on `frags`: (got, want,
    config, the plans' calls)."""
    jdp, pdp = _step_panel()
    cfg = pdp.config
    st = pdp.tabs["slots"]
    pplan = P.make_plan(host_pool, num_os=cfg.num_os, cap=cfg.cap, index=0)
    kplan = K.make_plan(host_kernel, pdp.tabs["ow"], st["thr"],
                        num_os=cfg.num_os, num_cond=cfg.num_cond,
                        max_words=cfg.max_words,
                        nw_pos=cfg.tile_len - cfg.word_len + 1, index=0)
    calls = []

    def host_pool_call(slot, p, n_cand):
        n = slot.shape[0]
        out = P.empty_outputs(n, cfg.cap, "cpu")
        scratch = torch.empty(host_pool.pool_scratch_words(pplan, n),
                              dtype=torch.int32)
        assert host_pool.pool_launch_plan(
            *P.launch_args(pplan, slot, p, n_cand, out, scratch), None) == 0
        calls.append("pool")
        return out

    def host_kept(best, *rest, bkcap):
        stream_in, ev_all, words, frag_in = (rest[:6], rest[6], rest[7:9],
                                             rest[9:])
        Bp, n = stream_in[0].shape[0], frag_in[2].shape[0]
        out = K.empty_outputs(n, cfg.num_os, bkcap, "cpu")
        scratch = torch.empty(host_kernel.kept_scratch_words(Bp),
                              dtype=torch.int32)
        assert host_kernel.kept_launch_plan(*K.launch_args(
            kplan, best.contiguous(), stream_in, ev_all, words, frag_in,
            out, scratch, bkcap), None) == 0
        calls.append("kept")
        return out

    def refuse(*a, **k):
        raise AssertionError("the step pooled or compacted through tensor "
                             "code")

    monkeypatch.setattr(T, "pool", refuse)
    monkeypatch.setattr(T, "kept", refuse)
    pdp.tabs["pool_plan"] = host_pool_call
    pdp.tabs["kept_plan"] = host_kept
    payload = jdp._pack_host(frags)
    want = [np.asarray(x) for x in jdp._step(3, True)(
        *(jnp.asarray(a) for a in payload), *jdp.args)]
    got = [x.numpy() for x in pdp.step(payload, full=True)]
    return got, want, cfg, calls


def _same_as_jax(got, want, cfg):
    np.testing.assert_array_equal(got[0], want[0], err_msg="header")
    m = min(int(want[0][0]), cfg.batch_kcap(3))
    assert m > 0
    np.testing.assert_array_equal(got[1], want[1], err_msg="kept_block")
    for name, g, w in zip(("slot", "p", "keep", "needs_host", "valid"),
                          got[2:], want[2:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    return m


def test_step_through_the_host_built_kernels_equals_the_jax_step(
        host_kernel, host_pool, monkeypatch):
    """The device step with pool and kept plans in its tables (here the
    host-built kernels behind the plans' calls) pools and compacts through
    them alone, never through the tensor code of those stages, and its
    header, kept block, slot, p, keep, needs_host and valid equal the JAX
    step's."""
    got, want, cfg, calls = _host_step(
        host_kernel, host_pool, monkeypatch,
        _step_frags(np.random.default_rng(21)))
    assert calls == ["pool", "kept"]
    _same_as_jax(got, want, cfg)


@pytest.mark.parametrize("chunk", [16, 40, 1000])
def test_step_in_chunks_through_the_host_built_kernels(
        host_kernel, host_pool, monkeypatch, chunk):
    """The same step with its screen and evaluator in chunks of `chunk`
    entries (the last one short), as a panel of long oligos runs them: the
    kept kernel reads the chunks' scores and words concatenated, and the
    step equals the JAX step, which runs the stream in one chunk.  Sites
    planted every 400 bases put kept entries in several chunks."""
    rng = np.random.default_rng(22)
    sites = [(f, at) for f, n in ((0, 8000), (1, 5000), (2, 7000))
             for at in range(200, n - 30, 400) if not 1900 < at < 2400]
    chunks = []
    screen_dp = T.screen_dp

    def counted(*a, **k):
        chunks.append(a[0].shape[0])
        return screen_dp(*a, **k)

    monkeypatch.setattr(T, "SCREEN_CHUNK", chunk)
    # one chunk's M rows exactly (the step panel's wq_max 22): chunks of
    # SCREEN_CHUNK entries (a budget below that gives whole KERNEL_BLOCKs)
    monkeypatch.setattr(T, "M_ROWS_BYTES", chunk * 22 * (22 + 9) * 4)
    monkeypatch.setattr(T, "screen_dp", counted)
    got, want, cfg, calls = _host_step(host_kernel, host_pool, monkeypatch,
                                       _step_frags(rng, sites))
    assert calls == ["pool", "kept"] and cfg.wq_max == 22
    Bp = 3 * cfg.cap
    assert chunks == [chunk] * (Bp // chunk) + (
        [Bp % chunk] if Bp % chunk else [])
    m = _same_as_jax(got, want, cfg)
    if chunk < 1000:
        assert m > 2 * chunk          # kept entries in three chunks or more


def test_source_has_a_plain_c_entry_and_one_host_switch():
    """Built by nvcc like the other kernels, with no flags of its own
    (integer arithmetic only); the host build is the source's only switch;
    no sort in it."""
    with open(os.path.join(_kernels.CSRC, "kept.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int kept_launch_plan(' in src and "<<<" in src
    assert set(re.findall(r"#\s*if(?:n?def)?\s+(\w+)", src)) == {"KEPT_HOST"}
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>"]
    assert "kept" in _kernels.KERNELS and "kept" not in _kernels.KERNEL_FLAGS
    assert "float" not in src and "double" not in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "sort" not in code
