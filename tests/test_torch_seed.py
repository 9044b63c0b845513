"""The seeding stage of the port's device step (ops/seed.py).

On the CPU, three versions of the stage's word-table path must be equal bit
for bit on all seven outputs (slot, p, n_cand, counts, overflow, word,
word_valid): the CUDA kernel's own source (csrc/seed.cu), built for the
host with g++ behind tests/cuda_host_shim/cuda_runtime.h (-DSEED_HOST: the
words launch a cluster at a time, phase by phase over its blocks, the keys
launch block by block, a block's threads phase by phase);
`seed_reference`, the plain PyTorch version; and the JAX step, the payload
unpack of tntblast_tpu/parallel/device_search.py::panel_step_core (copied
below, jnp for jnp) followed by `_seed_fragment` under `jax.vmap`.

Cases: word lengths 3/7/8; 8/40/64 slots with hits in slots 31, 32 and 63;
max_words 1/18/31 with word index 30; lanes s_max x k_max from 1 to 8
(words shared across slots, words repeated in an oligo) and slot and k
residues; N runs that overlap, touch the ends, lie past frag_len or come
unsorted; exceptions with pads at L among them; frag_len 0, below w, below
L and L; an all-N fragment; hits at negative diagonals; runs, exceptions
and hits across the kernel's SPAN-position blocks (SEED_SPAN, read from
the source) and tiles one word past a block; more any-match positions
than cap and more keys than cap; a batch of eight; the keys launch's
tiles: the truncation's cut inside a tile and on its edge, keys on the
diagonals around the tile edges, tiles without an in-position, outputs
and scratch of garbage before the call, both grids played in reverse
(the tiles come from the ticket counter); the tables the plan derives
(aux_tables) against a brute-force build.  Also: the exceptions' order
does not matter (the kernel
relies only on each position coming once, which DevicePanel._pack_host
guarantees); the kernel's tables equal a brute-force build from a panel's
w_table; the plan refuses shapes the kernel does not take; a whole device
step through the host-built kernel equals the JAX step; the source's one
host switch; the synthetic calls chip_smoke.py and the card tests make
(tools/bench_inputs.py::seed_inputs) through the host build.  The panels
and payloads come from tools/bench_inputs.py (seed_panel, seed_payload),
the lanes from ops/seed.py::seed_lanes, the rule DevicePanel uses.  The
kernel's launch on the card is held by chip_smoke.py (phase 3d) and
tests/test_torch_cuda.py.
"""

import ctypes
import functools
import os
import pathlib
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tntblast_tpu.parallel import device_search as J
from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.ops import seed as S
from tntblast_tpu_torch.parallel import device_search as T
from tntblast_tpu_torch.tools.bench_inputs import (
    seed_inputs, seed_panel, seed_payload, seed_w_table,
    seed_words_at)

HERE = pathlib.Path(__file__).resolve().parent
NAMES = ("slot", "p", "n_cand", "counts", "overflow", "word", "word_valid")
SPAN = _kernels.define("seed", "SEED_SPAN")     # positions a block
CLUSTER = _kernels.define("seed", "SEED_CLUSTER")   # blocks a cluster


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/seed.cu built by g++ with -DSEED_HOST."""
    lib = tmp_path_factory.mktemp("seed_host") / "libseed.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-DSEED_HOST",
         f"-I{HERE / 'cuda_host_shim'}", "-shared", "-fPIC",
         os.path.join(_kernels.CSRC, "seed.cu"), "-o", str(lib)],
        check=True)
    return S.bind(ctypes.CDLL(str(lib)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the three versions -----------------------------------------------------

def run_host(lib, payload, w_table, *, word_len, num_os, max_words, cap,
             s_max, k_max, fill=None):
    """The host-built kernel through its plan, on numpy inputs; `fill`, a
    byte, is written over the outputs and the scratch before the call."""
    L = payload[0].shape[1] * 4
    ks, vf = S.seed_tables(w_table, num_os=num_os, max_words=max_words,
                           s_max=s_max, k_max=k_max)
    kst, vft = _t(ks.view(np.int64)), _t(vf)
    plan, per = S.make_plan(lib, kst, vft, L=L, word_len=word_len,
                            num_os=num_os, max_words=max_words, cap=cap,
                            index=0)
    n = payload[0].shape[0]
    out = S.empty_outputs(n, cap, num_os, L - word_len + 1, "cpu")
    scratch = torch.empty(n * per, dtype=torch.int32)
    if fill is not None:
        for t in (*out, scratch):
            t.view(torch.uint8).fill_(fill)
    args = tuple(_t(a) for a in payload)
    rc = lib.seed_launch_plan(*S.launch_args(plan, args, out, scratch), None)
    assert rc == 0
    return out


def run_reference(payload, w_table, **kw):
    L = payload[0].shape[1] * 4
    return S.seed_reference(*(_t(a) for a in payload), _t(w_table),
                            tile_len=L, **kw)


@functools.lru_cache(maxsize=None)
def _jax_step(n, L, word_len, num_os, max_words, cap, s_max, k_max):
    """The JAX payload unpack (panel_step_core, device_search.py:434-457,
    jnp for jnp) and _seed_fragment under its fragment vmap, jitted."""
    seed = functools.partial(
        J._seed_fragment, word_len=word_len, num_os=num_os,
        max_words=max_words, tile_len=L, cap=cap, s_max=s_max, k_max=k_max)

    def step(frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c, ow,
             w_table):
        shifts = jnp.arange(4, dtype=jnp.uint8) * 2
        frags = ((frags_packed[:, :, None] >> shifts[None, None, :]) & 3
                 ).reshape(n, L).astype(jnp.uint8)
        pos = jnp.arange(L, dtype=jnp.int32)[None, :]
        frags = jnp.where(pos >= frag_lens[:, None],
                          jnp.uint8(C.DB_UNKNOWN), frags)
        delta = jnp.zeros((n, L + 1), jnp.int32)
        ones = jnp.ones(nrun_s.shape, jnp.int32)
        delta = delta.at[jnp.arange(n)[:, None],
                         jnp.clip(nrun_s, 0, L)].add(ones)
        delta = delta.at[jnp.arange(n)[:, None],
                         jnp.clip(nrun_e, 0, L)].add(-ones)
        in_n = jnp.cumsum(delta[:, :L], axis=1) > 0
        frags = jnp.where(in_n, jnp.uint8(C.DB_N), frags)
        frags = jnp.concatenate(
            [frags, jnp.zeros((n, 1), jnp.uint8)], axis=1)
        frags = frags.at[jnp.arange(n)[:, None],
                         jnp.clip(exc_p, 0, L)].set(exc_c)
        frags = frags[:, :L]
        return jax.vmap(seed, in_axes=(0, 0, None, None))(
            frags, frag_lens, ow, w_table)

    return jax.jit(step)


def run_jax(payload, ow, w_table, *, word_len, num_os, max_words, cap,
            s_max, k_max):
    n, L = payload[0].shape[0], payload[0].shape[1] * 4
    fn = _jax_step(n, L, word_len, num_os, max_words, cap, s_max, k_max)
    got = fn(*(jnp.asarray(a) for a in payload), jnp.asarray(ow),
             jnp.asarray(w_table))
    return tuple(torch.from_numpy(np.array(x)) for x in got)


def _assert_equal(got, want, who):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (who, name)
        bad = (g != w).reshape(len(g), -1).any(dim=1).nonzero()
        assert len(bad) == 0, (
            f"{who}: {name} differs in fragments {bad.flatten().tolist()}")


def check_three(lib, payload, ow, w_table, **kw):
    """Host-built kernel == seed_reference == JAX on all seven outputs;
    returns the reference's outputs."""
    want = run_reference(payload, w_table, **kw)
    _assert_equal(run_host(lib, payload, w_table, **kw), want, "kernel")
    _assert_equal(run_jax(payload, ow, w_table, **kw), want, "jax")
    return want


def _codes(rng, n, L):
    return rng.integers(0, 4, (n, L)).astype(np.uint8)


# ---- panels: word length, slots, word count, lanes --------------------------

PANELS = [
    # (word_len, num_os, max_words, share, repeat, negative, empty, cap)
    pytest.param(7, 40, 18, 0, 0, 4, 2, 2048, id="bench-w7-40slots-18words"),
    pytest.param(3, 8, 1, 0, 0, 0, 0, 4096, id="w3-8slots-1word"),
    pytest.param(8, 64, 31, 0, 0, 4, 0, 2048, id="w8-64slots-31words"),
    pytest.param(7, 8, 18, 6, 0, 2, 1, 2048, id="shared-words"),
    pytest.param(7, 8, 18, 0, 8, 2, 1, 2048, id="repeated-words"),
    pytest.param(7, 64, 31, 10, 10, 3, 0, 4096, id="shared-and-repeated"),
    pytest.param(3, 40, 18, 0, 0, 2, 0, 8192, id="w3-dense-hits"),
    pytest.param(8, 8, 1, 2, 0, 0, 3, 512, id="w8-1word"),
]


@pytest.mark.parametrize(
    "word_len,num_os,max_words,share,repeat,negative,empty,cap", PANELS)
def test_kernel_reference_and_jax_agree(host_kernel, word_len, num_os,
                                        max_words, share, repeat, negative,
                                        empty, cap):
    rng = np.random.default_rng(
        [word_len, num_os, max_words, share, repeat, cap])
    L = 6144
    codes = _codes(rng, 3, L)
    ow, wt = seed_panel(rng, codes, word_len=word_len, num_os=num_os,
                    max_words=max_words, share=share, repeat=repeat,
                    negative=negative, empty=empty)
    s_max, k_max = S.seed_lanes(wt)
    payload = seed_payload(codes, [L, L - 1000, 3000],
                       runs={1: [(100, 140)]},
                       excs={2: [(50, 9), (2047, 15)]})
    kw = dict(word_len=word_len, num_os=num_os, max_words=max_words,
              cap=cap, s_max=s_max, k_max=k_max)
    want = check_three(host_kernel, payload, ow, wt, **kw)
    assert int(want[2].sum()) > 0
    if share:
        assert s_max > 1
    if repeat:
        assert k_max > 1


def test_high_slots_and_word_index_30(host_kernel):
    """Hits in slots 31 (bit 31 of the low lane), 32 and 63, from word
    index 30 of a 31-word oligo: the keys come out as slots 31, 32, 63 and
    diagonals 30 before the word's position."""
    rng = np.random.default_rng(31)
    L, w, num_os, mw = 4096, 8, 64, 31
    codes = _codes(rng, 2, L)
    ow = np.full((num_os, mw), -1, np.int32)
    site = {31: 700, 32: 1900, 63: 3000}
    for s, x in site.items():
        ow[s] = seed_words_at(codes[1], x, w, mw)
    wt = seed_w_table(ow, w)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=w, num_os=num_os, max_words=mw, cap=1024,
              s_max=s_max, k_max=k_max)
    want = check_three(host_kernel, seed_payload(codes, [L, L]), ow, wt,
                       **kw)
    m = int(want[2][1])
    keys = set(zip(want[0][1][:m].tolist(), want[1][1][:m].tolist()))
    assert {(s, x) for s, x in site.items()} <= keys
    # word index 30 alone (the others cleared) still seeds the diagonal
    only30 = np.where(wt == (1 << 30), wt, 0).astype(np.int32)
    ow30 = np.where(np.arange(mw)[None, :] == 30, ow, -1).astype(np.int32)
    s_max, k_max = S.seed_lanes(only30)
    want = check_three(host_kernel, seed_payload(codes, [L, L]), ow30,
                       only30, **dict(kw, s_max=s_max, k_max=k_max))
    m = int(want[2][1])
    keys = set(zip(want[0][1][:m].tolist(), want[1][1][:m].tolist()))
    assert {(s, x) for s, x in site.items()} <= keys


@pytest.mark.parametrize("s_max,k_max", [(1, 1), (2, 1), (1, 2), (2, 2),
                                         (4, 2), (2, 4), (8, 1), (1, 8)])
def test_lanes_from_one_to_eight(host_kernel, s_max, k_max):
    """Panels whose widest word is held by s_max slots, s_max x k_max from
    1 to 8, with a word repeated k_max times in one oligo."""
    rng = np.random.default_rng(100 * s_max + k_max)
    L, w, num_os, mw = 4096, 7, 16, 18
    codes = _codes(rng, 2, L)
    ow, _ = seed_panel(rng, codes, word_len=w, num_os=num_os, max_words=mw,
                       negative=1)
    v = ow[0, 3]                       # a word of the fragments
    for s in range(1, s_max):          # held by s_max slots
        ow[s, 5] = v
    for k in range(1, k_max):          # k_max times in slot 0's oligo
        ow[0, 3 + 2 * k] = v
    wt = seed_w_table(ow, w)
    got = S.seed_lanes(wt)
    assert got[0] >= s_max and got[1] >= k_max
    kw = dict(word_len=w, num_os=num_os, max_words=mw, cap=4096,
              s_max=got[0], k_max=got[1])
    payload = seed_payload(codes, [L, 4000])
    want = check_three(host_kernel, payload, ow, wt, **kw)
    assert not want[4].any()
    # fewer lanes than the table needs: slot or k residue, the fragment
    # overflows, and its keys still agree
    if got != (1, 1):
        kw.update(s_max=max(1, got[0] - 1) if got[0] > 1 else 1,
                  k_max=max(1, got[1] - 1) if got[1] > 1 else 1)
        want = check_three(host_kernel, payload, ow, wt, **kw)
        assert want[4].any()


# ---- the payload: N runs, exceptions, lengths -------------------------------

@pytest.fixture(scope="module")
def small_panel():
    """A fragment set and an 8-slot, 18-word panel of word length 7 that
    seeds in it, hits at negative diagonals among them."""
    rng = np.random.default_rng(5)
    L = 3 * SPAN
    codes = _codes(rng, 4, L)
    # seeds at the blocks' ends: oligos taken there
    ow, wt = seed_panel(rng, codes, word_len=7, num_os=8, max_words=18,
                        negative=2, empty=1)
    for s, x in ((5, SPAN - 9), (6, 2 * SPAN - 1)):
        ow[s] = -1
        ow[s, :18] = seed_words_at(codes[s % 4], x, 7, 18)
    wt = seed_w_table(ow, 7)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=7, num_os=8, max_words=18, cap=2048, s_max=s_max,
              k_max=k_max)
    return codes, ow, wt, kw


RUN_CASES = {
    "overlapping": [(100, 300), (200, 400), (390, 395)],
    "touching-both-ends": [(0, 10), (3 * SPAN - 10, 3 * SPAN)],
    "past-frag-len": [(5000, 5100), (5900, 7000)],
    "unsorted": [(4000, 4010), (50, 60), (2040, 2056), (1000, 1001)],
    "across-block-ends": [(SPAN - 1, SPAN + 1), (2 * SPAN - 3, 2 * SPAN),
                          (2 * SPAN, 2 * SPAN + 1)],
    "empty-and-inverted": [(700, 700), (900, 800)],
    "clamped": [(-5, 3), (6100, 9999)],
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_n_runs(host_kernel, small_panel, case):
    codes, ow, wt, kw = small_panel
    runs = {0: RUN_CASES[case], 2: RUN_CASES[case][::-1]}
    payload = seed_payload(codes, [3 * SPAN, 5800, 3 * SPAN, 4000], runs=runs)
    want = check_three(host_kernel, payload, ow, wt, **kw)
    assert int(want[2].sum()) > 0


EXC_CASES = {
    # codes: degenerate 4..14, N 15, unknown 17, and ACGT codes placed
    # past frag_len
    "scattered": [(0, 9), (17, 4), (SPAN - 1, 14), (SPAN, 16),
                  (3 * SPAN - 1, 5)],
    "pads-among-them": [(3 * SPAN, 9), (10, 15), (3 * SPAN, 4), (2049, 7),
                        (3 * SPAN + 7, 9)],
    "past-frag-len": [(5900, 1), (5950, 2), (6000, 0)],
    "at-block-ends": [(SPAN - 7, 11), (SPAN - 6, 12), (2 * SPAN + 6, 9)],
    "negative-clamps-to-0": [(-3, 12), (5, 9)],
}


@pytest.mark.parametrize("case", sorted(EXC_CASES))
def test_exceptions(host_kernel, small_panel, case):
    codes, ow, wt, kw = small_panel
    excs = {1: EXC_CASES[case], 3: EXC_CASES[case][::-1]}
    payload = seed_payload(codes, [3 * SPAN, 5800, 3 * SPAN, 4000],
                           excs=excs, runs={1: [(300, 320)]})
    check_three(host_kernel, payload, ow, wt, **kw)


def test_runs_and_exceptions_across_cluster_edges(host_kernel):
    """A fragment longer than a cluster of the words launch (CLUSTER blocks
    share one read of the run and exception lists): runs wholly inside the
    first cluster, across its end, from before it to the tile's end and
    overlapping; exceptions on both sides of the edge and in a block's
    halo.  A later cluster takes the run ends before it as its count at its
    start."""
    X = CLUSTER * SPAN
    L = X + 2 * SPAN
    rng = np.random.default_rng(53)
    codes = _codes(rng, 2, L)
    ow, wt = seed_panel(rng, codes, word_len=7, num_os=8, max_words=18,
                        negative=2)
    for s, x in ((6, X - 9), (7, X + 40)):
        ow[s] = -1
        ow[s, :18] = seed_words_at(codes[s % 2], x, 7, 18)
    wt = seed_w_table(ow, 7)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=7, num_os=8, max_words=18, cap=4096, s_max=s_max,
              k_max=k_max)
    runs = [(100, 200), (X - 50, X + 50), (X - 3000, L), (5000, X + 7),
            (X + 60, X + 60), (X + 500, X + 400)]
    excs = [(X - 1, 9), (X, 15), (X + 3, 17), (X - 5, 4), (SPAN - 2, 14),
            (X + SPAN - 1, 5)]
    payload = seed_payload(codes, [L, L - 100], runs={0: runs, 1: runs[3:]},
                           excs={0: excs[::-1], 1: excs})
    want = check_three(host_kernel, payload, ow, wt, **kw)
    assert int(want[2].sum()) > 0


def test_exception_order_does_not_matter(host_kernel, small_panel):
    """The kernel relies on each exception position coming once, not on
    their order: the rows permuted (pads among them), the outputs equal."""
    codes, ow, wt, kw = small_panel
    rng = np.random.default_rng(8)
    pos = rng.choice(3 * SPAN, 12, replace=False)
    el = [(int(x), int(rng.integers(4, 18))) for x in pos]
    payload = seed_payload(codes, [3 * SPAN] * 4, excs={0: el, 2: el})
    want = check_three(host_kernel, payload, ow, wt, **kw)
    shuffled = list(payload)
    perm = rng.permutation(16)
    shuffled[4] = payload[4][:, perm]
    shuffled[5] = payload[5][:, perm]
    _assert_equal(run_host(host_kernel, tuple(shuffled), wt, **kw), want,
                  "kernel, exceptions permuted")


def test_pack_host_writes_each_exception_once():
    """DevicePanel._pack_host: each exception position once, ascending,
    pads at L after them; N positions as maximal runs."""
    panel = T.DevicePanel.__new__(T.DevicePanel)
    panel.config = T.PanelConfig(word_len=7, num_os=8, max_words=4,
                                 wq_max=20, tile_len=4096, cap=512,
                                 num_cond=1)
    rng = np.random.default_rng(12)
    frag = rng.integers(0, 4, 4000).astype(np.uint8)
    frag[rng.choice(4000, 300, replace=False)] = rng.integers(4, 15, 300)
    frag[1000:1050] = C.DB_N
    frag[1050] = 5
    packed, lens, rs, re_, ep, ec, over = panel._pack_host([frag])
    real = ep[0][ep[0] < 4096]
    assert len(real) == len(set(real.tolist())) > 250
    assert (np.diff(real) > 0).all() and (ep[0][len(real):] == 4096).all()
    assert rs[0, 0] <= 1000 < 1050 <= re_[0, 0] and not over[0]


@pytest.mark.parametrize("flens", [(0, 3 * SPAN, 6, 7), (1, 5, 3 * SPAN - 1,
                                                         SPAN),
                                   (SPAN + 1, SPAN - 1, 2 * SPAN, 100)])
def test_fragment_lengths(host_kernel, small_panel, flens):
    """frag_len 0, below the word length (5, 6), at it (7), just around
    the blocks' ends and at L."""
    codes, ow, wt, kw = small_panel
    want = check_three(host_kernel, seed_payload(codes, flens), ow, wt, **kw)
    for f, fl in enumerate(flens):
        if fl < 7:
            assert not want[6][f].any() and int(want[2][f]) == 0


def test_all_n_fragment(host_kernel, small_panel):
    """One N run over the whole tile (one over a fragment's length only,
    one past a fragment's end): every word is DB_N's low bits, nothing is
    valid or seeded; DB_N overrides DB_UNKNOWN past the fragment."""
    codes, ow, wt, kw = small_panel
    L = codes.shape[1]
    payload = seed_payload(codes, [L, 4000, 5000, L],
                       runs={0: [(0, L)], 1: [(0, 4000)], 2: [(0, L)]})
    want = check_three(host_kernel, payload, ow, wt, **kw)
    n15 = 0
    for _ in range(7):
        n15 = (n15 << 2) | (C.DB_N & 3)
    for f in (0, 2):
        assert (want[5][f] == n15).all() and not want[6][f].any()
        assert int(want[2][f]) == 0
    assert int(want[2][1]) == 0


@pytest.mark.parametrize("L", [SPAN + 4, 2 * SPAN - 4, 2 * SPAN, 2 * SPAN + 8,
                               3 * SPAN + 12])
def test_tiles_around_block_ends(host_kernel, L):
    """Tiles a little past and short of the kernel's blocks: the last
    block holds a few positions, or a few words, or only the diagonals
    before the first position (max_words - 1 past nw_pos)."""
    rng = np.random.default_rng(L)
    codes = _codes(rng, 2, L)
    ow, wt = seed_panel(rng, codes, word_len=7, num_os=8, max_words=18,
                        negative=2)
    for s, x in ((0, L - 7 - 17), (1, L - 7)):      # seeds at the end
        ow[s] = -1
        ow[s, :min(18, L - 6 - x)] = seed_words_at(codes[s], x, 7,
                                                   min(18, L - 6 - x))
    wt = seed_w_table(ow, 7)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=7, num_os=8, max_words=18, cap=1024, s_max=s_max,
              k_max=k_max)
    want = check_three(host_kernel, seed_payload(codes, [L, L - 3]), ow, wt,
                       **kw)
    m = int(want[2][0])
    keys = set(zip(want[0][0][:m].tolist(), want[1][0][:m].tolist()))
    assert (0, L - 24) in keys and not want[4][0]


# ---- truncation: more any-match positions or keys than cap ------------------

@pytest.mark.parametrize("cap", [1, 37, SPAN - 1, SPAN, SPAN + 1])
def test_any_match_overflow(host_kernel, cap):
    """Word length 3 over 40 slots: nearly every position is an any-match
    position, so the first cap positions give the lanes; the cut falls
    inside a block, on its end or one past, and the overflowing
    fragments' slots, p and counts still agree."""
    rng = np.random.default_rng(cap)
    L = 3 * SPAN
    codes = _codes(rng, 2, L)
    ow, wt = seed_panel(rng, codes, word_len=3, num_os=40, max_words=6)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=3, num_os=40, max_words=6, cap=cap,
              s_max=s_max, k_max=k_max)
    payload = seed_payload(codes, [L, 100])
    want = check_three(host_kernel, payload, ow, wt, **kw)
    assert bool(want[4][0]) and int(want[2][0]) > cap


def test_truncation_flags_when_the_keys_fit(host_kernel):
    """More in-positions than cap, but fewer keys than cap: one oligo's
    site copied five times into a fragment puts its 18 in-positions on one
    diagonal each time, so the truncation alone must flag the fragment."""
    rng = np.random.default_rng(59)
    L, w, mw = SPAN + SPAN // 2, 7, 18
    codes = _codes(rng, 1, L)
    site = codes[0, 100:100 + mw + w - 1].copy()
    for x in (900, 1800, 2700, SPAN + 200):
        codes[0, x:x + len(site)] = site
    ow = np.full((8, mw), -1, np.int32)
    ow[0] = seed_words_at(codes[0], 100, w, mw)
    wt = seed_w_table(ow, w)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=w, num_os=8, max_words=mw, s_max=s_max, k_max=k_max)
    full = run_reference(seed_payload(codes, [L]), wt, cap=L, **kw)
    word, valid = full[5][0].numpy(), full[6][0].numpy()
    n_in = int(((wt[word] != 0).any(axis=1) & valid).sum())
    cap = n_in - 3
    assert int(full[2][0]) <= cap < n_in
    want = check_three(host_kernel, seed_payload(codes, [L]), ow, wt,
                       cap=cap, **kw)
    assert bool(want[4][0]) and int(want[2][0]) <= cap


def test_more_keys_than_cap(host_kernel):
    """Fewer any-match positions than cap, but more keys (eight lanes a
    position: each word in 4 slots at 2 indices): n_cand > cap flags the
    fragment, the first cap keys are kept and counts cover all keys."""
    rng = np.random.default_rng(77)
    L, w, num_os, mw = 2 * SPAN, 8, 16, 10
    codes = _codes(rng, 1, L)
    words = seed_words_at(codes[0], 0, w, L - w + 1)
    ow = np.full((num_os, mw), -1, np.int32)
    for i, q in enumerate(rng.choice(L - w + 1, 8, replace=False)):
        for s in range(4 * (i % 4), 4 * (i % 4) + 4):
            ow[s, 2 * (i // 4):2 * (i // 4) + 2] = words[q]
    wt = seed_w_table(ow, w)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=w, num_os=num_os, max_words=mw, s_max=s_max,
              k_max=k_max)
    full = run_reference(seed_payload(codes, [L]), wt, cap=4096, **kw)
    word, valid = full[5][0].numpy(), full[6][0].numpy()
    n_any = int(((wt[word] != 0).any(axis=1) & valid).sum())
    n_keys = int(full[2][0])
    assert n_keys > 4 * n_any
    cap = (n_any + n_keys) // 2
    want = check_three(host_kernel, seed_payload(codes, [L]), ow, wt, cap=cap,
                       **kw)
    assert int(want[2][0]) == n_keys > cap >= n_any
    assert bool(want[4][0]) and int(want[3][0].sum()) == n_keys


def test_batch_of_eight(host_kernel):
    """Eight fragments of mixed lengths, runs and exceptions in one call,
    the bench panel's widths (w 7, 40 slots, 18 words)."""
    rng = np.random.default_rng(88)
    L = 2 * SPAN + 1024
    codes = _codes(rng, 8, L)
    ow, wt = seed_panel(rng, codes, word_len=7, num_os=40, max_words=18,
                        negative=3, empty=4)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=7, num_os=40, max_words=18, cap=512, s_max=s_max,
              k_max=k_max)
    flens = [L, 0, 3000, L - 1, 6, 2048, 4097, L]
    runs = {i: [(int(a), int(a) + int(b))
                for a, b in zip(rng.integers(0, L, 3), rng.integers(1, 80, 3))]
            for i in range(0, 8, 2)}
    excs = {i: [(int(x), int(rng.integers(4, 18)))
                for x in rng.choice(L, 10, replace=False)]
            for i in range(1, 8, 2)}
    want = check_three(host_kernel, seed_payload(codes, flens, runs, excs), ow,
                       wt, **kw)
    assert int((want[2] > 0).sum()) >= 5


@pytest.mark.parametrize("shape", [
    dict(n=8, L=8192, word_len=7, num_os=40, max_words=18, cap=2048),
    dict(n=2, L=8192, word_len=3, num_os=8, max_words=1, cap=512),
    dict(n=4, L=4100, word_len=8, num_os=64, max_words=31, cap=4096,
         share=10, repeat=10),
    dict(n=1, L=8, word_len=4, num_os=8, max_words=2, cap=16)],
    ids=["bench-widths", "w3-overflow", "w8-64slots", "tile-of-8"])
def test_seed_inputs_through_the_host_build(host_kernel, shape):
    """The synthetic calls of chip_smoke.py and the card tests: the
    payload's 256 run and 2048 exception rows (pads among the exceptions),
    lanes from seed_lanes; host-built kernel == seed_reference."""
    args, kw = seed_inputs(np.random.default_rng(len(str(shape))), "cpu",
                           **shape)
    payload = tuple(a.numpy() for a in args[:6])
    kw.pop("tile_len")
    want = run_reference(payload, args[6].numpy(), **kw)
    _assert_equal(run_host(host_kernel, payload, args[6].numpy(), **kw),
                  want, "kernel")


# ---- the tiles of the keys launch: truncation, edges, scratch, order -------

def _dense_panel(L, seed):
    """Word length 3 over 40 slots in one fragment of L: nearly every
    position is an in-position, so the first cap of them give the keys."""
    rng = np.random.default_rng(seed)
    codes = _codes(rng, 1, L)
    ow, wt = seed_panel(rng, codes, word_len=3, num_os=40, max_words=6)
    s_max, k_max = S.seed_lanes(wt)
    kw = dict(word_len=3, num_os=40, max_words=6, s_max=s_max, k_max=k_max)
    return codes, ow, wt, kw


@pytest.mark.parametrize("cut", ["mid-tile", "tile-edge", "edge-plus-one"])
def test_truncation_inside_and_at_tile_edges(host_kernel, cut):
    """A fragment of four tiles whose in-position of rank cap lies in the
    middle of the third tile, on its first position (the second tile's
    last position is the last one kept) or one past it: every tile before
    the cut keeps all its keys, the tile of the cut some, those after it
    none, and the offsets of the look-back carry over the cut."""
    L = 4 * SPAN
    codes, ow, wt, kw = _dense_panel(L, 41)
    payload = seed_payload(codes, [L])
    full = run_reference(payload, wt, cap=L, **kw)
    held = (wt[full[5][0].numpy()] != 0).any(axis=1) & full[6][0].numpy()
    rank = np.cumsum(held)          # in-positions up to and at each q
    at = {"mid-tile": 2 * SPAN + SPAN // 2, "tile-edge": 2 * SPAN,
          "edge-plus-one": 2 * SPAN + 1}[cut]
    cap = int(rank[at - 1])         # the in-positions before `at`
    want = check_three(host_kernel, payload, ow, wt, cap=cap, **kw)
    assert bool(want[4][0]) and held[at:].any()


def test_keys_across_tile_edges(host_kernel):
    """Oligos whose hits land on the diagonals around the keys launch's
    tile edges (diagonal j * SPAN - MW + 1 starts tile j) and on the last
    diagonals before them: their in-positions lie in the next tile's halo
    or its first words, and every key comes out once, in order."""
    rng = np.random.default_rng(43)
    L, w, num_os, mw = 3 * SPAN, 7, 16, 18
    codes = _codes(rng, 1, L)
    ow = np.full((num_os, mw), -1, np.int32)
    sites = [j * SPAN - mw + 1 + d for j in (1, 2) for d in (-2, -1, 0, 1)]
    sites += [SPAN - 1, 2 * SPAN - 1, SPAN - 32, SPAN + 31]
    for s, x in enumerate(sites):
        ow[s] = seed_words_at(codes[0], x, w, mw)
    wt = seed_w_table(ow, w)
    s_max, k_max = S.seed_lanes(wt)
    want = check_three(host_kernel, seed_payload(codes, [L]), ow, wt,
                       word_len=w, num_os=num_os, max_words=mw, cap=4096,
                       s_max=s_max, k_max=k_max)
    m = int(want[2][0])
    keys = set(zip(want[0][0][:m].tolist(), want[1][0][:m].tolist()))
    assert {(s, x) for s, x in enumerate(sites)} <= keys


def test_tiles_without_in_positions(host_kernel, small_panel):
    """Whole tiles with no in-position (an N run over them, or past the
    fragment's end) between tiles with keys: their aggregates are 0 and
    the look-back carries the offsets across them."""
    codes, ow, wt, kw = small_panel
    L = codes.shape[1]
    big = np.concatenate([codes, codes[:, ::-1]], axis=1)[:, :L]
    payload = seed_payload(big, [L, L, SPAN // 2, L],
                           runs={1: [(10, SPAN + 100)], 3: [(0, L)]})
    want = check_three(host_kernel, payload, ow, wt, **kw)
    assert int(want[2][0]) > 0 and int(want[2][1]) > 0
    assert int(want[2][3]) == 0


@pytest.mark.parametrize("fill", [0xFF, 0x5A])
def test_scratch_of_garbage_is_reset(host_kernel, small_panel, fill):
    """Outputs and scratch set to a byte pattern before the call (0xFF
    makes every status word look inclusive and the tile counter huge):
    launch 1 resets what launch 2 reads, and every output is written."""
    codes, ow, wt, kw = small_panel
    L = codes.shape[1]
    payload = seed_payload(codes, [L, 5800, L, 4000],
                           runs={0: [(100, 140)]}, excs={2: [(50, 9)]})
    want = run_reference(payload, wt, **kw)
    _assert_equal(run_host(host_kernel, payload, wt, fill=fill, **kw), want,
                  f"kernel on scratch of {fill:#x}")


def test_host_grid_in_reverse(host_kernel, small_panel):
    """Both grids played from their last block to their first: launch 1's
    blocks are independent but for the cluster's phases, and launch 2
    takes its tiles from the ticket counter, not from the block index, so
    the outputs are the same."""
    codes, ow, wt, kw = small_panel
    L = codes.shape[1]
    payload = seed_payload(codes, [L, 5800, L, 4000],
                           runs={1: [(300, 320)]}, excs={3: [(77, 15)]})
    want = run_reference(payload, wt, **kw)
    host_kernel.seed_host_reverse(1)
    try:
        got = run_host(host_kernel, payload, wt, **kw)
    finally:
        host_kernel.seed_host_reverse(0)
    _assert_equal(got, want, "kernel, grids in reverse")


def test_aux_tables_match_a_brute_force_build():
    """aux_tables: VF bit 0 a bit a word value, then a word a value with
    bit k set iff KS[v, k] holds a slot and bit 31 VF's bit 1."""
    rng = np.random.default_rng(47)
    for w, num_os, mw, s_max, k_max in ((4, 8, 5, 1, 1), (2, 64, 31, 2, 3),
                                        (1, 8, 2, 8, 2)):
        wt = np.zeros((4 ** w, num_os), np.int64)
        for _ in range(4 ** w):
            wt[rng.integers(0, 4 ** w), rng.integers(0, num_os)] |= (
                1 << int(rng.integers(0, mw)))
        wt = wt.astype(np.uint32).view(np.int32)
        ks, vf = S.seed_tables(wt, num_os=num_os, max_words=mw, s_max=s_max,
                               k_max=k_max)
        aux = S.aux_tables(_t(ks.view(np.int64)), _t(vf)).numpy()
        aux = aux.view(np.uint32).astype(np.int64)
        nh = -(-4 ** w // 32)
        for v in range(4 ** w):
            assert (aux[v // 32] >> (v % 32)) & 1 == vf[v] & 1
            want = sum(1 << k for k in range(mw) if ks[v, k] != 0)
            assert aux[nh + v] == want | (int(vf[v]) >> 1 & 1) << 31
        assert len(aux) == nh + 4 ** w


# ---- the tables, the plan, the step -----------------------------------------

def _brute_tables(w_table, num_os, max_words, s_max, k_max):
    V = w_table.shape[0]
    ks = np.zeros((V, max_words), np.uint64)
    vf = np.zeros(V, np.uint8)
    for v in range(V):
        occ = [s for s in range(num_os) if w_table[v, s] != 0]
        resid = len(occ) > s_max
        for s in occ[:s_max]:
            m = int(w_table[v, s]) & 0xFFFFFFFF
            bits = [k for k in range(32) if m >> k & 1]
            resid |= len(bits) > k_max
            for k in bits[:k_max]:
                ks[v, k] |= np.uint64(1) << np.uint64(s)
        vf[v] = (1 if occ else 0) | (2 if resid else 0)
    return ks, vf


def test_tables_match_a_brute_force_build():
    """seed_tables on a DevicePanel's own w_table (the table SeedPlan reads
    on a card) and on tables with shared and repeated words, slot 63 and
    word index 30, against a loop over every word and slot."""
    from tntblast_tpu_torch.search import seed as oligo_seed

    panel = []
    for oligo in ("TTGACCTAGATATTCAGCAAC", "GGGAGAGACTCACCCAAAGATC",
                  "TTGACCTAGATATTCAGCAAC"):
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        for minus in (True, False):
            panel.append({"words": oligo_seed.oligo_word_list(
                codes, 4, complement=not minus), "codes": codes,
                "minus": minus})
    cfg = T.PanelConfig(word_len=4, num_os=8, max_words=19, wq_max=22,
                        tile_len=4096, cap=512, num_cond=1)
    dp = T.DevicePanel(panel, cfg, np.zeros((1, 2401), np.int32),
                       np.full((1, 6), 100, np.int32), device="cpu")
    w_tab = dp.host_tables[1]
    assert w_tab.shape == (256, 8) and dp.s_max > 1
    cases = [(w_tab, 8, 19, dp.s_max, dp.k_max)]
    rng = np.random.default_rng(3)
    for num_os, mw, s_max, k_max in ((64, 31, 2, 3), (40, 18, 1, 1),
                                     (8, 5, 8, 1)):
        wt = np.zeros((4 ** 4, num_os), np.int64)
        for _ in range(600):
            wt[rng.integers(0, 256), rng.integers(0, num_os)] |= (
                1 << int(rng.integers(0, mw)))
        wt[7, 63 % num_os] |= 1 << (mw - 1)
        cases.append((wt.astype(np.uint32).view(np.int32), num_os, mw,
                      s_max, k_max))
    for wt, num_os, mw, s_max, k_max in cases:
        ks, vf = S.seed_tables(wt, num_os=num_os, max_words=mw, s_max=s_max,
                               k_max=k_max)
        bks, bvf = _brute_tables(wt, num_os, mw, s_max, k_max)
        np.testing.assert_array_equal(ks, bks)
        np.testing.assert_array_equal(vf, bvf)
    assert (vf & 2).any() and (vf & 1).any()


@pytest.mark.parametrize("field,value", [
    ("word_len", 0), ("word_len", 9), ("L", 4094), ("L", 4), ("num_os", 0),
    ("num_os", 65), ("max_words", 0), ("max_words", 32), ("cap", 0)])
def test_plan_refuses_what_the_kernel_does_not_take(host_kernel, field,
                                                    value):
    """seed_plan returns cudaErrorInvalidValue (1) for a shape the kernel
    does not take; the launch refuses n < 1 and negative sideband
    counts."""
    lib = host_kernel
    shapes = dict(L=4096, word_len=7, num_os=8, max_words=18, cap=512)
    ks = torch.zeros((4 ** 7, 18), dtype=torch.int64)
    vf = torch.zeros(4 ** 7, dtype=torch.uint8)
    plan, _ = S.make_plan(lib, ks, vf, **shapes, index=0)
    bad = dict(shapes, **{field: value})
    if field == "L" and value == 4:
        bad["word_len"] = 8                  # L below the word length
    with pytest.raises(ValueError):
        S.make_plan(lib, ks, vf, **bad, index=0)
    payload = tuple(_t(a) for a in seed_payload(
        np.zeros((1, 4096), np.uint8), [4096]))
    out = S.empty_outputs(1, 512, 8, 4090, "cpu")
    scratch = torch.empty(lib.seed_scratch_words(plan, 1), dtype=torch.int32)
    args = list(S.launch_args(plan, payload, out, scratch))
    for i, v in ((-3, 0), (-2, -1), (-1, -1)):
        wrong = list(args)
        wrong[i] = v
        assert lib.seed_launch_plan(*wrong, None) == 1
    assert lib.seed_launch_plan(*args, None) == 0


def test_tables_and_plan_refuse_what_the_kernel_does_not_take():
    """seed_tables refuses a k-bitmask bit at or above max_words, a table
    of the wrong type or width, more than 64 slots; SeedPlan serves a card
    only; the checked call on CPU tensors is the plain version and launches
    nothing."""
    wt = np.zeros((4 ** 3, 8), np.int32)
    wt[5, 2] = 1 << 6
    with pytest.raises(ValueError):
        S.seed_tables(wt, num_os=8, max_words=6, s_max=1, k_max=1)
    S.seed_tables(wt, num_os=8, max_words=7, s_max=1, k_max=1)
    with pytest.raises(ValueError):
        S.seed_tables(wt.astype(np.int64), num_os=8, max_words=7, s_max=1,
                      k_max=1)
    with pytest.raises(ValueError):
        S.seed_tables(wt, num_os=9, max_words=7, s_max=1, k_max=1)
    with pytest.raises(ValueError):
        S.seed_tables(np.zeros((64, 65), np.int32), num_os=65, max_words=7,
                      s_max=1, k_max=1)
    with pytest.raises(ValueError):
        S.seed_tables(wt, num_os=8, max_words=7, s_max=0, k_max=1)
    ks, vf = S.seed_tables(wt, num_os=8, max_words=7, s_max=1, k_max=1)
    with pytest.raises(ValueError):
        S.SeedPlan(_t(ks.view(np.int64)), _t(vf), L=4096, word_len=3,
                   num_os=8, max_words=7, cap=64)
    rng = np.random.default_rng(2)
    codes = _codes(rng, 2, 1024)
    ow, wt = seed_panel(rng, codes, word_len=3, num_os=8, max_words=7)
    payload = tuple(_t(a) for a in seed_payload(codes, [1024, 900]))
    before = S.seed.launches
    got = S.seed(*payload, _t(wt), word_len=3, num_os=8, max_words=7,
                 tile_len=1024, cap=300, s_max=8, k_max=7)
    want = run_reference(tuple(a.numpy() for a in payload), wt, word_len=3,
                         num_os=8, max_words=7, cap=300, s_max=8, k_max=7)
    _assert_equal(got, want, "seed on the CPU")
    assert S.seed.launches == before


def _step_panel():
    """A JAX panel with word-table seeding and the evaluator, and the
    port's panel of its tables on the CPU."""
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
                        np.full((1, 4), 100000, np.int32),
                        eval_dg=eng.delta_g().astype(np.int32).ravel(),
                        thermo_tables=build_tables())
    pdp = T.DevicePanel.from_tables(
        jdp.config, jdp.slot_meta, jdp.eval_const, jdp.s_max, jdp.k_max,
        J._PANEL_TABLES[jdp._tab_digest], "cpu", eval_on=jdp.eval_on)
    return jdp, pdp


def test_step_through_the_host_built_kernel_equals_the_jax_step(
        host_kernel, monkeypatch):
    """The device step with a seed plan in its tables (here the host-built
    kernel behind the plan's call) seeds through it alone, never through
    the tensor code, and its header, kept block, slot, p and valid equal
    the JAX step's."""
    jdp, pdp = _step_panel()
    cfg = pdp.config
    w_tab = pdp.host_tables[1]
    ks, vf = S.seed_tables(w_tab, num_os=cfg.num_os,
                           max_words=cfg.max_words, s_max=pdp.s_max,
                           k_max=pdp.k_max)
    plan, per = S.make_plan(host_kernel, _t(ks.view(np.int64)), _t(vf),
                            L=cfg.tile_len, word_len=cfg.word_len,
                            num_os=cfg.num_os, max_words=cfg.max_words,
                            cap=cfg.cap, index=0)
    calls = []

    def host_plan(*payload):
        n = payload[0].shape[0]
        out = S.empty_outputs(n, cfg.cap, cfg.num_os,
                              cfg.tile_len - cfg.word_len + 1, "cpu")
        scratch = torch.empty(n * per, dtype=torch.int32)
        assert host_kernel.seed_launch_plan(
            *S.launch_args(plan, payload, out, scratch), None) == 0
        calls.append(n)
        return out

    def refuse(*a, **k):
        raise AssertionError("the step seeded through tensor code")

    monkeypatch.setattr(T, "seed_fragments", refuse)
    monkeypatch.setattr(T, "unpack_fragments", refuse)
    pdp.tabs["seed_plan"] = host_plan
    rng = np.random.default_rng(21)
    frags = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (8000, 5000, 7000)]
    frags[0][1000:1021] = C.ASCII_TO_DB[np.frombuffer(
        b"TTGACCTAGATATTCAGCAAC", np.uint8)]
    frags[1][2000:2300] = C.DB_N
    frags[2][3000] = 9
    payload = jdp._pack_host(frags)
    want = [np.asarray(x) for x in jdp._step(3, True)(
        *(jnp.asarray(a) for a in payload), *jdp.args)]
    got = [x.numpy() for x in pdp.step(payload, full=True)]
    assert calls == [3]
    np.testing.assert_array_equal(got[0], want[0], err_msg="header")
    m = min(int(want[0][0]), cfg.batch_kcap(3))
    assert m > 0
    np.testing.assert_array_equal(got[1][:, :m], want[1][:, :m],
                                  err_msg="kept_block")
    for name, g, w in zip(("slot", "p", "keep", "needs_host", "valid"),
                          got[2:], want[2:]):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_cpu_panel_has_no_seed_plan():
    """A CPU panel seeds through tensor code: no plan in its tables."""
    assert "seed_plan" not in _step_panel()[1].tabs


def test_source_has_a_plain_c_entry_and_one_host_switch():
    """Built by nvcc like the other kernels, with no flags of its own
    (integer arithmetic only); the host build is the source's only #if; no
    sort anywhere in it."""
    with open(os.path.join(_kernels.CSRC, "seed.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int seed_launch_plan(' in src and "<<<" in src
    assert re.findall(r"#\s*if(?:n?def)?\s+(\w+)", src) == ["SEED_HOST"]
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>"]
    assert "seed" in _kernels.KERNELS and "seed" not in _kernels.KERNEL_FLAGS
    assert "float" not in src and "double" not in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "sort" not in code
