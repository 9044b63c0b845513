"""The dense seeding path of the port's device step (ops/seed.py).

On the CPU, three versions of the dense path must be equal bit for bit on
all seven outputs (slot, p, n_cand, counts, overflow, word, word_valid):
the CUDA kernel's own source (csrc/seed_dense.cu), built for the host with
g++ behind tests/cuda_host_shim/cuda_runtime.h (-DSEED_DENSE_HOST: each
of its four launches block by block, a block's threads phase by phase); `seed_dense_reference`, the plain PyTorch version; and
the JAX step, the payload unpack of
tntblast_tpu/parallel/device_search.py::panel_step_core (copied below, jnp
for jnp) followed by `_seed_fragment` with a (1, num_os) dummy table under
`jax.vmap`.  Equality is exact.

Cases: max_words 32, 54, 113, 300 and 1018; 8, 40 and 64 slots with hits in slots
31, 32 and 63; -1 pads (short oligos beside long ones, empty slots); words
repeated inside an oligo and words shared across many slots; N runs and
exceptions; frag_len 0, below the word length and L; negative diagonals;
hits on the diagonals around the kernel's tile edges; more non-empty
diagonals than cap, more pairs inside the first cap diagonals than cap,
and more pairs than cap with no more diagonals than cap; a batch of eight;
outputs and scratch of garbage before the call; a block's threads, and
the tile and emit launches' blocks, played in reverse (no block waits on
another).  Also: the panel tables against a brute-force build, the plan
refusing shapes the kernel does not take, a whole device step through the
host-built kernel against the JAX step on a dense panel of 45- to 60-nt
oligos, and the source's one host switch.  The kernel's launch on the card
is held by chip_smoke.py (phase 3h) and tests/test_torch_cuda.py.
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
    seed_dense_inputs, seed_oligo_words, seed_payload, seed_words_at)

HERE = pathlib.Path(__file__).resolve().parent
NAMES = ("slot", "p", "n_cand", "counts", "overflow", "word", "word_valid")
SPAN = _kernels.define("seed_dense", "DENSE_SPAN")     # diagonals a tile


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/seed_dense.cu built by g++ with -DSEED_DENSE_HOST."""
    lib = tmp_path_factory.mktemp("seed_dense_host") / "libseed_dense.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-DSEED_DENSE_HOST",
         f"-I{HERE / 'cuda_host_shim'}", "-shared", "-fPIC",
         os.path.join(_kernels.CSRC, "seed_dense.cu"), "-o", str(lib)],
        check=True)
    return S.bind_dense(ctypes.CDLL(str(lib)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the three versions -----------------------------------------------------

def host_plan(lib, ow, *, L, word_len, num_os, max_words, cap):
    """(plan, scratch words a fragment) of the host-built kernel."""
    hash_, entries, filt, bits = S.dense_tables(ow, num_os=num_os,
                                                max_words=max_words)
    return S.make_dense_plan(lib, (_t(hash_), _t(entries), _t(filt), bits),
                             L=L, word_len=word_len, num_os=num_os,
                             max_words=max_words, cap=cap, index=0)


def run_host(lib, payload, ow, *, word_len, num_os, max_words, cap,
             fill=None):
    """The host-built kernel through its plan, on numpy inputs; `fill`, a
    byte, is written over the outputs and the scratch before the call."""
    L = payload[0].shape[1] * 4
    plan, per = host_plan(lib, ow, L=L, word_len=word_len, num_os=num_os,
                          max_words=max_words, cap=cap)
    n = payload[0].shape[0]
    out = S.empty_outputs(n, cap, num_os, L - word_len + 1, "cpu")
    scratch = torch.empty(n * per, dtype=torch.int32)
    if fill is not None:
        for t in (*out, scratch):
            t.view(torch.uint8).fill_(fill)
    args = tuple(_t(a) for a in payload)
    rc = lib.seed_dense_launch_plan(*S.launch_args(plan, args, out, scratch),
                                    None)
    assert rc == 0
    return out


def run_reference(payload, ow, **kw):
    L = payload[0].shape[1] * 4
    return S.seed_dense_reference(*(_t(a) for a in payload), _t(ow),
                                  tile_len=L, **kw)


@functools.lru_cache(maxsize=None)
def _jax_step(n, L, word_len, num_os, max_words, cap):
    """The JAX payload unpack (panel_step_core, device_search.py:434-457,
    jnp for jnp) and _seed_fragment's dense path under its fragment vmap,
    jitted."""
    seed = functools.partial(
        J._seed_fragment, word_len=word_len, num_os=num_os,
        max_words=max_words, tile_len=L, cap=cap)

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


def run_jax(payload, ow, *, word_len, num_os, max_words, cap):
    n, L = payload[0].shape[0], payload[0].shape[1] * 4
    fn = _jax_step(n, L, word_len, num_os, max_words, cap)
    got = fn(*(jnp.asarray(a) for a in payload), jnp.asarray(ow),
             jnp.zeros((1, num_os), jnp.int32))
    return tuple(torch.from_numpy(np.array(x)) for x in got)


def _assert_equal(got, want, who):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (who, name)
        bad = (g != w).reshape(len(g), -1).any(dim=1).nonzero()
        assert len(bad) == 0, (
            f"{who}: {name} differs in fragments {bad.flatten().tolist()}")


def check_three(lib, payload, ow, **kw):
    """Host-built kernel == seed_dense_reference == JAX on all seven
    outputs; returns the reference's outputs."""
    want = run_reference(payload, ow, **kw)
    _assert_equal(run_host(lib, payload, ow, **kw), want, "kernel")
    _assert_equal(run_jax(payload, ow, **kw), want, "jax")
    return want


def _codes(rng, n, L):
    return rng.integers(0, 4, (n, L)).astype(np.uint8)


def _keys(out, f):
    m = min(int(out[2][f]), out[0].shape[1])
    return set(zip(out[0][f][:m].tolist(), out[1][f][:m].tolist()))


# ---- panels: words an oligo, slots, pads, shared and repeated words --------

PANELS = [
    # (num_os, max_words, share, repeat, cap)
    pytest.param(8, 32, 0, 0, 4096, id="8slots-32words"),
    pytest.param(40, 54, 6, 6, 4096, id="40slots-54words-shared-repeated"),
    pytest.param(64, 54, 0, 0, 4096, id="64slots-54words"),
    pytest.param(64, 113, 20, 20, 8192, id="64slots-113words-shared"),
    # oligos of 306 nt at w 7
    pytest.param(64, 300, 20, 20, 8192, id="64slots-300words-shared"),
]


@pytest.mark.parametrize("num_os,max_words,share,repeat,cap", PANELS)
def test_kernel_reference_and_jax_agree(host_kernel, num_os, max_words,
                                        share, repeat, cap):
    """Panels of 32 to 300 words an oligo (every third slot full, the rest
    shorter: -1 pads), two oligos with hits at negative diagonals, an
    empty slot; three fragments of lengths L, L - 1000 and 3000 with an N
    run and two exceptions."""
    rng = np.random.default_rng([num_os, max_words, share, repeat])
    L = 6144
    codes = _codes(rng, 3, L)
    ow = seed_oligo_words(rng, codes, word_len=7, num_os=num_os,
                          max_words=max_words, share=share, repeat=repeat,
                          negative=2, empty=1)
    payload = seed_payload(codes, [L, L - 1000, 3000],
                           runs={1: [(100, 140)]},
                           excs={2: [(50, 9), (2047, 15)]})
    want = check_three(host_kernel, payload, ow, word_len=7, num_os=num_os,
                       max_words=max_words, cap=cap)
    assert int(want[2].sum()) > 0 and not want[4].any()
    assert (ow == -1).any()


@pytest.mark.parametrize("num_os", [12, 64])
def test_kernel_and_reference_agree_on_wide_tiles(host_kernel, num_os):
    """Oligos of 1024 nt at w 7 (1018 words): past DENSE_WIDE_WORDS words
    the tiles hold DENSE_SPAN_WIDE diagonals.  The host-built kernel
    against the plain version (held against JAX above; the JAX dense path
    takes some 30 s to compile at this width), on four tiles a fragment
    with N runs and exceptions on either side of a tile edge."""
    wide = _kernels.define("seed_dense", "DENSE_SPAN_WIDE")
    assert S.DENSE_MAX_WORDS >= 1018 > _kernels.define(
        "seed_dense", "DENSE_WIDE_WORDS")
    rng = np.random.default_rng([num_os, 1018])
    L = 3 * wide
    codes = _codes(rng, 3, L)
    ow = seed_oligo_words(rng, codes, word_len=7, num_os=num_os,
                          max_words=1018, share=4, repeat=4, negative=2,
                          empty=1)
    payload = seed_payload(codes, [L, L - 1500, 5000],
                           runs={1: [(wide - 20, wide + 30)]},
                           excs={2: [(wide - 1, 9), (wide, 15)]})
    kw = dict(word_len=7, num_os=num_os, max_words=1018, cap=65536)
    want = run_reference(payload, ow, **kw)
    _assert_equal(run_host(host_kernel, payload, ow, **kw), want, "kernel")
    assert int(want[2].sum()) > 0 and not want[4].any()
    plan, _ = host_plan(host_kernel, ow, L=L, word_len=7, num_os=num_os,
                        max_words=1018, cap=65536)
    tiling = (ctypes.c_int * 3)()
    host_kernel.seed_dense_plan_tiling(plan, tiling)
    assert list(tiling)[:2] == [wide, -(-(L - 7 + 1 + 1017) // wide)]


def test_high_slots_and_last_word_index(host_kernel):
    """Hits in slots 31 (bit 31 of the low half), 32 and 63 of a 64-slot
    panel, through the last word index of 54-word oligos: the pairs come
    out as slots 31, 32, 63 at their sites' diagonals; word index 53 alone
    seeds them too, 53 diagonals before the word's position."""
    rng = np.random.default_rng(31)
    L, w, num_os, mw = 6144, 7, 64, 54
    codes = _codes(rng, 2, L)
    ow = np.full((num_os, mw), -1, np.int32)
    site = {31: 700, 32: 1900, 63: 3000}
    for s, x in site.items():
        ow[s] = seed_words_at(codes[1], x, w, mw)
    kw = dict(word_len=w, num_os=num_os, max_words=mw, cap=4096)
    payload = seed_payload(codes, [L, L])
    want = check_three(host_kernel, payload, ow, **kw)
    assert set(site.items()) <= _keys(want, 1)
    last = np.where(np.arange(mw)[None, :] == mw - 1, ow, -1).astype(np.int32)
    want = check_three(host_kernel, payload, last, **kw)
    assert set(site.items()) <= _keys(want, 1)


def test_one_word_held_by_every_slot(host_kernel):
    """One word in all 64 slots at every index of their oligos, beside
    their own words: a diagonal holds up to 64 slots, and the lanes that
    limit the table path do not exist here (the -W 3 case)."""
    rng = np.random.default_rng(17)
    L, w, num_os, mw = 4096, 7, 64, 40
    codes = _codes(rng, 2, L)
    ow = seed_oligo_words(rng, codes, word_len=w, num_os=num_os,
                          max_words=mw)
    v = seed_words_at(codes[0], 1000, w, 1)[0]
    ow[:, ::5] = v
    want = check_three(host_kernel, seed_payload(codes, [L, L - 7]), ow,
                       word_len=w, num_os=num_os, max_words=mw, cap=16384)
    assert int(want[3][0].min()) > 0


def test_word_length_3(host_kernel):
    """Word length 3 over 40 slots (the pcr_small -W 3 shapes): nearly
    every position matches, so every fragment overflows; its outputs
    agree all the same."""
    rng = np.random.default_rng(3)
    L = 2 * SPAN
    codes = _codes(rng, 2, L)
    ow = seed_oligo_words(rng, codes, word_len=3, num_os=40, max_words=32)
    want = check_three(host_kernel, seed_payload(codes, [L, 100]), ow,
                       word_len=3, num_os=40, max_words=32, cap=2000)
    assert bool(want[4][0])


# ---- the payload: N runs, exceptions, lengths -------------------------------

@pytest.fixture(scope="module")
def small_panel():
    """Four fragments of three tiles and a 16-slot panel of 40 words (word
    length 7) that seeds in them: hits at negative diagonals, oligos taken
    across the tiles' edges."""
    rng = np.random.default_rng(5)
    L = 3 * SPAN
    codes = _codes(rng, 4, L)
    ow = seed_oligo_words(rng, codes, word_len=7, num_os=16, max_words=40,
                          negative=2, empty=1)
    for s, x in ((5, SPAN - 9), (6, 2 * SPAN - 41), (7, SPAN - 39)):
        ow[s] = seed_words_at(codes[s % 4], x, 7, 40)
    return codes, ow, dict(word_len=7, num_os=16, max_words=40, cap=4096)


RUN_CASES = {
    "overlapping": [(100, 300), (200, 400), (390, 395)],
    "touching-both-ends": [(0, 10), (3 * SPAN - 10, 3 * SPAN)],
    "across-tile-ends": [(SPAN - 1, SPAN + 1), (2 * SPAN - 3, 2 * SPAN),
                         (2 * SPAN - 50, 2 * SPAN - 45)],
    "unsorted-and-clamped": [(4000, 4010), (-5, 3), (50, 60), (6100, 9999),
                             (700, 700), (900, 800)],
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_n_runs(host_kernel, small_panel, case):
    codes, ow, kw = small_panel
    runs = {0: RUN_CASES[case], 2: RUN_CASES[case][::-1]}
    payload = seed_payload(codes, [3 * SPAN, 5800, 3 * SPAN, 4000], runs=runs)
    want = check_three(host_kernel, payload, ow, **kw)
    assert int(want[2].sum()) > 0


EXC_CASES = {
    "scattered": [(0, 9), (17, 4), (SPAN - 1, 14), (SPAN, 16),
                  (3 * SPAN - 1, 5)],
    "pads-among-them": [(3 * SPAN, 9), (10, 15), (3 * SPAN, 4), (2049, 7)],
    "past-frag-len-and-negative": [(5900, 1), (5950, 2), (-3, 12), (6000, 0)],
    "in-a-tile's-halo": [(SPAN - 7, 11), (SPAN - 30, 12), (2 * SPAN - 20, 9)],
    "every-byte-code": [(100, 255), (SPAN + 5, 200), (2 * SPAN, 3)],
}


@pytest.mark.parametrize("case", sorted(EXC_CASES))
def test_exceptions(host_kernel, small_panel, case):
    codes, ow, kw = small_panel
    excs = {1: EXC_CASES[case], 3: EXC_CASES[case][::-1]}
    payload = seed_payload(codes, [3 * SPAN, 5800, 3 * SPAN, 4000],
                           excs=excs, runs={1: [(300, 320)]})
    check_three(host_kernel, payload, ow, **kw)


@pytest.mark.parametrize("flens", [(0, 3 * SPAN, 6, 7), (1, 5, 3 * SPAN - 1,
                                                         SPAN + 1)])
def test_fragment_lengths(host_kernel, small_panel, flens):
    """frag_len 0, below the word length (1, 5, 6), at it (7), around a
    tile's end and at L."""
    codes, ow, kw = small_panel
    want = check_three(host_kernel, seed_payload(codes, flens), ow, **kw)
    for f, fl in enumerate(flens):
        if fl < 7:
            assert not want[6][f].any() and int(want[2][f]) == 0


def test_all_n_fragment(host_kernel, small_panel):
    """An N run over the whole tile: every word is DB_N's low bits, nothing
    is valid or seeded."""
    codes, ow, kw = small_panel
    L = codes.shape[1]
    payload = seed_payload(codes, [L, 4000, 5000, L],
                           runs={0: [(0, L)], 2: [(0, L)]})
    want = check_three(host_kernel, payload, ow, **kw)
    for f in (0, 2):
        assert not want[6][f].any() and int(want[2][f]) == 0


@pytest.mark.parametrize("L", [SPAN + 4, 2 * SPAN - 36, 2 * SPAN + 8])
def test_tiles_around_their_edges(host_kernel, L):
    """Tiles a little past and short of the kernel's tiles, and hits on
    the diagonals around a tile's edge (diagonal j * SPAN - MW + 1 starts
    tile j) and at the fragment's last words: every pair comes out once,
    in order."""
    rng = np.random.default_rng(L)
    w, num_os, mw = 7, 16, 40
    codes = _codes(rng, 2, L)
    ow = np.full((num_os, mw), -1, np.int32)
    sites = [SPAN - mw + 1 + d for d in (-2, -1, 0, 1)]
    sites += [L - w - mw + 1, L - w - 3]
    for s, x in enumerate(sites):
        nw = min(mw, L - w + 1 - x)
        ow[s, :nw] = seed_words_at(codes[0], x, w, nw)
    want = check_three(host_kernel, seed_payload(codes, [L, L - 3]), ow,
                       word_len=w, num_os=num_os, max_words=mw, cap=4096)
    assert {(s, x) for s, x in enumerate(sites)} <= _keys(want, 0)


# ---- the two-stage truncation -----------------------------------------------

def _busy_panel(seed, L=4 * SPAN):
    """Word length 4 over 40 slots of 32 words in one fragment of L: most
    diagonals hold a pair, many hold several."""
    rng = np.random.default_rng(seed)
    codes = _codes(rng, 1, L)
    ow = seed_oligo_words(rng, codes, word_len=4, num_os=40, max_words=32)
    kw = dict(word_len=4, num_os=40, max_words=32)
    return codes, ow, kw


def _busy_diagonals(out, ow):
    """Which diagonals of fragment 0 hold a pair, by index p + max_words -
    1, from the reference's words and their validity (brute force)."""
    word, valid = out[5][0].numpy(), out[6][0].numpy()
    mw = ow.shape[1]
    busy = np.zeros(len(word) + mw - 1, bool)
    for k in range(mw):
        held = ow[:, k][ow[:, k] >= 0]
        busy[mw - 1 - k:mw - 1 - k + len(word)] |= valid & np.isin(word, held)
    return busy


@pytest.mark.parametrize("cut", ["mid-tile", "tile-edge", "edge-plus-one"])
def test_more_diagonals_than_cap(host_kernel, cut):
    """n_pos > cap: the last taken diagonal lies inside the third tile, on
    the second tile's last diagonal, or on the third tile's first; the
    first cap diagonals' pairs come out, n_cand counts only theirs, counts
    every diagonal, and the fragment overflows."""
    codes, ow, kw = _busy_panel(41)
    L = codes.shape[1]
    payload = seed_payload(codes, [L])
    busy = _busy_diagonals(run_reference(payload, ow, cap=1, **kw), ow)
    at = {"mid-tile": 2 * SPAN + SPAN // 2, "tile-edge": 2 * SPAN,
          "edge-plus-one": 2 * SPAN + 1}[cut]
    cap = int(busy[:at].sum())
    assert busy[at - 1] and busy[at]
    want = check_three(host_kernel, payload, ow, cap=cap, **kw)
    assert bool(want[4][0]) and int(busy.sum()) > cap
    assert int((want[3][0]).sum()) > int(want[2][0]) > cap


def test_more_pairs_than_cap_inside_the_first_diagonals(host_kernel):
    """n_cand > cap with n_pos > cap: the first cap diagonals hold more
    than cap pairs; slot/p hold the first cap of them."""
    codes, ow, kw = _busy_panel(43, L=2 * SPAN)
    want = check_three(host_kernel, seed_payload(codes, [2 * SPAN]), ow,
                       cap=1500, **kw)
    assert int(want[2][0]) > 1500 and bool(want[4][0])


def test_more_pairs_than_cap_within_the_diagonals(host_kernel):
    """sum(counts) > cap with n_pos <= cap: every diagonal is taken, the
    pairs overflow slot/p, and the fragment overflows on the pairs
    alone."""
    codes, ow, kw = _busy_panel(47, L=2 * SPAN)
    payload = seed_payload(codes, [2 * SPAN])
    ref = run_reference(payload, ow, cap=1, **kw)
    n_pos = int(_busy_diagonals(ref, ow).sum())
    n_pairs = int(ref[3][0].sum())
    assert n_pos < n_pairs
    cap = (n_pos + n_pairs) // 2
    want = check_three(host_kernel, payload, ow, cap=cap, **kw)
    assert int(want[2][0]) == n_pairs > cap >= n_pos
    assert bool(want[4][0]) and int(want[3][0].sum()) == n_pairs


def test_batch_of_eight(host_kernel):
    """Eight fragments of mixed lengths, runs and exceptions in one call,
    the long-probe panel's widths (64 slots of 54 words), a cap that some
    fragments' diagonals exceed."""
    args, kw = seed_dense_inputs(np.random.default_rng(88), "cpu", n=8,
                                 L=2 * SPAN + 1024, num_os=64, max_words=54,
                                 cap=300, share=4, repeat=4)
    payload = tuple(a.numpy() for a in args[:6])
    kw.pop("tile_len")
    want = check_three(host_kernel, payload, args[6].numpy(), **kw)
    assert int((want[2] > 0).sum()) >= 5 and want[4].any()


@pytest.mark.parametrize("fill", [0xFF, 0x5A])
def test_scratch_of_garbage_is_reset(host_kernel, small_panel, fill):
    """Outputs and scratch set to a byte pattern before the call (0xFF
    makes every tile's counts and prefix huge and every slot count -1):
    the head launch resets the slot counts, every other word of scratch
    is written before it is read, and every output is written."""
    codes, ow, kw = small_panel
    L = codes.shape[1]
    payload = seed_payload(codes, [L, 5800, L, 4000],
                           runs={0: [(100, 140)]}, excs={2: [(50, 9)]})
    want = run_reference(payload, ow, **kw)
    _assert_equal(run_host(host_kernel, payload, ow, fill=fill, **kw), want,
                  f"kernel on scratch of {fill:#x}")
    _assert_equal(run_host(host_kernel, payload, ow, fill=fill,
                           **dict(kw, cap=50)),
                  run_reference(payload, ow, **dict(kw, cap=50)),
                  f"kernel on scratch of {fill:#x}, cap 50")


def test_host_threads_and_blocks_in_reverse(host_kernel, small_panel):
    """Every phase's threads, and the tile and emit launches' blocks,
    played from the last to the first: no phase depends on the order of
    its threads, and no block on the order of the blocks."""
    codes, ow, kw = small_panel
    L = codes.shape[1]
    payload = seed_payload(codes, [L, 5800, L, 4000],
                           runs={1: [(300, 320)]}, excs={3: [(77, 15)]})
    for cap in (4096, 60):
        want = run_reference(payload, ow, **dict(kw, cap=cap))
        host_kernel.seed_dense_host_reverse(1)
        try:
            got = run_host(host_kernel, payload, ow, **dict(kw, cap=cap))
        finally:
            host_kernel.seed_dense_host_reverse(0)
        _assert_equal(got, want, f"kernel in reverse, cap {cap}")


# ---- the tables, the plan, the step -----------------------------------------

def test_dense_tables_match_a_brute_force_build():
    """dense_tables: every (word value, k) some slot holds is one entry
    with the set of its slots, found by probing the hash from the word's
    hash; values no slot holds are not found; the filter holds every
    held value's bit."""
    rng = np.random.default_rng(29)
    for num_os, mw, w in ((64, 54, 7), (8, 113, 9), (40, 3, 2)):
        ow = rng.integers(0, 4 ** w, (num_os, mw)).astype(np.int32)
        ow[rng.random(ow.shape) < 0.3] = -1
        ow[0, :] = ow[num_os - 1, 0]                   # a shared word
        hash_, entries, filt, bits = S.dense_tables(ow, num_os=num_os,
                                                    max_words=mw)
        assert len(hash_) == 1 << bits
        held = {}
        for s, k in np.argwhere(ow >= 0):
            held.setdefault(int(ow[s, k]), {}).setdefault(int(k), 0)
            held[int(ow[s, k])][int(k)] |= 1 << int(s)
        assert (hash_[:, 0] >= 0).sum() * 4 <= len(hash_)
        for v in list(held) + [int(x) for x in rng.integers(0, 4 ** w, 50)]:
            h = int(S._hash(np.array([v]), bits)[0])
            while hash_[h, 0] not in (v, -1):
                h = (h + 1) % len(hash_)
            got = {}
            if hash_[h, 0] == v:
                for e in entries[hash_[h, 1]:hash_[h, 1] + hash_[h, 2]]:
                    got[int(e[0])] = ((int(e[1]) & 0xFFFFFFFF)
                                      | (int(e[2]) & 0xFFFFFFFF) << 32)
            assert got == held.get(v, {})
            if v in held:
                fb = int(S._hash(np.array([v]), S.DENSE_FILTER_BITS)[0])
                assert (int(filt[fb >> 5]) >> (fb & 31)) & 1


@pytest.mark.parametrize("field,value", [
    ("word_len", 0), ("word_len", 16), ("L", 4094), ("L", 4),
    ("L", (1 << 26) + 4), ("num_os", 0), ("num_os", 65), ("max_words", 0),
    # one past MAX_WORDS (1024, the words of a 1024-nt oligo); the case
    # keeps the name it had when the ceiling was 256
    pytest.param("max_words", S.DENSE_MAX_WORDS + 1, id="max_words-257"),
    ("cap", 0)])
def test_plan_refuses_what_the_kernel_does_not_take(host_kernel, field,
                                                    value):
    """seed_dense_plan returns cudaErrorInvalidValue (1) for a shape the
    kernel does not take; the launch refuses n < 1, negative sideband
    counts and misaligned scratch."""
    lib = host_kernel
    shapes = dict(L=4096, word_len=7, num_os=8, max_words=40, cap=512)
    ow = np.full((8, 40), -1, np.int32)
    ow[0, :3] = (5, 6, 7)
    plan, per = host_plan(lib, ow, **shapes)
    tables = S.dense_tables(ow, num_os=8, max_words=40)
    tables = (*(_t(a) for a in tables[:3]), tables[3])
    bad = dict(shapes, **{field: value})
    if field == "L" and value == 4:
        bad["word_len"] = 8                  # L below the word length
    with pytest.raises(ValueError):
        S.make_dense_plan(lib, tables, **bad, index=0)
    payload = tuple(_t(a) for a in seed_payload(
        np.zeros((1, 4096), np.uint8), [4096]))
    out = S.empty_outputs(1, 512, 8, 4090, "cpu")
    scratch = torch.empty(per + 4, dtype=torch.int32)
    args = list(S.launch_args(plan, payload, out, scratch))
    for i, v in ((-3, 0), (-2, -1), (-1, -1),
                 (14, scratch.data_ptr() + 4)):
        wrong = list(args)
        wrong[i] = v
        assert lib.seed_dense_launch_plan(*wrong, None) == 1
    assert lib.seed_dense_launch_plan(*args, None) == 0


def test_tables_and_plan_refuse_what_the_kernel_does_not_take():
    """dense_tables refuses ow of the wrong type or shape and more than 64
    slots; DenseSeedPlan serves a card only; the checked call on CPU
    tensors is the plain version and launches nothing."""
    ow = np.full((8, 40), -1, np.int32)
    with pytest.raises(ValueError):
        S.dense_tables(ow.astype(np.int64), num_os=8, max_words=40)
    with pytest.raises(ValueError):
        S.dense_tables(ow, num_os=8, max_words=41)
    with pytest.raises(ValueError):
        S.dense_tables(np.full((65, 4), -1, np.int32), num_os=65,
                       max_words=4)
    with pytest.raises(ValueError):
        S.DenseSeedPlan(_t(ow), L=4096, word_len=7, num_os=8, max_words=40,
                        cap=64)
    args, kw = seed_dense_inputs(np.random.default_rng(2), "cpu", n=2,
                                 L=1024, num_os=8, max_words=36, cap=300)
    before = S.seed_dense.launches
    got = S.seed_dense(*args, **kw)
    _assert_equal(got, S.seed_dense_reference(*args, **kw),
                  "seed_dense on the CPU")
    assert S.seed_dense.launches == before


def _step_panel():
    """A JAX panel of 45- to 60-nt oligos (dense seeding) with the
    evaluator, and the port's panel of its tables on the CPU."""
    from tntblast_tpu import native
    from tntblast_tpu.search import seed as jseed
    from tntblast_tpu.thermo.santa_lucia import build_tables

    eng = native.MeltEngine(n_threads=1)
    rng = np.random.default_rng(45)
    oligos = ["".join(rng.choice(list("ACGT"), n)) for n in (45, 60)]
    panel = []
    for oligo in oligos:
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        for minus in (True, False):
            panel.append({"words": jseed.oligo_word_list(
                codes, 7, complement=not minus), "codes": codes,
                "minus": minus})
    cfg = J.PanelConfig(word_len=7, num_os=8, max_words=54, wq_max=60,
                        tile_len=8192, cap=1024, num_cond=1)
    dg = eng.delta_g_screen(np.float32(313.15)).astype(np.int32)
    jdp = J.DevicePanel(panel, cfg, dg.reshape(1, -1),
                        np.full((1, 4), 100000, np.int32),
                        eval_dg=eng.delta_g().astype(np.int32).ravel(),
                        thermo_tables=build_tables())
    pdp = T.DevicePanel.from_tables(
        jdp.config, jdp.slot_meta, jdp.eval_const, jdp.s_max, jdp.k_max,
        J._PANEL_TABLES[jdp._tab_digest], "cpu", eval_on=jdp.eval_on)
    return jdp, pdp, oligos


def test_step_through_the_host_built_kernel_equals_the_jax_step(
        host_kernel, monkeypatch):
    """The device step of a dense panel with a DenseSeedPlan in its tables
    (here the host-built kernel behind the plan's call) seeds through it
    alone, never through tensor code, and its header, kept block, slot,
    p, keep, needs_host and valid equal the JAX step's."""
    jdp, pdp, oligos = _step_panel()
    cfg = pdp.config
    assert pdp.host_tables[1].shape == (1, cfg.num_os)
    plan, per = host_plan(host_kernel, pdp.host_tables[0], L=cfg.tile_len,
                          word_len=cfg.word_len, num_os=cfg.num_os,
                          max_words=cfg.max_words, cap=cfg.cap)
    calls = []

    def dense_plan(*payload):
        n = payload[0].shape[0]
        out = S.empty_outputs(n, cfg.cap, cfg.num_os,
                              cfg.tile_len - cfg.word_len + 1, "cpu")
        scratch = torch.empty(n * per, dtype=torch.int32)
        assert host_kernel.seed_dense_launch_plan(
            *S.launch_args(plan, payload, out, scratch), None) == 0
        calls.append(n)
        return out

    def refuse(*a, **k):
        raise AssertionError("the step seeded through tensor code")

    monkeypatch.setattr(T, "seed_fragments", refuse)
    monkeypatch.setattr(T, "unpack_fragments", refuse)
    pdp.tabs["seed_dense_plan"] = dense_plan
    rng = np.random.default_rng(21)
    frags = [rng.integers(0, 4, n).astype(np.uint8)
             for n in (8000, 5000, 7000)]
    for f, x, o in ((0, 1000, 0), (1, 300, 1), (2, 4000, 1)):
        frags[f][x:x + len(oligos[o])] = C.ASCII_TO_DB[np.frombuffer(
            oligos[o].encode(), np.uint8)]
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
    """A CPU panel on the dense path seeds through tensor code: neither
    plan in its tables."""
    tabs = _step_panel()[1].tabs
    assert "seed_dense_plan" not in tabs and "seed_plan" not in tabs


def test_source_has_a_plain_c_entry_and_one_host_switch():
    """Built by nvcc like the other kernels, with no flags of its own
    (integer arithmetic only); the host build is the source's only #if;
    no sort and no bitmap of every diagonal and slot."""
    with open(os.path.join(_kernels.CSRC, "seed_dense.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int seed_dense_launch_plan(' in src and "<<<" in src
    assert re.findall(r"#\s*if(?:n?def)?\s+(\w+)", src) == [
        "SEED_DENSE_HOST"]
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>"]
    assert "seed_dense" in _kernels.KERNELS
    assert "seed_dense" not in _kernels.KERNEL_FLAGS
    assert "float" not in src and "double" not in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "sort" not in code
