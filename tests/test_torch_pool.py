"""The pooling stage of the port's device step (ops/pool.py).

On the CPU, three versions of the stage must be equal bit for bit on all
five outputs (slot_str, p_str, frag_str, order_str, valid): the CUDA
kernel's own source (csrc/pool.cu), built for the host with g++ behind
tests/cuda_host_shim/cuda_runtime.h (-DPOOL_HOST: every launch block by
block, a block's threads phase by phase); `pool_reference`, the plain
PyTorch version (a stable torch.sort); and the JAX step's pool,
`jnp.argsort(key, stable=True)` and its gathers, copied below jnp for jnp
from tntblast_tpu/parallel/device_search.py::panel_step_core.

Cases: 1, 8, 40 and 64 slots; cap 1, 7, 31, around one and two of the
kernel's tiles of POOL_TILE (1024) ranks, and the bench step's 45056 over 8
fragments; an empty fragment, a fragment with more candidates than cap (an
overflowing fragment: n_cand > cap), every entry invalid; one slot for
every entry (a group's 32 lanes hold one key) and slots spread; tiles
without a valid rank (the lean path) beside tiles with valid ranks; a
count table large enough that a thread sums its run in two passes;
garbage in slot past n_cand (the kernel must not read it), scratch and
outputs of garbage; scratch off 16 bytes, refused; the seed stage's real
outputs on synthetic payloads (tools/bench_inputs.seed_inputs through
seed_reference, one of them overflowing).  Also: the wrapper on CPU
tensors is the plain version and launches nothing, the plan refuses what
the kernel does not take and CPU tensors, the source's one host switch.  The kernel's launch on the card is
held by chip_smoke.py and tests/test_torch_cuda.py.
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

from tntblast_tpu_torch import _kernels
from tntblast_tpu_torch.ops import pool as P
from tntblast_tpu_torch.ops.seed import seed_reference
from tntblast_tpu_torch.tools.bench_inputs import (
    pool_inputs as _inputs, seed_inputs)

HERE = pathlib.Path(__file__).resolve().parent
NAMES = ("slot_str", "p_str", "frag_str", "order_str", "valid")
TILE = (_kernels.define("pool", "POOL_THREADS")
        * _kernels.define("pool", "POOL_ITEMS"))     # ranks a block


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/pool.cu built by g++ with -DPOOL_HOST."""
    lib = tmp_path_factory.mktemp("pool_host") / "libpool.so"
    subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-O2", "-DPOOL_HOST",
         f"-I{HERE / 'cuda_host_shim'}", "-shared", "-fPIC",
         os.path.join(_kernels.CSRC, "pool.cu"), "-o", str(lib)],
        check=True)
    return P.bind(ctypes.CDLL(str(lib)))


def run_host(lib, slot, p, n_cand, num_os, fill=None):
    """The host-built kernel through its plan's C entries on numpy inputs;
    `fill`, a byte, is written over the outputs and the scratch first."""
    n, cap = slot.shape
    plan = P.make_plan(lib, num_os=num_os, cap=cap, index=0)
    out = P.empty_outputs(n, cap, "cpu")
    scratch = torch.empty(lib.pool_scratch_words(plan, n), dtype=torch.int32)
    if fill is not None:
        for t in (*out, scratch):
            t.view(torch.uint8).fill_(fill)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (slot, p, n_cand)]
    rc = lib.pool_launch_plan(*P.launch_args(plan, *args, out, scratch),
                              None)
    assert rc == 0
    return out


def run_reference(slot, p, n_cand, num_os):
    return P.pool_reference(torch.from_numpy(slot), torch.from_numpy(p),
                            torch.from_numpy(n_cand), num_os=num_os)


def run_jax(slot, p, n_cand, num_os):
    """The JAX step's pool (device_search.py:468-492), jnp for jnp."""
    n, cap = slot.shape
    Bp = n * cap
    slot_f = jnp.asarray(slot).reshape(Bp)
    p_f = jnp.asarray(p).reshape(Bp)
    rank = jnp.arange(Bp, dtype=jnp.int32) % cap
    frag_f = jnp.arange(Bp, dtype=jnp.int32) // cap
    n_comp = jnp.minimum(jnp.asarray(n_cand), cap)
    valid = rank < n_comp[frag_f]
    key = jnp.where(valid, slot_f, num_os)
    order = jnp.argsort(key, stable=True)
    return [np.asarray(x) for x in (key[order], p_f[order], frag_f[order],
                                    order.astype(jnp.int32),
                                    valid.reshape(n, cap))]


def _check(lib, slot, p, n_cand, num_os, fill=None):
    got = [t.numpy() for t in run_host(lib, slot, p, n_cand, num_os, fill)]
    ref = [t.numpy() for t in run_reference(slot, p, n_cand, num_os)]
    jx = run_jax(slot, p, n_cand, num_os)
    for name, g, r, j in zip(NAMES, got, ref, jx):
        np.testing.assert_array_equal(g, r, err_msg=f"kernel vs plain: "
                                                    f"{name}")
        np.testing.assert_array_equal(r, j, err_msg=f"plain vs JAX: {name}")
    return ref


@pytest.mark.parametrize("num_os", [1, 8, 40, 64])
@pytest.mark.parametrize("cap", [1, 7, 31, 1023, 1024, 1025, 2047, 2048,
                                 2049, 5000])
def test_kernel_reference_and_jax_agree(host_kernel, num_os, cap):
    rng = np.random.default_rng(cap * 100 + num_os)
    n_cand = [cap, cap // 2, 0, cap + 3]     # full, half, empty, overflow
    _check(host_kernel, *_inputs(rng, 4, cap, num_os, n_cand), num_os)


def test_bench_shapes(host_kernel):
    """8 fragments of cap 45056 (Bp 360448), as the bench step pools them,
    about 12000 candidates each over 40 slots, one fragment overflowing."""
    rng = np.random.default_rng(7)
    n_cand = rng.integers(9000, 15000, 8)
    n_cand[3] = 45056 + 17
    ref = _check(host_kernel, *_inputs(rng, 8, 45056, 40, n_cand,
                                       garbage=False), 40)
    assert int(ref[4].sum()) == int(np.minimum(n_cand, 45056).sum())


@pytest.mark.parametrize("cap", [33, TILE, 3 * TILE + 5])
def test_one_slot_for_every_entry(host_kernel, cap):
    """Every lane of a group holds one key: ranks 0-31 in a group, one
    place a group."""
    rng = np.random.default_rng(cap)
    _check(host_kernel, *_inputs(rng, 3, cap, 16, [cap, cap - 1, cap // 3],
                                 one_slot=True), 16)


@pytest.mark.parametrize("cap", [1, 100, TILE + 1])
def test_every_entry_invalid(host_kernel, cap):
    """No candidate anywhere: the whole stream is the invalid tail, in index
    order, keyed num_os."""
    rng = np.random.default_rng(cap + 5)
    ref = _check(host_kernel, *_inputs(rng, 3, cap, 8, [0, 0, 0]), 8)
    assert (ref[0] == 8).all() and (ref[3] == np.arange(3 * cap)).all()


def test_overflowing_and_empty_fragments(host_kernel):
    """n_cand past cap on one fragment (its cap entries all enter the pool),
    0 on the next: the tail's offsets count what each fragment leaves."""
    rng = np.random.default_rng(3)
    cap = TILE + 300
    for n_cand in ([cap + 1, 0, 5], [0, 10 * cap, 1], [0, 0, cap]):
        _check(host_kernel, *_inputs(rng, 3, cap, 40, n_cand), 40)


@pytest.mark.parametrize("n_cand", [
    (2 * TILE, 100, 0, 3 * TILE + 5),   # ends on a tile's edge, inside
                                        # one, at 0
    (5 * TILE, 5 * TILE + 9, 1, 0)])    # full and overflowing fragments
def test_tiles_without_a_valid_rank_beside_valid_ones(host_kernel, n_cand):
    """Tiles past a fragment's candidates take the lean path (closed-form
    places, no shared tables) beside tiles with valid ranks, in one
    fragment and across fragments."""
    rng = np.random.default_rng(sum(n_cand))
    _check(host_kernel, *_inputs(rng, 4, 5 * TILE, 40, n_cand), 40,
           fill=0xFF)


def test_counts_summed_in_passes(host_kernel):
    """64 slots over 8 fragments of the bench step's cap: the count table
    holds 11264 words, so each prefix thread sums its run of them in two
    passes; fragments full to cap put counts and the slots' points in
    both passes."""
    rng = np.random.default_rng(29)
    n_cand = rng.integers(9000, 45056 + 20, 8)
    n_cand[[1, 6]] = 45056
    n_cand[5] = 0
    _check(host_kernel, *_inputs(rng, 8, 45056, 64, n_cand, garbage=False),
           64)


def test_launch_refuses_misaligned_scratch(host_kernel):
    """The counts are read 16 bytes at a time: scratch off 16 bytes is
    refused."""
    plan = P.make_plan(host_kernel, num_os=8, cap=100, index=0)
    slot, p, n_cand = (torch.from_numpy(a) for a in _inputs(
        np.random.default_rng(1), 2, 100, 8, [100, 50]))
    out = P.empty_outputs(2, 100, "cpu")
    scratch = torch.empty(host_kernel.pool_scratch_words(plan, 2) + 4,
                          dtype=torch.int32)
    assert host_kernel.pool_launch_plan(*P.launch_args(
        plan, slot, p, n_cand, out, scratch[:-4]), None) == 0
    assert host_kernel.pool_launch_plan(*P.launch_args(
        plan, slot, p, n_cand, out, scratch[1:]), None) != 0


@pytest.mark.parametrize("fill", [0x00, 0xFF, 0x7F])
def test_outputs_and_scratch_of_garbage(host_kernel, fill):
    rng = np.random.default_rng(fill)
    _check(host_kernel, *_inputs(rng, 2, 3000, 24, [2999, 1700]), 24,
           fill=fill)


@pytest.mark.parametrize("shape", [
    (2, 8192, 3, 8, 1, 512, 0, 0),          # overflows
    (4, 16384, 7, 40, 18, 2048, 6, 8),
    (3, 4100, 4, 64, 31, 700, 10, 10)])
def test_seed_outputs_through_the_host_build(host_kernel, shape):
    """The seed stage's own outputs (seed_reference on synthetic payloads)
    pooled by all three versions."""
    n, L, w, num_os, mw, cap, share, repeat = shape
    args, kw = seed_inputs(np.random.default_rng(L + cap), "cpu", n=n, L=L,
                           word_len=w, num_os=num_os, max_words=mw, cap=cap,
                           share=share, repeat=repeat)
    slot, p, n_cand = (t.numpy() for t in seed_reference(*args, **kw)[:3])
    _check(host_kernel, slot, p, n_cand, num_os)


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(11)
    slot, p, n_cand = _inputs(rng, 3, 100, 8, [100, 0, 140])
    before = P.pool.launches
    got = P.pool(*(torch.from_numpy(a) for a in (slot, p, n_cand)),
                 num_os=8)
    want = run_reference(slot, p, n_cand, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert P.pool.launches == before


@pytest.mark.parametrize("num_os, cap", [(0, 10), (65, 10), (8, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(host_kernel, num_os,
                                                    cap):
    with pytest.raises(ValueError, match="refuses"):
        P.make_plan(host_kernel, num_os=num_os, cap=cap, index=0)


def test_plan_serves_a_card():
    with pytest.raises(ValueError, match="card"):
        P.PoolPlan("cpu", num_os=8, cap=16)


def test_source_has_a_plain_c_entry_and_one_host_switch():
    """Built by nvcc like the other kernels, with no flags of its own
    (integer arithmetic only); the host build is the source's only #if; no
    sort anywhere in it."""
    with open(os.path.join(_kernels.CSRC, "pool.cu")) as fh:
        src = fh.read()
    assert 'extern "C" int pool_launch_plan(' in src and "<<<" in src
    assert set(re.findall(r"#\s*if(?:n?def)?\s+(\w+)", src)) == {"POOL_HOST"}
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <stdint.h>"]
    assert "pool" in _kernels.KERNELS and "pool" not in _kernels.KERNEL_FLAGS
    assert "float" not in src and "double" not in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "sort" not in code
