"""The port's probe DP (tntblast_tpu_torch.ops.screen_probe, plain PyTorch
version on CPU tensors) against the TPU probe kernel
tools/tpu_pallas_probe2.py::mk_kernel run in Pallas interpret mode: exact
equality for the three variants, with ql and wt_e varied per block.

mk_kernel is nested in a script that runs on import, so its FunctionDef is
taken from the parsed source and compiled in a namespace that holds what
the script's main() gives it."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tntblast_tpu.ops.pallas_screen import (
    _prefix_max, _prefix_sum, _shift_down)
from tntblast_tpu_torch.ops.screen_probe import (
    probe_energy_table, screen_probe, screen_probe_reference)
from tntblast_tpu_torch.tools.screen_probe import probe_inputs

PROBE_SRC = (pathlib.Path(__file__).resolve().parent.parent
             / "tools" / "tpu_pallas_probe2.py")


def _mk_kernel(BB, wq_max, wt_max, nc_all):
    tree = ast.parse(PROBE_SRC.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "mk_kernel")
    ns = dict(jax=jax, jnp=jnp, pl=pl, _shift_down=_shift_down,
              _prefix_sum=_prefix_sum, _prefix_max=_prefix_max, BB=BB,
              wq_max=wq_max, wt_max=wt_max, nc_all=nc_all)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(PROBE_SRC),
                 "exec"), ns)
    return ns["mk_kernel"]


def _jax_probe(meta, ptb, n_sel, wq_max, nc_all):
    n_blocks, wt_max, BB = ptb.shape
    # the grid spec of tools/tpu_pallas_probe2.py:64-69
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_blocks,),
        in_specs=[pl.BlockSpec((1, wt_max, BB), lambda b, m: (b, 0, 0))],
        out_specs=[pl.BlockSpec((1, nc_all, BB), lambda b, m: (b, 0, 0))])
    f = pl.pallas_call(
        _mk_kernel(BB, wq_max, wt_max, nc_all)(n_sel), grid_spec=gs,
        out_shape=[jax.ShapeDtypeStruct((n_blocks, nc_all, BB), jnp.int32)],
        interpret=True)
    (out,) = f(jnp.asarray(meta), jnp.asarray(ptb))
    return np.asarray(out)


@pytest.mark.parametrize("n_sel", [0, 5, 30])
def test_probe_reference_matches_mk_kernel(n_sel):
    n_blocks, BB, wq_max, wt_max, nc_all = 3, 128, 10, 16, 3
    rng = np.random.default_rng(100 + n_sel)
    meta = np.zeros((n_blocks, 4), np.int32)
    meta[:, 1] = (4, 10, 7)              # ql: short, full, in between
    meta[:, 2] = (12, 16, 9)             # wt_e
    meta[:, 3] = 1
    ptb = rng.integers(0, 30, (n_blocks, wt_max, BB)).astype(np.int32)
    want = _jax_probe(meta, ptb, n_sel, wq_max, nc_all)
    got = screen_probe(torch.from_numpy(meta), torch.from_numpy(ptb), n_sel,
                       wq_max=wq_max, nc_all=nc_all)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if n_sel:
        assert int(want.max()) > 0       # the DP scored something
        assert len({tuple(b.ravel()) for b in want}) == n_blocks


def test_probe_energy_table_is_the_select_chain():
    for n_sel in (5, 30):
        tab = probe_energy_table(n_sel).numpy()
        assert tab.shape == (31, 7)
        for v in range(31):
            for k in range(7):
                want = ((v * 7919 + k * 31) % 60000 - 30000
                        if v < min(n_sel, 30) else 0)
                assert tab[v, k] == want


def test_probe_inputs_are_the_tpu_probes():
    """tools/tpu_pallas_probe2.py:57-61: default_rng(0), ql 22, wt_e 30."""
    meta, ptb = probe_inputs(n_blocks=4)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        ptb, rng.integers(0, 30, (4, 32, 512)).astype(np.int32))
    assert meta.tolist() == [[0, 22, 30, 1]] * 4


def test_probe_wrapper_refuses_bad_inputs():
    meta = torch.zeros((2, 4), dtype=torch.int32)
    ptb = torch.zeros((2, 8, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_sel"):
        screen_probe(meta, ptb, 31, wq_max=4, nc_all=3)
    with pytest.raises(ValueError, match="int32"):
        screen_probe(meta, ptb.long(), 5, wq_max=4, nc_all=3)
    with pytest.raises(ValueError, match="expected"):
        screen_probe(meta[:1], ptb, 5, wq_max=4, nc_all=3)
    out = screen_probe_reference(meta, ptb, 0, wq_max=4, nc_all=3)
    assert out.shape == (2, 3, 32) and int(out.max()) == -1


def test_probe_entry_point_raises_without_a_card():
    from tntblast_tpu_torch.tools.screen_probe import run_variants
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_variants("cuda", n_blocks=1)
