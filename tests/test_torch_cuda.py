"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA GPU and skips elsewhere.  The file imports
neither jax nor the JAX package (the GPU machine need not have jax); run it
there with

    TNTBLAST_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py

(TNTBLAST_TEST_TPU=1 keeps tests/conftest.py from importing jax).
"""

import io
import pathlib

import numpy as np
import pytest
import torch

from tntblast_tpu_torch import cli
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import native
from tntblast_tpu_torch.ops.screen_dp import (
    NEG_I32, screen_dp, screen_dp_reference)
from tntblast_tpu_torch.ops.screen_probe import (
    screen_probe, screen_probe_reference)
from tntblast_tpu_torch.ops.thermo_dp import build_t_canon
from tntblast_tpu_torch.parallel.device_search import DevicePanel, PanelConfig
from tntblast_tpu_torch.parallel.mesh import MeshPanel, make_mesh
from tntblast_tpu_torch.search import seed
from tntblast_tpu_torch.thermo.santa_lucia import build_tables

HERE = pathlib.Path(__file__).resolve().parent
GOLD = HERE / "golden" / "e2e"

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(rng, B, n_real, wq_max, nc_all):
    eng = native.MeltEngine(n_threads=1)
    tcan = np.stack([build_t_canon(eng.delta_g_screen(np.float32(t)).astype(
        np.int32).ravel()) for t in (313.15, 310.15, 303.15)][:nc_all])
    qp = rng.integers(0, 30, (n_real, wq_max)).astype(np.int32)
    ql = rng.integers(wq_max - 6, wq_max + 1, n_real).astype(np.int32)
    slot = rng.integers(0, n_real, B).astype(np.int32)
    slot[rng.random(B) < 0.1] = 64                 # invalid entries
    wt_max = wq_max + 8
    tb5 = rng.integers(0, 5, (B, wt_max)).astype(np.int32)
    pt6 = np.concatenate([np.full((B, 1), 5, np.int32), tb5[:, :-1]], 1)
    q_e = ql[np.clip(slot, 0, n_real - 1)]
    return {"ptb": pt6 * 5 + tb5, "slot": slot, "ql": q_e,
            "wt_e": q_e + 8, "qp": qp, "tcan": tcan}


@pytest.mark.parametrize("eval_on", [False, True])
def test_screen_dp_kernel_matches_plain(cuda, eval_on):
    rng = np.random.default_rng(17)
    case = _stream(rng, 4096, 12, 24, 3 if eval_on else 2)
    dev = {k: torch.from_numpy(v).to(cuda) for k, v in case.items()}
    before = screen_dp.launches
    got = screen_dp(*dev.values(), eval_on=eval_on)
    torch.cuda.synchronize()
    assert screen_dp.launches == before + 1
    want = screen_dp_reference(*dev.values(), eval_on=eval_on)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    valid = torch.from_numpy(case["slot"] < 12).to(cuda)
    assert (got[0][:, ~valid] == -1).all()
    assert (got[1][~valid] == NEG_I32).all()
    if not eval_on:
        assert got[2] is None and want[2] is None
        return
    rows = torch.arange(24, device=cuda)[:, None] < dev["ql"][None, :]
    keep = rows & valid[None, :]
    assert torch.equal(got[2][keep], want[2][keep])


@pytest.mark.parametrize("n_sel", [0, 5, 30])
def test_screen_probe_kernel_matches_plain(cuda, n_sel):
    """ql and wt_e vary per block, a block has ql 0, and ptb carries values
    outside [0, 30) (zero energies)."""
    rng = np.random.default_rng(23 + n_sel)
    n_blocks, wt_max, BB, wq_max, nc_all = 6, 32, 512, 24, 3
    meta = np.zeros((n_blocks, 4), np.int32)
    meta[:, 1] = (22, 24, 0, 9, 17, 24)
    meta[:, 2] = (30, 32, 12, 17, 25, 5)
    ptb = rng.integers(0, 30, (n_blocks, wt_max, BB)).astype(np.int32)
    ptb[1, :, ::7] = 31
    ptb[4, ::3, :] = -2
    meta_d = torch.from_numpy(meta).to(cuda)
    ptb_d = torch.from_numpy(ptb).to(cuda)
    before = screen_probe.launches
    got = screen_probe(meta_d, ptb_d, n_sel, wq_max=wq_max, nc_all=nc_all)
    torch.cuda.synchronize()
    assert screen_probe.launches == before + 1
    want = screen_probe_reference(meta_d, ptb_d, n_sel, wq_max=wq_max,
                                  nc_all=nc_all)
    assert got.shape == (n_blocks, nc_all, BB)
    assert torch.equal(got, want)
    assert (got[2] == -1).all()                    # ql 0: nothing scored
    cpu = screen_probe(torch.from_numpy(meta), torch.from_numpy(ptb), n_sel,
                       wq_max=wq_max, nc_all=nc_all)
    assert torch.equal(got.cpu(), cpu)
    assert screen_probe.launches == before + 1     # CPU tensors: no launch


@pytest.mark.parametrize("flag", ["--tpu-screen", "--mesh"])
def test_port_golden_on_cuda(cuda, tmp_path, monkeypatch, flag):
    args = (GOLD / "pcr_small.cmd").read_text().split()
    out = tmp_path / "o.out"
    monkeypatch.chdir(HERE / "data")
    before = screen_dp.launches
    assert cli.local_main(args + ["-o", str(out), "-v", "F", flag, "T"],
                          stdout=io.StringIO(), device=cuda) == 0
    assert screen_dp.launches > before
    assert out.read_text() == (GOLD / "pcr_small.out").read_text()


def _panel(device, mesh=None):
    eng = native.MeltEngine(n_threads=1)
    w = 7
    panel = []
    for oligo in ("TTGACCTAGATATTCAGCAAC", "GGGAGAGACTCACCCAAAGATC"):
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        for minus in (True, False):
            panel.append({"words": seed.oligo_word_list(
                codes, w, complement=not minus), "codes": codes,
                "minus": minus})
    cfg = PanelConfig(word_len=w, num_os=8, max_words=16, wq_max=22,
                      tile_len=32768, cap=2048, num_cond=1)
    dg = eng.delta_g_screen(np.float32(313.15)).astype(np.int32)
    args = (panel, cfg, dg.reshape(1, -1), np.full((1, 4), 100000, np.int32))
    kw = dict(eval_dg=eng.delta_g().astype(np.int32).ravel(),
              thermo_tables=build_tables())
    if mesh is not None:
        return MeshPanel(*args, mesh=mesh, **kw)
    return DevicePanel(*args, device=device, **kw)


@pytest.mark.parametrize("mesh", [False, True])
def test_submit_is_asynchronous_and_matches_cpu(cuda, mesh):
    """Queueing a step issues no host sync (the resolve does), and the
    CUDA step's kept seeds and eval words equal the CPU step's; the same
    for a mesh over every visible card (twice each, so a batch of four is
    split whatever the count)."""
    rng = np.random.default_rng(5)
    frags = [rng.integers(0, 4, 30000).astype(np.uint8) for _ in range(4)]
    frags[1][7000:7400] = C.DB_N
    site = C.ASCII_TO_DB[np.frombuffer(b"TTGACCTAGATATTCAGCAAC", np.uint8)]
    frags[0][1000:1000 + len(site)] = site
    cuda_panel = _panel(cuda, mesh=make_mesh() * 2 if mesh else None)
    cuda_panel.submit_fragments(frags)           # warm-up: pinned buffers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [cuda_panel.submit_fragments(frags) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = cuda_panel.resolve_fragments(pending[-1])
    cpu_panel = _panel("cpu")
    want = cpu_panel.resolve_fragments(cpu_panel.submit_fragments(frags))
    assert sum(r["n_kept"] for r in want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)
