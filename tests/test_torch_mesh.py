"""The port's mesh path on CPU tensors: MeshPanel over three CPU "devices"
against the port's single-device panel and against the JAX MeshPanel on the
8-device CPU mesh (every field exactly equal, with a batch that needs
padding), and the mesh goldens through the port's CLI."""

import io
import pathlib

import jax
import numpy as np
import pytest
import torch

from tntblast_tpu import native as ref_native
from tntblast_tpu.parallel import device_search as J
from tntblast_tpu.parallel import mesh as JM
from tntblast_tpu_torch import cli
from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch.parallel import panel as port_panel
from tntblast_tpu_torch.parallel.device_search import (
    INT_MIN, DevicePanel, PanelConfig)
from tntblast_tpu_torch.parallel.mesh import MeshPanel, make_mesh
from tntblast_tpu_torch.search import seed
from tntblast_tpu_torch.thermo.santa_lucia import build_tables

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"

FWD = "TTGACCTAGATATTCAGCAAC"
REV = "GGGAGAGACTCACCCAAAGATC"
OLIGOS = [(FWD, True), (FWD, False), (REV, True), (REV, False)]
FIELDS = ("os_idx", "p", "kmin", "keep", "needs_host", "counts",
          "slot_overflow")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mk_panel(word_len):
    panel = []
    for oligo, minus in OLIGOS:
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), np.uint8)]
        words = seed.oligo_word_list(codes, word_len, complement=not minus)
        panel.append({"words": words, "codes": codes, "minus": minus})
    return panel


def _fragments():
    """Five fragments (padded to six on three devices, to eight on the
    JAX mesh) with planted sites, a degenerate base and an N run."""
    rng = np.random.default_rng(7)
    frags = [rng.integers(0, 4, int(rng.integers(2000, 12000))).astype(
        np.uint8) for _ in range(5)]
    site = C.ASCII_TO_DB[np.frombuffer(FWD.encode(), np.uint8)]
    frags[0][500:500 + len(site)] = site
    frags[3][1500:1500 + len(site)] = site
    frags[3][1495] = C.DB_N
    frags[4][700:760] = C.DB_N
    return frags


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in FIELDS:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(w[key]), err_msg=key)
        assert bool(g["overflow"]) == bool(w["overflow"])


@pytest.fixture(scope="module")
def panel_args():
    """A panel with two screening conditions and the eval condition, from
    the JAX package's engine (both packages get the same arrays)."""
    engine = ref_native.MeltEngine(n_threads=1)
    w = 7
    dg = np.stack([engine.delta_g_screen(np.float32(t)).astype(
        np.int32).reshape(-1) for t in (313.15, 310.15)])
    thr = np.array([[60000] * 4, [90000] * 4], np.int32)
    ev_dg = np.ascontiguousarray(engine.delta_g().astype(np.int32).ravel())
    cfg = dict(word_len=w, num_os=8, max_words=16, wq_max=22,
               tile_len=16384, cap=512, num_cond=2)
    kw = dict(eval_dg=ev_dg, thermo_tables=build_tables())
    return w, cfg, dg, thr, kw


def test_mesh_panel_matches_single_device_and_jax(panel_args):
    w, cfg, dg, thr, kw = panel_args
    frags = _fragments()

    mp = MeshPanel(_mk_panel(w), PanelConfig(**cfg), dg, thr,
                   mesh=["cpu"] * 3, **kw)
    assert mp.n_dev == 3 and mp.eval_on
    pending = mp.submit_fragments(frags, full=True)
    (n, n_local), outs = pending
    assert (n, n_local) == (5, 2) and len(outs) == 3
    mesh_out = mp.resolve_fragments_full(pending)
    assert any(r["keep"].any() for r in mesh_out)
    assert any(r["needs_host"].any() for r in mesh_out)
    # one replica of the panel tables per mesh entry, uploaded once
    assert len(mp._replicas) == 3 and mp._replicas[0] is mp.tabs
    assert mp._replicas[1]["tc_all"] is not mp.tabs["tc_all"]
    replicas = mp._replicas
    mp.submit_fragments(frags[:1])
    assert mp._replicas is replicas

    sp = DevicePanel(_mk_panel(w), PanelConfig(**cfg), dg, thr,
                     device="cpu", **kw)
    _assert_same(mesh_out, [sp.run_fragments([f])[0] for f in frags])

    jmesh = JM.make_mesh(jax.devices())
    assert jmesh.devices.size == 8
    jp = JM.MeshPanel(_mk_panel(w), J.PanelConfig(**cfg), dg, thr,
                      mesh=jmesh, **kw)
    _assert_same(mesh_out, jp.run_fragments(frags))


def test_mesh_fast_resolve_matches_single_device(panel_args):
    """The kept-only resolve the search uses, in submission order."""
    w, cfg, dg, thr, kw = panel_args
    frags = _fragments()
    mp = MeshPanel(_mk_panel(w), PanelConfig(**cfg), dg, thr,
                   mesh=["cpu"] * 3, **kw)
    sp = DevicePanel(_mk_panel(w), PanelConfig(**cfg), dg, thr,
                     device="cpu", **kw)
    got = mp.resolve_fragments(mp.submit_fragments(frags))
    assert len(got) == 5
    for g, f in zip(got, frags):
        (want,) = sp.resolve_fragments(sp.submit_fragments([f]))
        assert g.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(want[key]), err_msg=key)
    assert sum(g["n_kept"] for g in got) > 0


def test_make_mesh():
    assert make_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="empty"):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(["cuda:0"])


@pytest.mark.parametrize("name", ["pcr_frag", "taqman", "pcr_small"])
def test_port_mesh_matches_golden(name, tmp_path, monkeypatch):
    """--mesh T through the port's CLI is output-invariant, and the search
    went through MeshPanel with one fragment per mesh device a step."""
    made = []

    class Spy(port_panel.FragmentPanelManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(port_panel, "FragmentPanelManager", Spy)
    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "2")
    ret = cli.local_main(args + ["-o", str(out_file), "--mesh", "T"],
                         stdout=io.StringIO(), device="cpu")
    assert ret == 0
    assert out_file.read_text() == (GOLD / f"{name}.out").read_text()
    (mgr,) = made
    assert mgr.mesh == [torch.device("cpu")] and mgr.batch == 1
    assert mgr.stats["fragments"] > 0 and mgr.stats["seeds"] > 0
    assert mgr.stats["fallback"] == 0 and not mgr.dead
    panels = [dp for g in mgr.groups for dp in g._panels.values()]
    assert panels and all(isinstance(dp, MeshPanel) for dp in panels)


def test_manager_batches_one_fragment_per_mesh_device(monkeypatch):
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu_torch.options import Options

    monkeypatch.chdir(DATA)
    opt = Options()
    opt.parse(["-i", "assay_pcr.txt", "-d", "small_db.fna", "-e", "40",
               "-E", "40"])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    melt = make_melt_engine(opt, n_threads=1)
    mesh = make_mesh(["cpu"] * 3)
    mgr = port_panel.FragmentPanelManager(opt, melt, "cpu", mesh=mesh)
    assert mgr.batch == 3
    plain = port_panel.FragmentPanelManager(opt, melt, "cpu")
    assert plain.batch == plain.SINGLE_CHIP_BATCH and plain.mesh is None
    rng = np.random.default_rng(2)
    frags = [rng.integers(0, 4, 5000).astype(np.uint8) for _ in range(2)]
    got = mgr.resolve_batch(mgr.submit_batch(frags))
    want = plain.resolve_batch(plain.submit_batch(frags))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            for a, b in zip(g[key], w[key]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
