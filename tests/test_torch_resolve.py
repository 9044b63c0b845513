"""The device path's resolve has no deadline and no host stand-in.

A step whose resolve takes longer than any budget is still taken: every
fragment the device was given is searched with the device's result, and the
output is the reference's.  A resolve that raises fails the search; the
host search never seeds a fragment in the device's place.  The port reads
no TNTBLAST_TPU_RESOLVE_TIMEOUT: the tests set it to a tenth of a second,
below the slowed resolve, to show that it changes nothing."""

import io
import pathlib
import time

import pytest
import torch

import tntblast_tpu_torch.parallel.panel as port_panel
from tntblast_tpu_torch import cli
from tntblast_tpu_torch import engine as eng

HERE = pathlib.Path(__file__).resolve().parent
DATA = HERE / "data"
GOLD = HERE / "golden" / "e2e"


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _search(name, tmp_path, monkeypatch):
    args = (GOLD / f"{name}.cmd").read_text().split()
    out_file = tmp_path / f"{name}.out"
    monkeypatch.chdir(DATA)
    monkeypatch.setenv("TNTBLAST_TPU_THREADS", "2")
    monkeypatch.setenv("TNTBLAST_TPU_RESOLVE_TIMEOUT", "0.1")
    ret = cli.local_main(args + ["-o", str(out_file), "-v", "F",
                                 "--tpu-screen", "T"],
                         stdout=io.StringIO(), device="cpu")
    return ret, out_file


@pytest.mark.parametrize("name", ["pcr_small", "pcr_frag"])
def test_slow_resolve_is_waited_for(name, tmp_path, monkeypatch):
    real_resolve = port_panel.FragmentPanelManager.resolve_batch
    real_get = eng._BatchHandle.get
    made, got = [], []

    class Spy(port_panel.FragmentPanelManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def resolve_batch(self, pending):
            time.sleep(0.5)
            return real_resolve(self, pending)

    def recorded_get(handle, idx):
        out = real_get(handle, idx)
        got.append(out)
        return out

    monkeypatch.setattr(port_panel, "FragmentPanelManager", Spy)
    monkeypatch.setattr(eng._BatchHandle, "get", recorded_get)
    ret, out_file = _search(name, tmp_path, monkeypatch)
    assert ret == 0
    (mgr,) = made
    assert got and all(isinstance(r, port_panel.PanelSeeds)
                       for r in got), got
    assert mgr.stats["fragments"] == len(got) > 0
    assert mgr.stats["fallback"] == 0 and mgr.stats["steps"] > 0
    assert out_file.read_text() == (GOLD / f"{name}.out").read_text()


def test_raising_resolve_fails_the_search(tmp_path, monkeypatch):
    searched = []
    real_search = eng.search_assay

    class Failing(port_panel.FragmentPanelManager):
        def resolve_batch(self, pending):
            raise RuntimeError("the device step failed")

    def recorded_search(ctx, sig, opt):
        searched.append(sig)
        return real_search(ctx, sig, opt)

    monkeypatch.setattr(port_panel, "FragmentPanelManager", Failing)
    monkeypatch.setattr(eng, "search_assay", recorded_search)
    with pytest.raises(RuntimeError, match="the device step failed"):
        _search("pcr_frag", tmp_path, monkeypatch)
    assert searched == []
