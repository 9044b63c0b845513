"""Entry points of the device step: one step on a synthetic panel, and a
multi-device dry run of the whole engine.

Port of __graft_entry__.py.  The heart of the engine is the full-fragment
device search step (parallel/device_search.py): k-mer seeding, candidate
window decode and the batched thermodynamic DP for a whole oligo panel
against a batch of database fragments.

    python -m tntblast_tpu_torch.entry

runs both on the card: `entry()` once, then `dryrun_multichip` over every
visible card.
"""

import functools
import io
import os
import pathlib
import tempfile

import numpy as np
import torch

from tntblast_tpu_torch.ops.thermo_dp import build_qpair_rows, build_t_canon
from tntblast_tpu_torch.parallel.device_search import (
    DevicePanel, PanelConfig, panel_step_core)


# copy of __graft_entry__.py:15-30 _example_panel
def _example_panel(num_os, max_words, wq_max, num_cond, word_len, rng):
    """Random but realistic oligo panel arrays (primer-length oligos)."""
    ow = np.full((num_os, max_words), -1, dtype=np.int32)
    oc = np.zeros((num_os, wq_max), dtype=np.int32)
    olen = np.zeros(num_os, dtype=np.int32)
    om = np.zeros(num_os, dtype=bool)
    for i in range(num_os):
        n = int(rng.integers(max(word_len + 1, wq_max - 6), wq_max + 1))
        olen[i] = n
        oc[i, :n] = rng.integers(0, 4, n)
        nw = min(n - word_len + 1, max_words)
        ow[i, :nw] = rng.integers(0, 4 ** word_len, nw)
        om[i] = bool(i % 2)
    thr = np.full((num_cond, num_os), 50000, dtype=np.int32)
    dg = rng.integers(-80000, 30000, (num_cond, 49 * 49)).astype(np.int32)
    return ow, oc, olen, om, thr, dg


def entry(device="cuda"):
    """(fn, args): `fn(*args)` runs one forward search step on `device`,
    two 16384-base fragments against an 8-slot synthetic panel (rng seed 0,
    the arrays of the original entry).  Returns panel_step_core's outputs:
    (header, kept_block, slot, p, keep, needs_host, valid)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"entry: device {device} requested but CUDA is not available")

    word_len, num_os, max_words = 7, 8, 26
    wq_max, tile_len, cap, num_cond = 32, 16384, 4096, 2
    n_frags = 2

    rng = np.random.default_rng(0)
    raw = rng.integers(0, 4, (n_frags, tile_len)).astype(np.uint8)
    two = raw & 3
    frags = (two[:, 0::4] | (two[:, 1::4] << 2) | (two[:, 2::4] << 4)
             | (two[:, 3::4] << 6))
    lens = np.full(n_frags, tile_len, dtype=np.int32)
    L = tile_len
    run_s = np.full((n_frags, 8), L, np.int32)
    run_e = np.full((n_frags, 8), L, np.int32)
    exc_p = np.full((n_frags, 16), L, np.int32)
    exc_c = np.zeros((n_frags, 16), np.uint8)
    in_over = np.zeros(n_frags, bool)
    ow, oc, olen, om, thr, dg = _example_panel(
        num_os, max_words, wq_max, num_cond, word_len, rng)
    slot_meta = []
    for i in range(num_os):
        qpr = build_qpair_rows(oc[i:i + 1, :olen[i]].astype(np.int64),
                               [int(olen[i])], wq=int(olen[i]))[0]
        slot_meta.append((int(olen[i]), bool(om[i]),
                          tuple(int(v) for v in qpr),
                          int((ow[i] >= 0).sum()),
                          tuple(int(v) for v in oc[i, :olen[i]])))

    tcan = np.stack([build_t_canon(dg[c]) for c in range(num_cond)])
    tce = rng.integers(-60000, 60000, (30, 30, 7)).astype(np.int32)
    evt = np.zeros((num_os, wq_max, 25, 4), np.float32)
    evl = np.zeros((num_os, wq_max + 2), np.float32)
    wtab = np.zeros((4 ** word_len, num_os), np.int32)
    for i in range(num_os):
        for k in range(int((ow[i] >= 0).sum())):
            wtab[int(ow[i, k]), i] |= (1 << k)

    cfg = PanelConfig(word_len=word_len, num_os=num_os, max_words=max_words,
                      wq_max=wq_max, tile_len=tile_len, cap=cap,
                      num_cond=num_cond, kcap=cap)
    # the panel uploads the tables and lays out the kernel's once
    dp = DevicePanel.from_tables(
        cfg, slot_meta, (0.0, 0.0, 0.0, 0.0), 1, 1,
        (ow, wtab, tcan, thr, tce, evt, evl), device, eval_on=True)
    payload = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (frags, lens, run_s, run_e, exc_p, exc_c, in_over))
    fn = functools.partial(
        panel_step_core, tabs=dp.tabs, eval_const=dp.eval_const,
        word_len=word_len, num_os=num_os, max_words=max_words,
        wq_max=wq_max, tile_len=tile_len, cap=cfg.cap, kcap=cfg.kcap,
        num_cond=num_cond, n_frags=n_frags, eval_on=True)
    return fn, (payload,)


def dryrun_multichip(n_devices, device=None):
    """Run a REAL (tiny) search through the full engine with `--mesh T`
    over a mesh of `n_devices` entries, and require the hit list to be
    byte-identical to the recorded reference golden.

    The mesh is the first `n_devices` cards, or `n_devices` entries of
    `device` where one is named (on the CPU a mesh is `[cpu] * n_devices`:
    each entry gets its own table replica).  Fragments are the
    data-parallel axis (the reference's database segmentation,
    tntblast_master.cpp:28 semantics); the oligo panel and thermodynamic
    tables are replicated.  Host pairing/output runs on the coordinator
    exactly like the reference master's reduce phase.
    """
    from tntblast_tpu_torch import cli
    from tntblast_tpu_torch.parallel.mesh import make_mesh

    if device is None:
        devices = make_mesh()[:n_devices]
    else:
        devices = make_mesh([device] * n_devices)
    if len(devices) != n_devices:
        raise RuntimeError(
            f"dryrun_multichip: {len(devices)} devices, {n_devices} asked")

    here = pathlib.Path(__file__).resolve().parent.parent
    data = here / "tests" / "data"
    gold = here / "tests" / "golden" / "e2e"

    # pcr_frag: forces target fragmentation (--max-target-len 5000), so
    # the mesh batch axis actually carries multiple fragments.
    args = (gold / "pcr_frag.cmd").read_text().split()
    cwd = os.getcwd()
    out_path = tempfile.NamedTemporaryFile(suffix=".out", delete=False).name
    try:
        os.chdir(data)
        ret = cli.local_main(args + ["-o", out_path, "--mesh", "T"],
                             stdout=io.StringIO(), device=devices)
        if ret != 0:
            raise RuntimeError(f"mesh search exit code {ret}")
        got = pathlib.Path(out_path).read_text()
        want = (gold / "pcr_frag.out").read_text()
        if got != want:
            raise RuntimeError(
                "mesh hit list diverges from reference golden")
    finally:
        os.chdir(cwd)
        os.unlink(out_path)


def main():
    fn, args = entry()
    res = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(r.shape) for r in res])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
