"""Inputs of the kernel checks and timings: the bench configuration's
device panel, one screen_dp call's arguments over a panel's slots, and the
comparison of a kernel's outputs with the plain version's.  Used by
chip_smoke.py and tools/dp_steps.py; runs on the CPU too (the tests do)."""

import os

import numpy as np
import torch

BENCH_ARGS = ["-A", "PCR", "-e", "40", "-E", "45", "-l", "2000"]


def bench_options(fna, panel, out_path):
    """The bench configuration's parsed options, assays expanded."""
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu_torch.options import Options

    opt = Options()
    opt.parse(["-i", panel, "-d", fna, *BENCH_ARGS, "-o", out_path])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    return opt


def bench_panel(fna, panel, device="cuda"):
    """The bench configuration's device panel (its tables on `device`)."""
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.parallel.panel import FragmentPanelManager

    opt = bench_options(fna, panel, os.devnull)
    mgr = FragmentPanelManager(opt, make_melt_engine(opt, n_threads=1),
                               device=device)
    if len(mgr.groups) != 1:
        raise RuntimeError(f"{len(mgr.groups)} panel groups")
    tile = mgr._tile_len(opt.fragment_target_threshold
                         + opt.max_product_length() + 2)
    return mgr.groups[0].device_panel(tile)


def chunk_inputs(rng, B, qp, ql_slot, tcan, device, invalid=0.03,
                 slot_major=False):
    """One screen_dp call's arguments: B windows over the slots of `qp`
    (n_real, wq_max) with lengths `ql_slot`, a share `invalid` of the
    entries outside the slots, random target bases in wt_max = wq_max + 8
    columns.  The slots are mixed at random, or with `slot_major` sorted
    with the invalid entries last, as the pooled stream of the device step
    is.  Returns (args, slot, ql) with args on `device`."""
    n_real, wq_max = qp.shape
    wt_max = wq_max + 8
    slot = rng.integers(0, n_real, B).astype(np.int32)
    slot[rng.random(B) < invalid] = n_real
    if slot_major:
        slot.sort()
    ql = np.append(ql_slot, ql_slot[-1:])[slot].astype(np.int32)
    wt_e = ql + 8
    tb5 = rng.integers(0, 4, (B, wt_max)).astype(np.int32)
    tb5[np.arange(wt_max)[None, :] >= wt_e[:, None]] = 0
    pt6 = np.concatenate([np.full((B, 1), 5, np.int32), tb5[:, :-1]], 1)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (pt6 * 5 + tb5, slot, ql, wt_e)]
    return args + [qp, tcan], slot, ql


def bench_chunk(dp, B, slot_major=False):
    """chunk_inputs for the bench panel `dp`: its own qpair rows, oligo
    lengths and tables."""
    st = dp.tabs["slots"]
    ql_slot = st["ql"].cpu().numpy()[:dp.n_real]
    return chunk_inputs(np.random.default_rng(20260818), B, st["qp"],
                        ql_slot, dp.tabs["tc_all"], st["qp"].device,
                        slot_major=slot_major)


def dp_errors(got, want, args, eval_on):
    """max |kernel - plain| of best, mgmax and the M rows in contract."""
    n_real, wq_max = args[4].shape
    err = [int((got[0].long() - want[0].long()).abs().max()),
           int((got[1].long() - want[1].long()).abs().max())]
    if eval_on:
        valid = (args[1] >= 0) & (args[1] < n_real)
        rows = (torch.arange(wq_max, device=args[0].device)[:, None]
                < args[2][None, :]) & valid[None, :]
        err.append(int((got[2][rows].long()
                        - want[2][rows].long()).abs().max()))
    return err
