"""Inputs of the kernel checks and timings: the bench configuration's
device panel, one screen_dp call's arguments over a panel's slots, one
eval_pack call's arguments behind it, synthetic seed, pool and kept calls,
a device step's real inputs of one stage, and the comparison of a kernel's
outputs with the plain version's.  Used by chip_smoke.py, tools/dp_steps.py
and the tests; runs on the CPU too (the tests do)."""

import os

import numpy as np
import torch

BENCH_ARGS = ["-A", "PCR", "-e", "40", "-E", "45", "-l", "2000"]


def bench_options(fna, panel, out_path, args=BENCH_ARGS):
    """The bench configuration's parsed options, assays expanded; with
    `args` another search of the same files (the long-probe one:
    tools/probe_bench.py PROBE_ARGS over its probes)."""
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu_torch.options import Options

    opt = Options()
    opt.parse(["-i", panel, "-d", fna, *args, "-o", out_path])
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe, False),
        opt.degen_rescale_ct)
    return opt


def bench_panel(fna, panel, device="cuda", args=BENCH_ARGS):
    """The bench configuration's device panel (its tables on `device`), or
    with `args` that of another search (as bench_options)."""
    from tntblast_tpu_torch.engine import make_melt_engine
    from tntblast_tpu_torch.parallel.panel import FragmentPanelManager

    opt = bench_options(fna, panel, os.devnull, args)
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
    slot, ql, wt_e, tb5 = _windows(rng, B, qp.shape, ql_slot, invalid,
                                   slot_major)
    return _dp_args(tb5, slot, ql, wt_e, qp, tcan, device), slot, ql


def _windows(rng, B, qp_shape, ql_slot, invalid, slot_major):
    """(slot, ql, wt_e, tb5) of B random windows over the slots."""
    n_real, wq_max = qp_shape
    wt_max = wq_max + 8
    slot = rng.integers(0, n_real, B).astype(np.int32)
    slot[rng.random(B) < invalid] = n_real
    if slot_major:
        slot.sort()
    ql = np.append(ql_slot, ql_slot[-1:])[slot].astype(np.int32)
    wt_e = ql + 8
    tb5 = rng.integers(0, 4, (B, wt_max)).astype(np.int32)
    tb5[np.arange(wt_max)[None, :] >= wt_e[:, None]] = 0
    return slot, ql, wt_e, tb5


def _dp_args(tb5, slot, ql, wt_e, qp, tcan, device):
    pt6 = np.concatenate([np.full((len(tb5), 1), 5, np.int32), tb5[:, :-1]],
                         1)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (pt6 * 5 + tb5, slot, ql, wt_e)]
    return args + [qp, tcan]


def eval_inputs(rng, B, qp, qc, ql_slot, tcan, device, invalid=0.03,
                slot_major=False, planted=0.5):
    """One screen_dp call's arguments and what eval_pack needs beside its
    outputs: windows as chunk_inputs makes them, a share `planted` of them
    holding the reverse complement of their slot's oligo (codes `qc`,
    (>= n_real, wq_max)) at a random offset with up to three substitutions,
    so that trusted alignments with mismatches and loops occur; a tenth of
    the entries need the host.  Returns (dp_args, tb5, needs_host,
    ent_valid) on `device`."""
    n_real, wq_max = qp.shape
    slot, ql, wt_e, tb5 = _windows(rng, B, qp.shape, ql_slot, invalid,
                                   slot_major)
    codes = qc.cpu().numpy()
    for b in np.flatnonzero((rng.random(B) < planted) & (slot < n_real)
                            & (ql > 0)):
        n = int(ql[b])
        site = (3 - codes[slot[b], :n][::-1]) % 4
        k = int(rng.integers(0, 4))
        site[rng.integers(0, n, k)] = rng.integers(0, 4, k)
        off = int(rng.integers(0, 9))
        tb5[b, off:off + n] = site
    needs_host, ent_valid = rng.random(B) < 0.1, slot < n_real
    tb5_d, nh_d, ev_d = (
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (tb5, needs_host, ent_valid))
    return (_dp_args(tb5, slot, ql, wt_e, qp, tcan, device), tb5_d, nh_d,
            ev_d)


def bench_chunk(dp, B, slot_major=False):
    """chunk_inputs for the bench panel `dp`: its own qpair rows, oligo
    lengths and tables."""
    st = dp.tabs["slots"]
    ql_slot = st["ql"].cpu().numpy()[:dp.n_real]
    return chunk_inputs(np.random.default_rng(20260818), B, st["qp"],
                        ql_slot, dp.tabs["tc_all"], st["qp"].device,
                        slot_major=slot_major)


def synthetic_eval_panel(rng, n_real, wq_max, device):
    """The tables of a panel of `n_real` random oligos of wq_max - 6 ..
    wq_max bases (the first of full length, the second with an inosine) for
    screen_dp with eval_on and for eval_pack: dict of qp, qc, ql_slot, tcan
    (two screening conditions and the eval condition), ev_tabs, ev_loop on
    `device`, and eval_const."""
    from tntblast_tpu_torch import native
    from tntblast_tpu_torch.ops.eval_gapless import build_slot_eval_arrays
    from tntblast_tpu_torch.ops.thermo_dp import (
        build_qpair_rows, build_t_canon)
    from tntblast_tpu_torch.thermo.santa_lucia import build_tables

    eng = native.MeltEngine(n_threads=1)
    thermo = build_tables()
    ql_slot = rng.integers(max(wq_max - 6, 1), wq_max + 1, n_real).astype(
        np.int32)
    ql_slot[0] = wq_max
    qp = np.zeros((n_real, wq_max), np.int32)
    qc = np.zeros((n_real + 1, wq_max), np.int32)
    ev_tabs = np.zeros((n_real, wq_max, 25, 4), np.float32)
    ev_loop = np.zeros((n_real, wq_max + 2), np.float32)
    for s, n in enumerate(ql_slot):
        codes = rng.integers(0, 4, n).astype(np.int64)
        if s == 1:
            codes[n // 2] = 4
        qp[s] = build_qpair_rows(codes[None, :], [n], wq=wq_max)[0]
        qc[s, :n] = codes
        tabs = build_slot_eval_arrays(codes, thermo)
        for k, name in enumerate(("Hstk", "Sstk", "Hlt", "Slt")):
            ev_tabs[s, :n, :, k] = tabs[name]
        ev_loop[s, :n + 1] = tabs["loop2m"]
    tcan = np.stack(
        [build_t_canon(eng.delta_g_screen(np.float32(t)).astype(
            np.int32).ravel()) for t in (313.15, 318.15)]
        + [build_t_canon(eng.delta_g().astype(np.int32).ravel())])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"qp": t(qp), "qc": t(qc), "ql_slot": ql_slot, "tcan": t(tcan),
            "ev_tabs": t(ev_tabs), "ev_loop": t(ev_loop),
            "eval_const": tuple(float(tabs[k]) for k in
                                ("AT_H", "AT_S", "init_H", "init_S"))}


def bench_eval_chunk(dp, B, slot_major=False):
    """eval_inputs for the bench panel `dp` (its own oligos and tables)."""
    st = dp.tabs["slots"]
    ql_slot = st["ql"].cpu().numpy()[:dp.n_real]
    return eval_inputs(np.random.default_rng(20261017), B, st["qp"],
                       st["qc"], ql_slot, dp.tabs["tc_all"],
                       st["qp"].device, slot_major=slot_major)


def eval_pack_args(dp_args, M_rows, mgmax, tb5, needs_host, ent_valid, qc,
                   ev_tabs, ev_loop):
    """eval_pack's tensor arguments from a screen_dp call's arguments and
    outputs and the rest of an eval_inputs result."""
    _, slot, ql, wt_e = dp_args[:4]
    return (M_rows, mgmax, tb5, slot, ql, wt_e, needs_host, ent_valid, qc,
            ev_tabs, ev_loop)


def eval_stage_args(inputs, qc, ev_tabs, ev_loop, tables=None):
    """eval_pack's tensor arguments behind the screen_dp kernel, as the
    step makes them: `inputs` is an eval_inputs (or bench_eval_chunk)
    result, the M rows and mgmax come from screen_dp with eval_on."""
    from tntblast_tpu_torch.ops.screen_dp import screen_dp

    dp_args, tb5, needs_host, ent_valid = inputs
    _, mgmax, M_rows = screen_dp(*dp_args, eval_on=True, tables=tables)
    return eval_pack_args(dp_args, M_rows, mgmax, tb5, needs_host, ent_valid,
                          qc, ev_tabs, ev_loop)


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


def decode_inputs(rng, B, wq_max, device, *, word_len=7, n=8, L=16384,
                  num_os=16, invalid=0.25):
    """One win_decode call's arguments as a step's pooled stream holds
    them: n random fragments of up to L bases (lengths down to L / 2) with
    N runs and scattered degenerate bases, their 2-bit words and validity
    as seed_fragments makes them, slot tables of num_os - 2 oligos of
    wq_max - 6 .. wq_max bases on both strands (row num_os the defaults),
    and B entries sorted by slot with a share `invalid` of them past the
    pool at the end (slot num_os), each on a random fragment and diagonal
    from below NUM_FLANK_BASE to past the fragment's end.  Returns (args,
    kw) for win_decode(*args, **kw), the tensors on `device`."""
    from tntblast_tpu_torch import constants as C

    nw_pos = L - word_len + 1
    codes = rng.integers(0, 4, (n, L)).astype(np.int32)
    for f in range(n):
        for s in rng.integers(0, L - 64, 6):
            codes[f, s:s + int(rng.integers(1, 60))] = C.DB_N
        codes[f, rng.integers(0, L, 40)] = rng.integers(4, 16, 40)
    lens = rng.integers(L // 2, L + 1, n).astype(np.int32)
    lens[0] = L
    pos = np.arange(L)[None, :]
    valid_base = (codes <= C.DB_MAX_ATGC) & (pos < lens[:, None])
    word = np.zeros((n, nw_pos), np.int64)
    for k in range(word_len):
        word |= (codes[:, k:nw_pos + k] & 3).astype(np.int64) << (
            2 * (word_len - 1 - k))
    vc = np.concatenate([np.zeros((n, 1), np.int64),
                         np.cumsum(valid_base, axis=1)], axis=1)
    word_valid = ((vc[:, word_len:] - vc[:, :-word_len]) == word_len) & (
        np.arange(nw_pos)[None, :] < (lens - word_len + 1)[:, None])
    n_real = max(num_os - 2, 1)
    slot_ql = np.ones(num_os + 1, np.int32)
    slot_ql[:n_real] = rng.integers(max(wq_max - 6, 1), wq_max + 1, n_real)
    slot_ql[0] = wq_max
    slot_minus = np.zeros(num_os + 1, bool)
    slot_minus[:n_real] = np.arange(n_real) % 2 == 0
    n_valid = B - int(round(invalid * B))
    slot = np.full(B, num_os, np.int32)
    slot[:n_valid] = np.sort(rng.integers(0, n_real, n_valid))
    frag = rng.integers(0, n, B).astype(np.int32)
    p = rng.integers(-8, L + 8, B).astype(np.int32)
    order = np.lexsort((p, frag, slot))
    slot, frag, p = slot[order], frag[order], p[order]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = (t(slot), t(p), t(frag), t(lens), t(word.astype(np.int32).ravel()),
            t(word_valid.ravel()), t(slot_ql), t(slot_minus))
    kw = dict(n=n, L=L, wt_max=wq_max + 2 * C.NUM_FLANK_BASE,
              word_len=word_len, nw_pos=nw_pos, num_os=num_os)
    return args, kw


def eager_step(dp, payload, full=False, device=None, tabs=None):
    """The device step of panel `dp` on a host payload dispatched op by op
    (panel_step_core), on a card too, where DevicePanel.step replays the
    step's CUDA graph: the step a graph captures, for the tools and tests
    that time it or look inside it.  On the panel's own device and tables
    unless a replica's are given."""
    device = dp.device if device is None else device
    return dp.step_core(tuple(dp._upload(a, device) for a in payload),
                        dp.tabs if tabs is None else tabs, len(payload[0]),
                        full)


class _DecodeCall(Exception):
    pass


def step_decode_inputs(dp, frags):
    """The arguments (args, kw) of the win_decode call that the device
    step of panel `dp` makes on fragments `frags`: the step's real pooled
    stream.  The step stops at that call (nothing after it runs).  On a
    card the step decodes through the panel's plan; here it is taken away
    for the step, which then calls win_decode with the same stream (the
    eager step: a replay of the step's graph calls no function)."""
    from tntblast_tpu_torch.parallel import device_search

    def capture(*args, **kw):
        raise _DecodeCall(args, kw)

    real = device_search.win_decode
    plan = dp.tabs.pop("decode_plan", None)
    device_search.win_decode = capture
    try:
        eager_step(dp, dp._pack_host(frags))
    except _DecodeCall as call:
        return call.args
    finally:
        device_search.win_decode = real
        if plan is not None:
            dp.tabs["decode_plan"] = plan
    raise RuntimeError("the step made no win_decode call")


def step_plan_inputs(dp, frags, name):
    """(args, kw) of the one call that the eager device step of panel `dp`
    on fragments `frags` makes of the plan `name` in its tables
    ("pool_plan", "kept_plan"; on a card): the step's real inputs of that
    stage.  The step runs to its end, the call going through the plan."""
    plan = dp.tabs[name]
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return plan(*args, **kw)

    dp.tabs[name] = record
    try:
        eager_step(dp, dp._pack_host(frags))
    finally:
        dp.tabs[name] = plan
    if len(calls) != 1:
        raise RuntimeError(f"the step called {name} {len(calls)} times")
    return calls[0]


def seed_words_at(codes, x, w, count):
    """The 2-bit words at positions x .. x + count - 1 of a code row."""
    out = []
    for q in range(x, x + count):
        v = 0
        for k in range(w):
            v = (v << 2) | (int(codes[q + k]) & 3)
        out.append(v)
    return out


def seed_w_table(ow, word_len):
    """The (4^w, num_os) int32 w_table of per-slot word lists ow (num_os,
    max_words), -1 past a list: bit k of [v, s] iff word k of slot s is v."""
    w_table = np.zeros((4 ** word_len, ow.shape[0]), np.int64)
    for s, k in np.argwhere(ow >= 0):
        w_table[ow[s, k], s] |= 1 << int(k)
    return w_table.astype(np.uint32).view(np.int32)


def seed_panel(rng, codes, *, word_len, num_os, max_words, share=0,
               repeat=0, negative=0, empty=0):
    """(ow, w_table) of a panel that seeds in the code rows (n, L): the
    word lists of `seed_oligo_words` and their table."""
    ow = seed_oligo_words(rng, codes, word_len=word_len, num_os=num_os,
                          max_words=max_words, share=share, repeat=repeat,
                          negative=negative, empty=empty)
    return ow, seed_w_table(ow, word_len)


def seed_oligo_words(rng, codes, *, word_len, num_os, max_words, share=0,
                     repeat=0, negative=0, empty=0):
    """ow (num_os, max_words) int32 of a panel that seeds in the code rows
    (n, L), -1 past a slot's words: each slot's oligo is up to max_words
    consecutive words of a fragment (every third slot max_words of them,
    every slot at least one); the first `negative` oligos start with 1-4
    random words before words taken at position 0 (hits at negative
    diagonals); then `share` words copied from another slot (a word in
    several slots) and `repeat` words repeated inside an oligo; the last
    `empty` slots hold no oligo."""
    n, L = codes.shape
    w = word_len
    ow = np.full((num_os, max_words), -1, np.int32)
    for s in range(num_os - empty):
        nw = max_words if s % 3 == 0 else int(rng.integers(1, max_words + 1))
        nw = min(nw, L - w + 1)
        f = int(rng.integers(0, n))
        if s < negative:
            lead = min(int(rng.integers(1, 5)), nw - 1)
            words = (rng.integers(0, 4 ** w, lead).tolist()
                     + seed_words_at(codes[f], 0, w, nw - lead))
        else:
            x = int(rng.integers(0, L - w - nw + 2))
            words = seed_words_at(codes[f], x, w, nw)
        ow[s, :nw] = words
    used = np.argwhere(ow >= 0)
    for _ in range(share):
        (s1, k1), (s2, k2) = used[rng.integers(0, len(used), 2)]
        ow[s1, k1] = ow[s2, k2]
    for _ in range(repeat):
        s = int(rng.integers(0, num_os - empty))
        nw = int((ow[s] >= 0).sum())
        if nw > 1:
            k1, k2 = rng.integers(0, nw, 2)
            ow[s, k2] = ow[s, k1]
    return ow


def seed_payload(codes, flens, runs=(), excs=(), R=8, E=16):
    """The packed payload (numpy) of code rows (n, L) in 0..3 (the 2-bit
    stream), their lengths, N runs {fragment: [(start, end), ...]} and
    exceptions {fragment: [(position, code), ...]} in the order given,
    with R run and E exception rows a fragment padded by L."""
    n, L = codes.shape
    two = codes.astype(np.uint8) & 3
    packed = (two[:, 0::4] | (two[:, 1::4] << 2) | (two[:, 2::4] << 4)
              | (two[:, 3::4] << 6)).astype(np.uint8)
    rs = np.full((n, R), L, np.int32)
    re_ = np.full((n, R), L, np.int32)
    ep = np.full((n, E), L, np.int32)
    ec = np.zeros((n, E), np.uint8)
    for f, rl in dict(runs).items():
        for i, (a, b) in enumerate(rl):
            rs[f, i], re_[f, i] = a, b
    for f, el in dict(excs).items():
        for i, (x, c) in enumerate(el):
            ep[f, i], ec[f, i] = x, c
    return (packed, np.asarray(flens, np.int32), rs, re_, ep, ec)


def seed_inputs(rng, device, *, n=8, L=8192, word_len=7, num_os=40,
                max_words=18, cap=2048, share=0, repeat=0):
    """One seed call's arguments on the word-table path: n random
    fragments in a tile of L (lengths L, 0, word_len - 1, L - 1 and random
    ones), up to 6 N runs a fragment (overlapping, one from 0 and one to L
    on some) and up to 40 exceptions at distinct positions (degenerate, N
    and unknown codes; pads at L among them on odd fragments) in the
    payload's 256 run and 2048 exception rows, and a `seed_panel` of
    num_os - 2 oligos (two with hits at negative diagonals, `share` and
    `repeat` as it says); s_max and k_max as the table needs them
    (ops/seed.py::seed_lanes).  Returns (args, kw) for
    ops/seed.py::seed(*args, **kw), the tensors on `device`."""
    from tntblast_tpu_torch.ops.seed import seed_lanes

    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    w = word_len
    ow, w_table = seed_panel(rng, codes, word_len=w, num_os=num_os,
                             max_words=max_words, share=share,
                             repeat=repeat, negative=2,
                             empty=min(2, num_os - 1))
    lens = rng.integers(1, L + 1, n).astype(np.int32)
    lens[:4] = [L, 0, w - 1, L - 1][:min(n, 4)]
    runs, excs = {}, {}
    for f in range(n):
        k = int(rng.integers(0, 7))
        starts = rng.integers(0, L, k)
        ends = np.minimum(starts + rng.integers(1, 200, k), L)
        runs[f] = list(zip(starts.tolist(), ends.tolist()))
        if f % 3 == 0:
            runs[f] += [(0, int(rng.integers(1, 50))),
                        (L - int(rng.integers(1, 50)), L)]
        m = min(int(rng.integers(0, 41)), L)
        excs[f] = list(zip(rng.choice(L, m, replace=False).tolist(),
                           rng.choice([4, 9, 14, 15, 17], m).tolist()))
        for _ in range(int(rng.integers(0, 8)) if f % 2 else 0):
            excs[f].insert(int(rng.integers(0, len(excs[f]) + 1)), (L, 9))
    payload = seed_payload(codes, lens, runs, excs, R=256, E=2048)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = tuple(t(a) for a in (*payload, w_table))
    s_max, k_max = seed_lanes(w_table)
    kw = dict(word_len=w, num_os=num_os, max_words=max_words, tile_len=L,
              cap=cap, s_max=s_max, k_max=k_max)
    return args, kw


def pool_inputs(rng, n, cap, num_os, n_cand, one_slot=False, garbage=True):
    """One pool call's arguments as numpy arrays (slot, p, n_cand), as the
    seed stage hands them: slot in [0, num_os) (all one slot with
    `one_slot`) and p below n_cand of each fragment, and past it garbage
    (a slot of 999: the kernel must not read it) or, without `garbage`,
    the seed's zeros."""
    slot = (np.full((n, cap), num_os // 2, np.int32) if one_slot
            else rng.integers(0, num_os, (n, cap)).astype(np.int32))
    p = rng.integers(-31, 1 << 19, (n, cap)).astype(np.int32)
    n_cand = np.asarray(n_cand, np.int32)
    past = np.arange(cap)[None, :] >= np.minimum(n_cand, cap)[:, None]
    slot[past] = 999 if garbage else 0
    if not garbage:
        p[past] = 0
    return slot, p, n_cand


# the arguments of ops/kept.py::kept_reference, in order
KEPT_ARGS = ("best", "slot_str", "p_str", "frag_str", "order_str",
             "needs_host", "ent_valid", "ev_all", "word_f", "word_valid_f",
             "ow", "thr", "overflow", "input_over", "n_cand", "counts")


def kept_inputs(rng, *, n=3, cap=3000, num_os=16, n_real=None, num_cond=2,
                rows=None, max_words=12, nw_pos=4000, eval_on=True,
                valid_share=0.6, nh_share=0.1, thr_hi=200, off_share=0.2,
                alphabet=4, n_cand=None):
    """One kept call's arguments as numpy arrays, in a dict keyed by
    KEPT_ARGS, with the shapes (num_cond, num_os, max_words, nw_pos) and
    the thresholds of the n_real real slots (`thresholds`, (num_cond,
    n_real); thr pads them with INT_MIN): a pooled stream as the pool and
    the decode give it (about valid_share x cap candidates a fragment, or
    the counts `n_cand` when given, slot-major, the invalid tail keyed
    num_os, a share nh_share of them routed to the host), `rows` rows of
    random scores around random thresholds below thr_hi (a share
    off_share of them off), words from an
    alphabet of `alphabet` letters (4: the oligos' words match often),
    diagonals before and past the fragment, and the evaluator's words (None
    when not eval_on)."""
    from tntblast_tpu_torch.ops.kept import INT_MIN
    from tntblast_tpu_torch.ops.pool import pool_reference

    n_real = num_os - 3 if n_real is None else n_real
    rows = num_cond + 1 if rows is None else rows
    slot = rng.integers(0, num_os, (n, cap)).astype(np.int32)
    p = rng.integers(-max_words - 3, nw_pos + 3, (n, cap)).astype(np.int32)
    drawn = (cap * valid_share * rng.uniform(0.5, 1.5, n)).astype(np.int32)
    n_cand = drawn if n_cand is None else np.asarray(n_cand, np.int32)
    pooled = pool_reference(torch.from_numpy(slot), torch.from_numpy(p),
                            torch.from_numpy(n_cand), num_os=num_os)
    slot_str, p_str, frag_str, order_str = (t.numpy() for t in pooled[:4])
    Bp = n * cap
    ent_valid = slot_str < num_os
    needs_host = (rng.random(Bp) < nh_share) & ent_valid
    thresholds = rng.integers(0, thr_hi, (num_cond, n_real)).astype(np.int32)
    thresholds[rng.random((num_cond, n_real)) < off_share] = INT_MIN
    thr = np.full((num_cond, num_os + 1), INT_MIN, np.int32)
    thr[:, :n_real] = thresholds
    ow = rng.integers(-1, alphabet, (num_os, max_words)).astype(np.int32)
    ow[:, -2:] = -1                               # words past the oligo
    return dict(
        best=rng.integers(-1, thr_hi + 50, (rows, Bp)).astype(np.int32),
        slot_str=slot_str, p_str=p_str, frag_str=frag_str,
        order_str=order_str, needs_host=needs_host, ent_valid=ent_valid,
        ev_all=(rng.integers(-(1 << 31), 1 << 31, (Bp, 5), dtype=np.int64)
                .astype(np.int32) if eval_on else None),
        word_f=rng.integers(0, alphabet, n * nw_pos).astype(np.int32),
        word_valid_f=rng.random(n * nw_pos) < 0.9,
        ow=ow, thr=thr, thresholds=thresholds,
        overflow=rng.random(n) < 0.3, input_over=rng.random(n) < 0.3,
        n_cand=n_cand,
        counts=rng.integers(0, 500, (n, num_os)).astype(np.int32),
        num_cond=num_cond, num_os=num_os, max_words=max_words,
        nw_pos=nw_pos, n_real=n_real)


def seed_dense_inputs(rng, device, *, n=8, L=8192, word_len=7, num_os=64,
                      max_words=54, cap=4096, share=0, repeat=0, empty=2):
    """One seed_dense call's arguments: the payload of `seed_inputs` (its
    lengths, N runs and exceptions, in 256 run and 2048 exception rows) and
    the word lists ow (num_os, max_words) of a `seed_oligo_words` panel of
    num_os - `empty` oligos (two with hits at negative diagonals, `share`
    and `repeat` as it says).  Returns (args, kw) for
    ops/seed.py::seed_dense(*args, **kw), the tensors on `device`."""
    args = seed_inputs(rng, "cpu", n=n, L=L, word_len=word_len, num_os=8,
                       max_words=1, cap=cap)[0]
    codes = np.zeros((n, L), np.uint8)
    packed = args[0].numpy()
    for b in range(4):
        codes[:, b::4] = (packed >> (2 * b)) & 3
    ow = seed_oligo_words(rng, codes, word_len=word_len, num_os=num_os,
                          max_words=max_words, share=share, repeat=repeat,
                          negative=2, empty=min(empty, num_os - 1))
    args = tuple(a.to(device) for a in args[:6]) + (
        torch.from_numpy(ow).to(device),)
    return args, dict(word_len=word_len, num_os=num_os, max_words=max_words,
                      tile_len=L, cap=cap)
