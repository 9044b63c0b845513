"""Full-fragment device search step in PyTorch.

Port of tntblast_tpu/parallel/device_search.py (flat screen path).  One
step per fragment batch, for all oligos of the panel at once:

  1. payload unpack: 2-bit base stream + N-run prefix sum + exception
     scatter back to fragment codes,
  2. k-mer seeding per fragment (word-table path, or the dense compare
     path for long oligos / heavily shared words); on a card the unpack and
     either path are one hand-written CUDA kernel (ops/seed.py: csrc/seed.cu
     for the table path, which needs no sort; csrc/seed_dense.cu for the
     dense path, which builds no bitmap),
  3. pooling of every fragment's candidates into one slot-major stream in
     the order of a stable sort on slot, invalid entries last (ops/pool.py;
     on a card a hand-written CUDA kernel, a counting sort),
  4. one window decode over the whole pooled stream: slot scalars, window
     codes from the word stream and the host routing (ops/win_decode.py, on
     a card a hand-written CUDA kernel),
  5. per chunk of the stream (`chunk_entries`: as many entries as keep the
     eval condition's M rows within M_ROWS_BYTES; the whole stream at the
     bench shapes): the screening DP at every screening temperature plus
     the eval temperature (ops/screen_dp.py) and the gapless exact
     evaluator with its word packing (ops/eval_pack.py), each a
     hand-written CUDA kernel on a card,
  6. the keep flags, the kept-seed compaction and kmin recomputation into
     one packed int32 header and one (9, bkcap) kept block (ops/kept.py; on
     a card a hand-written CUDA kernel).

The JAX step runs its 32768-entry chunks under lax.cond and skips those
wholly past the pooled candidates; here every kernel covers the stream (or
a chunk of it) in one launch, and the entries past the pool, which the
pool puts last, leave each kernel at once: the same skip, on the card,
without reading the pool size on the host.

Every fixed-size `jnp.nonzero(size=...)` of the JAX step is, in tensor
code, a cumsum + scatter compaction here (`compact`; on a card the kept
compaction is the kept kernel's look-back), and every gather that relied on
JAX's silent index clamping clips explicitly.  The step issues no host sync:
`DevicePanel.submit_fragments` returns as soon as the work is queued on the
device, and the resolve (on another thread) copies back the header and the
used prefix of the kept block.  All work runs on the device's current
stream (the default stream unless the caller set another one), so the
resolve thread's copies are ordered after it.

On a card `DevicePanel.step` replays a CUDA graph of the step, captured on
the first step of its static configuration (parallel/step_graph.py): the
counterpart of the JAX step's jax.jit.  The CPU step, and a step timed by
stage, dispatch the step op by op.
"""

import contextlib
import hashlib

import numpy as np
import torch
from torch.profiler import record_function as _span

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import trace
from tntblast_tpu_torch.ops.eval_gapless import build_slot_eval_arrays
from tntblast_tpu_torch.ops.eval_pack import EvalPackPlan, eval_pack
from tntblast_tpu_torch.ops.kept import INT_MIN, KeptPlan, keep_flags, kept
from tntblast_tpu_torch.ops.pool import PoolPlan, pool
from tntblast_tpu_torch.ops.screen_dp import (
    ScreenDpPlan, kernel_tables, kernel_width, screen_dp)
from tntblast_tpu_torch.ops.seed import (
    DenseSeedPlan, SeedPlan, seed_dense_path, seed_lanes, seed_table_path,
    unpack_fragments)
from tntblast_tpu_torch.ops.thermo_dp import build_qpair_rows, build_t_canon
from tntblast_tpu_torch.ops.win_decode import WinDecodePlan, win_decode
from tntblast_tpu_torch.parallel import step_graph

# the unit of the pooled stream's chunks (entries), the JAX step's chunk
SCREEN_CHUNK = 32768
# the most bytes of eval-condition M rows one chunk of the stream may hold
M_ROWS_BYTES = 2 << 30
# entries a block of the chunk kernels takes (screen_dp.cu DP_THREADS,
# eval_pack.cu's 4 warps of 32, win_decode.cu DECODE_ENTRIES): the unit of a
# chunk shorter than SCREEN_CHUNK
KERNEL_BLOCK = 128

_I32 = torch.int32
_I64 = torch.int64


# copy of tntblast_tpu/parallel/device_search.py:63-99 PanelConfig
class PanelConfig:
    """Static shape configuration for a run."""

    # windows per DP launch: bounds the per-chunk window tensors
    DP_CHUNK = 4096

    def __init__(self, word_len, num_os, max_words, wq_max, tile_len,
                 cap, num_cond, kcap=None):
        self.word_len = int(word_len)
        self.num_os = int(num_os)          # oligo-strand slots (padded)
        self.max_words = int(max_words)    # compacted word-list capacity
        self.wq_max = int(wq_max)
        self.wt = int(wq_max) + 2 * C.NUM_FLANK_BASE
        self.tile_len = int(tile_len)      # fragment buffer length (padded)
        cap = int(cap)
        if cap > self.DP_CHUNK:            # chunked DP needs even division
            cap = -(-cap // self.DP_CHUNK) * self.DP_CHUNK
        self.cap = cap                     # candidate capacity per fragment
        # per-fragment capacity of the device-compacted KEPT-seed list
        # (scaled by the batch size and pooled); callers with screening
        # disabled pass kcap=cap
        self.kcap = int(kcap) if kcap is not None else max(
            (3 * cap) // 4, 512)
        self.kcap = min(self.kcap, cap)
        self.num_cond = int(num_cond)

    def batch_kcap(self, n_frags):
        if self.kcap:
            return min(self.kcap * n_frags, n_frags * self.cap)
        return n_frags * self.cap

    def key(self):
        return (self.word_len, self.num_os, self.max_words, self.wq_max,
                self.tile_len, self.cap, self.num_cond, self.kcap)


def _timed_span(timer):
    """_span with `timer`'s span of the same name inside it (an object whose
    `span(name)` is a context manager, tools/device_bench.py StageTimer)."""
    @contextlib.contextmanager
    def span(name):
        with _span(name), timer.span(name):
            yield
    return span


def seed_fragments(frags, frag_lens, oligo_words, w_table, *, word_len,
                   num_os, max_words, tile_len, cap, s_max=1, k_max=1):
    """Seeding + compaction for a batch of fragments (the JAX
    _seed_fragment under its fragment vmap), as tensor code.

    frags (n, L) uint8 codes, frag_lens (n,) int32; w_table is the
    (4^w, num_os) word -> per-slot k-bitmask table (the table path,
    ops/seed.py::seed_table_path; on a card the panel's SeedPlan runs it as
    a kernel instead), or a (1, num_os) dummy that selects the dense
    compare path (ops/seed.py::seed_dense_path; on a card the panel's
    DenseSeedPlan runs it as a kernel instead).

    Returns (slot, p, n_cand, counts, overflow, word, word_valid):
      slot/p (n, cap) int32 compacted ((diagonal, slot) lexicographic),
      n_cand (n,) int32 true candidate counts, counts (n, num_os) int32,
      overflow (n,) bool, word/word_valid (n, nw_pos) target words.
    """
    if w_table.shape[0] > 1:
        return seed_table_path(
            frags, frag_lens, w_table, word_len=word_len, num_os=num_os,
            max_words=max_words, tile_len=tile_len, cap=cap, s_max=s_max,
            k_max=k_max)
    return seed_dense_path(frags, frag_lens, oligo_words, word_len=word_len,
                           num_os=num_os, max_words=max_words,
                           tile_len=tile_len, cap=cap)


def slot_tables(slot_meta, num_os, wq_max, thresholds, device):
    """Per-slot tables indexed by slot id in [0, num_os]; ids >= n_real hold
    the JAX select-chain defaults (ql 1, plus strand, threshold off, zero
    query codes)."""
    n_real = len(slot_meta)
    ql = np.ones(num_os + 1, np.int32)
    minus = np.zeros(num_os + 1, bool)
    qp = np.zeros((max(n_real, 1), wq_max), np.int32)
    qc = np.zeros((num_os + 1, wq_max), np.int32)
    for s, m in enumerate(slot_meta):
        ql[s] = m[0]
        minus[s] = m[1]
        qp[s, :m[0]] = m[2]
        qc[s, :m[0]] = m[4]
    thr = np.full((thresholds.shape[0], num_os + 1), INT_MIN, np.int32)
    thr[:, :thresholds.shape[1]] = thresholds

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"ql": t(ql), "minus": t(minus), "qp": t(qp[:n_real]),
            "qc": t(qc), "thr": t(thr)}


def chunk_entries(Bp, wq_max, wt_max):
    """Entries of one chunk of a pooled stream of Bp entries: whole
    SCREEN_CHUNKs, as many as keep the eval condition's M rows
    (wq_max x (wt_max + 1) int32 an entry) within M_ROWS_BYTES, and never
    more than the stream.  Where one SCREEN_CHUNK holds more than that (long
    oligos: at wq_max 1024 it would be 138 GB), whole blocks of
    KERNEL_BLOCK entries, as many as fit and at least one.  Static shapes
    alone decide it, so the step needs no host sync; the outputs do not
    depend on it."""
    per_entry = wq_max * (wt_max + 1) * 4
    units = M_ROWS_BYTES // (SCREEN_CHUNK * per_entry)
    if units >= 1:
        return min(SCREEN_CHUNK * units, Bp)
    blocks = max(1, M_ROWS_BYTES // per_entry // KERNEL_BLOCK)
    return min(KERNEL_BLOCK * blocks, Bp)


def chunk_starts(Bp, wq_max, wt_max):
    """The first entry of each screen_dp / eval_pack chunk of a pooled
    stream of Bp entries, as a range whose step is the chunk's length
    (chunk_entries); its len is the step's chunk count."""
    return range(0, Bp, chunk_entries(Bp, wq_max, wt_max))


class FragmentKept(dict):
    """A fast resolve's result for one fragment: `counts` (each slot's
    candidates before the screen), `n_kept`, `overflow`, `slot_overflow`,
    and the batch's kept block `kept` (9, m) int32 with `runs` (n_real, 2),
    the [start, end) in it of each slot's kept entries of this fragment.
    The fragment's own arrays `os_k`, `p_k`, `kmin_k` and `eval` (None
    without the evaluator), in block order, are built from the runs when
    asked for (tests; a result edited by hand), never on the search path."""

    ARRAYS = ("os_k", "p_k", "kmin_k", "eval")

    def __init__(self, eval_on, **fields):
        super().__init__(**fields)
        self.eval_on = eval_on

    def __missing__(self, key):
        if key not in self.ARRAYS:
            raise KeyError(key)
        runs = self["runs"]
        idx = np.concatenate(
            [np.arange(a, b) for a, b in runs] + [np.zeros(0, np.int64)])
        block = self["kept"][:, idx]
        if key == "eval":
            return block[4:9] if self.eval_on else None
        return block[self.ARRAYS.index(key) + 1]

    def fields(self):
        """The fragment's result in the JAX panel's layout: its arrays,
        counts, n_kept, slot_overflow and overflow (tests compare it)."""
        return {k: self[k] for k in self.ARRAYS + (
            "counts", "n_kept", "slot_overflow", "overflow")}


def kept_runs(res):
    """(kept block, runs) of one fragment's fast resolve result.  Where its
    arrays `os_k`, `p_k`, `kmin_k` and `eval` were set by hand (in slot
    order, as FragmentKept gives them), they are the fragment's kept
    entries: a block of its own, one run a slot."""
    if "os_k" not in res:
        return res["kept"], res["runs"]
    os_k = np.asarray(res["os_k"], np.int64)
    ev = res.get("eval")
    rows = [np.zeros_like(os_k), os_k, res["p_k"], res["kmin_k"]]
    rows += list(ev) if ev is not None else [np.zeros_like(os_k)] * 5
    kept = np.ascontiguousarray(np.stack(rows), dtype=np.int32)
    sizes = np.bincount(os_k, minlength=len(res["counts"]))
    ends = np.cumsum(sizes)
    return kept, np.stack([ends - sizes, ends], axis=1)


def panel_step_core(payload, tabs, *, eval_const, word_len, num_os,
                    max_words, wq_max, tile_len, cap, kcap, num_cond,
                    n_frags, s_max=1, k_max=1, eval_on=False, full=False,
                    timer=None):
    """Device step: seeds + screening DP + gapless eval for a batch.

    payload: (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c,
      input_over) tensors on the device (DevicePanel._pack_host)
    tabs: DevicePanel device tables (ow, w_tab, tc_all, tc_kernel, slot tables,
      ev_tabs, ev_loop; on a card seed_plan, the SeedPlan the step's
      seeding goes through on the table path, or seed_dense_plan, the
      DenseSeedPlan it goes through on the dense path, pool_plan, the
      PoolPlan of the pooling, decode_plan, the
      WinDecodePlan the step's decode goes through, screen_plan, the
      ScreenDpPlan each chunk's screen DP goes through, with the evaluator
      eval_plan, the EvalPackPlan each chunk's evaluation goes through, and
      kept_plan, the KeptPlan of the kept-seed compaction)

    timer: optional stage timer; its spans carry the stage names tnt.seed,
      tnt.pool, tnt.decode (once a step), tnt.screen_dp, tnt.eval (once a
      chunk), tnt.compact

    Returns (header, kept_block, slot, p, keep, needs_host, valid), the
    layout of the JAX panel_step_core (see its docstring).
    """
    (frags_packed, frag_lens, nrun_s, nrun_e, exc_p, exc_c,
     input_over) = payload
    n = n_frags
    L = tile_len
    nw_pos = L - word_len + 1
    bkcap = min(kcap * n, n * cap) if kcap else n * cap
    wt_max = wq_max + 2 * C.NUM_FLANK_BASE
    dev = frags_packed.device
    st = tabs["slots"]
    # without a timer the stages are the profiler spans alone
    stage = _span if timer is None else _timed_span(timer)

    seeder = tabs.get("seed_plan", tabs.get("seed_dense_plan"))
    with stage("tnt.seed"):
        if seeder is not None:       # on a card: a kernel of either path
            (slot, p, n_cand, counts, overflow, word,
             word_valid) = seeder(frags_packed, frag_lens, nrun_s, nrun_e,
                                  exc_p, exc_c)
        else:
            frags = unpack_fragments(frags_packed, frag_lens, nrun_s,
                                     nrun_e, exc_p, exc_c, L)
            (slot, p, n_cand, counts, overflow, word,
             word_valid) = seed_fragments(
                frags, frag_lens, tabs["ow"], tabs["w_tab"],
                word_len=word_len, num_os=num_os, max_words=max_words,
                tile_len=tile_len, cap=cap, s_max=s_max, k_max=k_max)

    # --- pooled candidate stream, slot-major (on a card, a counting sort)
    pooler = tabs.get("pool_plan")
    with stage("tnt.pool"):
        Bp = n * cap
        slot_str, p_str, frag_str, order_str, valid = (
            pooler(slot, p, n_cand) if pooler is not None
            else pool(slot, p, n_cand, num_os=num_os))

    word_f = word.reshape(-1)
    word_valid_f = word_valid.reshape(-1)
    # --- one decode over the stream; entries past the pool get zeros -----
    decode = tabs.get("decode_plan")
    with stage("tnt.decode"):
        dargs = (slot_str, p_str, frag_str, frag_lens, word_f, word_valid_f)
        needs_host, tb5, ptb, ql, wt_e, ent_valid = (
            decode(*dargs) if decode is not None else win_decode(
                *dargs, st["ql"], st["minus"], n=n, L=L, wt_max=wt_max,
                word_len=word_len, nw_pos=nw_pos, num_os=num_os))

    # --- the screen DP and the evaluator, a chunk of the stream a launch -
    screen = tabs.get("screen_plan")
    plan = tabs.get("eval_plan")
    keeper = tabs.get("kept_plan")
    starts = chunk_starts(Bp, wq_max, wt_max)
    CH = starts.step
    best_parts, ev_parts = [], []
    for c0 in starts:
        chunk = (ptb[c0:c0 + CH], slot_str[c0:c0 + CH], ql[c0:c0 + CH],
                 wt_e[c0:c0 + CH])
        with stage("tnt.screen_dp"):
            best, mgmax, M_rows = (screen(*chunk) if screen is not None
                                   else screen_dp(
                                       *chunk, st["qp"], tabs["tc_all"],
                                       eval_on=eval_on,
                                       tables=tabs["tc_kernel"]))
        best_parts.append(best)
        if eval_on:
            with stage("tnt.eval"):
                ev_chunk = (M_rows, mgmax, tb5[c0:c0 + CH], *chunk[1:],
                            needs_host[c0:c0 + CH], ent_valid[c0:c0 + CH])
                ev_parts.append(plan(*ev_chunk) if plan is not None
                                else eval_pack(*ev_chunk, st["qc"],
                                               tabs["ev_tabs"],
                                               tabs["ev_loop"], eval_const))
    best = best_parts[0] if len(best_parts) == 1 else torch.cat(best_parts, 1)
    ev_all = (None if not eval_on else ev_parts[0] if len(ev_parts) == 1
              else torch.cat(ev_parts))

    # --- keep flags, kept-seed compaction + kmin recomputation -----------
    with stage("tnt.compact"):
        kargs = (slot_str, p_str, frag_str, order_str, needs_host, ent_valid,
                 ev_all, word_f, word_valid_f)
        fargs = (overflow, input_over, n_cand, counts)
        header, kept_block = (
            keeper(best, *kargs, *fargs, bkcap=bkcap)
            if keeper is not None else kept(
                best, *kargs, tabs["ow"], st["thr"], *fargs,
                num_cond=num_cond, num_os=num_os, max_words=max_words,
                nw_pos=nw_pos, bkcap=bkcap))

    if full:
        # pool-order keep/needs_host (tests), as tensor code: scatter
        # through the pool's order (a fill by a scalar: an indexed store of
        # True would copy a host tensor, which a CUDA graph's capture
        # refuses)
        keep_all = keep_flags(best, slot_str, needs_host, ent_valid,
                              st["thr"], num_cond=num_cond, num_os=num_os)

        def to_pool(flag):
            out = torch.zeros(Bp + 1, dtype=torch.bool, device=dev)
            out.index_fill_(0, torch.where(flag, order_str, Bp).long(), True)
            return out[:Bp].reshape(n, cap)
        keep_out = to_pool(keep_all)
        nh_out = to_pool(needs_host)
    else:
        keep_out = torch.zeros((n, cap), dtype=torch.bool, device=dev)
        nh_out = torch.zeros((n, cap), dtype=torch.bool, device=dev)

    return header, kept_block, slot, p, keep_out, nh_out, valid


class DevicePanel:
    """Host-side wrapper: packs an oligo panel once, runs fragment batches
    on `device`."""

    # host->device payload sideband capacities (see _pack_host)
    RUN_CAP = 256          # N-run capacity per fragment
    EXC_CAP = 2048         # scattered exception capacity per fragment

    def __init__(self, panel, config, dg_tables, thresholds, eval_dg=None,
                 thermo_tables=None, *, device):
        """panel: list of dicts with keys words (int64[], compacted, scan
             order), codes (uint8[] melt), minus (bool)
           dg_tables: (num_cond, 2401) int32
           thresholds: (num_cond, len(panel)) int32 (INT_MIN = off)
           eval_dg/thermo_tables: delta_g at the engine temperature and the
             santa_lucia parameter set — enable the gapless evaluator
        """
        with trace.span("panel.device_panel"):
            self._build(panel, config, dg_tables, thresholds, eval_dg,
                        thermo_tables, device)

    def _build(self, panel, config, dg_tables, thresholds, eval_dg,
               thermo_tables, device):
        # copy of tntblast_tpu/parallel/device_search.py:965-1035 (the
        # panel table build)
        cfg = config
        eval_on = eval_dg is not None and thermo_tables is not None
        ow = np.full((cfg.num_os, cfg.max_words), -1, dtype=np.int32)
        meta = []
        ev_tabs = np.zeros((cfg.num_os, cfg.wq_max, 25, 4),
                           dtype=np.float32)
        ev_loop = np.zeros((cfg.num_os, cfg.wq_max + 2), dtype=np.float32)
        eval_const = (0.0, 0.0, 0.0, 0.0)
        for i, o in enumerate(panel):
            nw = len(o["words"])
            ow[i, :nw] = o["words"]
            codes = np.asarray(o["codes"], dtype=np.int64)
            qpr = build_qpair_rows(codes[None, :], [len(codes)],
                                   wq=len(codes))[0]
            meta.append((int(len(codes)), bool(o["minus"]),
                         tuple(int(v) for v in qpr), nw,
                         tuple(int(v) for v in codes)))
            if eval_on:
                tabs = build_slot_eval_arrays(codes, thermo_tables)
                ql = len(codes)
                ev_tabs[i, :ql, :, 0] = tabs["Hstk"]
                ev_tabs[i, :ql, :, 1] = tabs["Sstk"]
                ev_tabs[i, :ql, :, 2] = tabs["Hlt"]
                ev_tabs[i, :ql, :, 3] = tabs["Slt"]
                ev_loop[i, :ql + 1] = tabs["loop2m"]
                eval_const = (float(tabs["AT_H"]), float(tabs["AT_S"]),
                              float(tabs["init_H"]), float(tabs["init_S"]))
        thr = np.full((cfg.num_cond, cfg.num_os), INT_MIN, dtype=np.int32)
        thr[:, :len(panel)] = thresholds
        tcan = np.stack([build_t_canon(dg_tables[c])
                         for c in range(cfg.num_cond)])
        tcan_eval = (build_t_canon(eval_dg) if eval_on
                     else np.zeros((30, 30, 7), np.int32))
        # word -> per-slot k-bitmask lookup (fast seeding path); gated by
        # table size, bitmask width, and the extraction lane product, with
        # a (1, num_os) dummy that selects the dense compare path
        tw = 4 ** cfg.word_len
        s_max = k_max = 1
        if tw * cfg.num_os <= (16 << 20) and cfg.max_words <= 31:
            w_tab = np.zeros((tw, cfg.num_os), np.int32)
            for i, o in enumerate(panel):
                for k, v in enumerate(o["words"]):
                    w_tab[int(v), i] |= (1 << k)
            s_, k_ = seed_lanes(w_tab)
            if s_ * k_ <= 8:
                s_max, k_max = s_, k_
            else:
                w_tab = np.zeros((1, cfg.num_os), np.int32)
        else:
            w_tab = np.zeros((1, cfg.num_os), np.int32)
        self._setup(cfg, tuple(meta), eval_const, s_max, k_max,
                    (ow, w_tab, tcan, thr, tcan_eval, ev_tabs, ev_loop),
                    device, eval_on)

    @classmethod
    def from_tables(cls, config, slot_meta, eval_const, s_max, k_max,
                    tables, device, *, eval_on):
        """A panel from already-built tables: slot_meta/eval_const/s_max/
        k_max and the seven arrays (ow, w_tab, tcan, thr, tcan_eval,
        ev_tabs, ev_loop) of a JAX DevicePanel."""
        self = cls.__new__(cls)
        self._setup(config, tuple(slot_meta), tuple(eval_const), s_max,
                    k_max, tuple(np.asarray(a) for a in tables), device,
                    eval_on)
        return self

    def _setup(self, cfg, slot_meta, eval_const, s_max, k_max, tables,
               device, eval_on):
        self.config = cfg
        self.slot_meta = slot_meta
        self.eval_const = eval_const
        self.s_max = int(s_max)
        self.k_max = int(k_max)
        self.n_real = len(slot_meta)
        self.eval_on = bool(eval_on)
        self.device = torch.device(device)
        self.host_tables = tables
        self._digest = None
        self.tabs = self._tables_on(self.device)

    def table_digest(self):
        """sha1 of the seven host tables (their dtypes, shapes and bytes),
        as the JAX package's register_panel_tables digests them."""
        if self._digest is None:
            h = hashlib.sha1()
            for a in self.host_tables:
                a = np.ascontiguousarray(a)
                h.update(f"{a.dtype}{a.shape}".encode())
                h.update(a.tobytes())
            self._digest = h.hexdigest()
        return self._digest

    def graph_key(self, n_frags, full, device=None):
        """The key of the step's CUDA graph (parallel/step_graph.py), as the
        JAX step's jit cache keys its program: everything static in the
        step, the digest of the tables and the card."""
        return (self.config.key(), self.slot_meta, self.eval_const,
                int(n_frags), self.s_max, self.k_max, self.eval_on,
                bool(full), self.table_digest(),
                step_graph.card(self.device if device is None else device))

    def _tables_on(self, device):
        """The panel's device tables, uploaded to `device`."""
        cfg = self.config
        ow, w_tab, tcan, thr, tcan_eval, ev_tabs, ev_loop = self.host_tables
        tc_all = (np.concatenate([tcan, tcan_eval[None]], axis=0)
                  if self.eval_on else tcan)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        tc_all = t(tc_all)
        tabs = {
            "ow": t(ow), "w_tab": t(w_tab), "tc_all": tc_all,
            # the tables as the screen kernel reads them, re-laid once here
            "tc_kernel": kernel_tables(tc_all),
            "ev_tabs": t(ev_tabs), "ev_loop": t(ev_loop),
            "slots": slot_tables(self.slot_meta, cfg.num_os, cfg.wq_max,
                                 np.asarray(thr), device),
        }
        # on a card the kernels' lean calls, their tables checked once here
        if torch.device(device).type == "cuda":
            if w_tab.shape[0] > 1:       # the table path: the seed kernel
                tabs["seed_plan"] = SeedPlan.from_table(
                    w_tab, device, L=cfg.tile_len, word_len=cfg.word_len,
                    num_os=cfg.num_os, max_words=cfg.max_words, cap=cfg.cap,
                    s_max=self.s_max, k_max=self.k_max)
            else:                        # the dense path: its own kernel
                tabs["seed_dense_plan"] = DenseSeedPlan(
                    tabs["ow"], L=cfg.tile_len, word_len=cfg.word_len,
                    num_os=cfg.num_os, max_words=cfg.max_words, cap=cfg.cap)
            tabs["decode_plan"] = WinDecodePlan(
                tabs["slots"]["ql"], tabs["slots"]["minus"], L=cfg.tile_len,
                wt_max=cfg.wt, word_len=cfg.word_len,
                nw_pos=cfg.tile_len - cfg.word_len + 1, num_os=cfg.num_os)
            tabs["pool_plan"] = PoolPlan(tabs["ow"].device,
                                         num_os=cfg.num_os, cap=cfg.cap)
            tabs["screen_plan"] = ScreenDpPlan(
                tabs["slots"]["qp"], tc_all, eval_on=self.eval_on,
                tables=tabs["tc_kernel"])
            if self.eval_on:
                tabs["eval_plan"] = EvalPackPlan(
                    tabs["slots"]["qc"], tabs["ev_tabs"], tabs["ev_loop"],
                    self.eval_const)
            tabs["kept_plan"] = KeptPlan(
                tabs["ow"], tabs["slots"]["thr"],
                nw_pos=cfg.tile_len - cfg.word_len + 1)
        return tabs

    def _pack_host(self, frag_code_list):
        # copy of tntblast_tpu/parallel/device_search.py:1067-1108
        # (DevicePanel._pack_host): 2-bit base stream + N-run / exception
        # sideband; an overflowing sideband flags the fragment for the host
        cfg = self.config
        n = len(frag_code_list)
        L = cfg.tile_len
        packed = np.zeros((n, L // 4), dtype=np.uint8)
        lens = np.zeros(n, dtype=np.int32)
        run_s = np.full((n, self.RUN_CAP), L, dtype=np.int32)
        run_e = np.full((n, self.RUN_CAP), L, dtype=np.int32)
        exc_p = np.full((n, self.EXC_CAP), L, dtype=np.int32)
        exc_c = np.zeros((n, self.EXC_CAP), dtype=np.uint8)
        in_over = np.zeros(n, dtype=bool)
        for i, fc in enumerate(frag_code_list):
            if len(fc) > L:
                raise ValueError("fragment exceeds tile_len")
            lens[i] = len(fc)
            buf = np.zeros(L, dtype=np.uint8)
            buf[:len(fc)] = fc
            two = (buf & 3).astype(np.uint8)
            packed[i] = (two[0::4] | (two[1::4] << 2) | (two[2::4] << 4)
                         | (two[3::4] << 6))
            odd = np.flatnonzero(buf[:len(fc)] > C.DB_MAX_ATGC)
            if odd.size == 0:
                continue
            is_n = buf[odd] == C.DB_N
            npos = odd[is_n]
            rest = odd[~is_n]
            # N positions -> maximal runs
            if npos.size:
                brk = np.flatnonzero(np.diff(npos) > 1)
                starts = np.concatenate([[npos[0]], npos[brk + 1]])
                ends = np.concatenate([npos[brk] + 1, [npos[-1] + 1]])
                if len(starts) > self.RUN_CAP:
                    in_over[i] = True
                    continue
                run_s[i, :len(starts)] = starts
                run_e[i, :len(starts)] = ends
            if rest.size > self.EXC_CAP:
                in_over[i] = True
                continue
            exc_p[i, :rest.size] = rest
            exc_c[i, :rest.size] = buf[rest]
        return packed, lens, run_s, run_e, exc_p, exc_c, in_over

    @staticmethod
    def _upload(a, device):
        """Host array -> device tensor without a host sync: on CUDA the
        copy is staged through pinned memory and queued on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def step(self, payload, full=False, device=None, tabs=None, timer=None):
        """Queue the device step on a host payload (numpy arrays); on the
        panel's own device and tables unless a replica's are given.  On a
        card the step replays its CUDA graph (parallel/step_graph.py: with
        `full` False it hands back header and kept_block, None for the
        other five outputs); panel_step_core dispatches it op by op on the
        CPU and with a `timer` (as in panel_step_core: its spans need the
        ops)."""
        device = self.device if device is None else torch.device(device)
        tabs = self.tabs if tabs is None else tabs
        if device.type == "cuda" and timer is None:
            return step_graph.run(self, payload, full, device, tabs)
        dev_payload = tuple(self._upload(a, device) for a in payload)
        return self.step_core(dev_payload, tabs, len(payload[0]), full,
                              timer)

    def step_core(self, dev_payload, tabs, n_frags, full, timer=None):
        """panel_step_core on a payload already on the device."""
        cfg = self.config
        return panel_step_core(
            dev_payload, tabs, eval_const=self.eval_const,
            word_len=cfg.word_len, num_os=cfg.num_os,
            max_words=cfg.max_words, wq_max=cfg.wq_max,
            tile_len=cfg.tile_len, cap=cfg.cap, kcap=cfg.kcap,
            num_cond=cfg.num_cond, n_frags=n_frags,
            s_max=self.s_max, k_max=self.k_max, eval_on=self.eval_on,
            full=full, timer=timer)

    def screen_chunks(self, n_frags):
        """(chunks, route) of a step of `n_frags` fragments: the screen_dp
        launches it queues (chunk_starts over the pooled stream) and the
        route they take, "reg" (a register width) or "strip" (windows past
        the widest, ops/screen_dp.py::kernel_width)."""
        cfg = self.config
        chunks = len(chunk_starts(n_frags * cfg.cap, cfg.wq_max, cfg.wt))
        return chunks, "reg" if kernel_width(cfg.wt) else "strip"

    def submit_fragments(self, frag_code_list, full=False, payload=None):
        """Queue ONE device step covering all fragments in the list
        (asynchronous); resolve with `resolve_fragments`.  `payload` is
        their `_pack_host` payload where the caller packed it once for
        every panel group of the batch (the groups' panels of one tile
        pack alike; a step only reads it)."""
        n = len(frag_code_list)
        if payload is None:
            payload = self._pack_host(frag_code_list)
        return n, self.step(payload, full=full)

    def run_fragments(self, frag_code_list):
        """Submit and fully resolve one batch (tests)."""
        return self.resolve_fragments_full(
            self.submit_fragments(frag_code_list, full=True))

    def _unpack_header(self, n, header):
        cfg = self.config
        n_kept = int(header[0])
        o = 1
        overflow = header[o:o + n] != 0
        o += n
        slot_over = header[o:o + cfg.num_os] != 0
        o += cfg.num_os
        n_cand = header[o:o + n]
        o += n
        counts = header[o:o + n * cfg.num_os].reshape(n, cfg.num_os)
        return n_kept, overflow, slot_over, n_cand, counts

    def resolve_fragments(self, pending):
        """Fast resolve: the header, then only the used prefix of the kept
        block, cross to the host; the candidate arrays stay on the device.
        The block is slot-major and fragment-major within a slot (the
        pool's stable order by slot, ops/pool.py, kept in stream order,
        ops/kept.py), so the kept entries of each (slot, fragment) are one
        contiguous run: one bincount over slot * n + fragment and a cumsum
        give every run's bounds.  Each fragment's `FragmentKept` holds the
        batch's block (shared, read-only) and its own runs."""
        n, out = pending
        cfg = self.config
        header = out[0].cpu().numpy()
        (n_kept, overflow, slot_over, n_cand,
         counts) = self._unpack_header(n, header)
        bkcap = cfg.batch_kcap(n)
        m = min(n_kept, bkcap)
        kept = np.ascontiguousarray(out[1][:, :m].cpu().numpy())
        sizes = np.bincount(kept[1].astype(np.int64) * n + kept[0] // cfg.cap,
                            minlength=cfg.num_os * n).reshape(cfg.num_os, n)
        ends = np.cumsum(sizes, axis=None).reshape(cfg.num_os, n)
        # runs[f, s] = [start, end) of slot s's kept entries of fragment f
        runs = np.ascontiguousarray(
            np.stack([ends - sizes, ends], axis=-1).transpose(1, 0, 2))
        n_frag = sizes.sum(axis=0)
        kept_over = n_kept > bkcap
        nr = self.n_real
        return [FragmentKept(
            self.eval_on, counts=counts[i][:nr], n_kept=int(n_frag[i]),
            slot_overflow=slot_over[:nr],
            overflow=bool(overflow[i]) or kept_over,
            kept=kept, runs=runs[i, :nr]) for i in range(n)]

    def resolve_fragments_full(self, pending):
        """Full resolve (tests): every candidate with its keep/needs_host
        verdict; requires a submit with full=True.  kmin is materialized
        for KEPT candidates only (screened-out rows report 0)."""
        n, out = pending
        cfg = self.config
        header = out[0].cpu().numpy()
        (n_kept, overflow, slot_over, n_cand,
         counts) = self._unpack_header(n, header)
        slot, p, keep, needs_host, valid = (o.cpu().numpy()
                                            for o in out[2:7])
        kmin_full = np.zeros((n, cfg.cap), dtype=np.int32)
        m = min(n_kept, cfg.batch_kcap(n))
        kept = out[1][:, :m].cpu().numpy()
        kmin_full[kept[0] // cfg.cap, kept[0] % cfg.cap] = kept[3]
        results = []
        for i in range(n):
            mm = int(n_cand[i])
            results.append({
                "os_idx": slot[i][:mm], "p": p[i][:mm],
                "kmin": kmin_full[i][:mm],
                "keep": keep[i][:mm], "needs_host": needs_host[i][:mm],
                "counts": counts[i][:self.n_real],
                "slot_overflow": slot_over[:self.n_real],
                "overflow": bool(overflow[i]),
            })
        return results

    # copy of tntblast_tpu/parallel/device_search.py:1195-1207: the
    # single-fragment interface, thin wrappers over the batched methods
    def submit_fragment(self, frag_codes, full=False):
        """Single-fragment convenience wrapper (async)."""
        return self.submit_fragments([frag_codes], full=full)

    def resolve_fragment(self, pending):
        return self.resolve_fragments_full(pending)[0]

    def resolve_fragment_fast(self, pending):
        return self.resolve_fragments(pending)[0]

    def run_fragment(self, frag_codes):
        return self.resolve_fragment(self.submit_fragment(frag_codes,
                                                          full=True))
