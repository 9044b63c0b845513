# Copy of tntblast_tpu/search/bind.py with the package name changed.
"""Candidate generation: seed matching + melt evaluation + filter cascade.

Mirrors the reference bind_oligo layer (reference: bind_oligo.cpp).  Unique
seed diagonals become fixed windows of oligo_len + 2*NUM_FLANK_BASE target
bases; each window is evaluated by the melt engine (batched over all cache
misses) and passed through the Tm/dG/clamp/mismatch/gap/poly-degen filter
cascade; survivors carry target-coordinate extents and the rendered
alignment.  Per-(oligo, window) results are memoized in per-strand caches
scoped to one target fragment.
"""

import numpy as np

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import native
from tntblast_tpu_torch.search import seed
from tntblast_tpu_torch.utils.listsort import list_sort

F, R, P = 1, 2, 4
PLUS_STRAND, MINUS_STRAND = 8, 16
VALID = 32


class OligoInfo:
    __slots__ = ("loc_5", "loc_3", "tm", "dH", "dS", "anchor_5", "anchor_3",
                 "num_mm", "num_gap", "alignment", "query_loc", "target_loc",
                 "mask")

    def __init__(self, query_loc=0, target_loc=0, mask=0):
        self.loc_5 = 0
        self.loc_3 = 0
        self.tm = -1.0
        self.dH = -1.0
        self.dS = -1.0
        self.anchor_5 = 0
        self.anchor_3 = 0
        self.num_mm = 0
        self.num_gap = 0
        self.alignment = ""
        self.query_loc = query_loc
        self.target_loc = target_loc
        self.mask = mask


def bound_less(a, b):
    """oligo_info::operator< (reference tntblast.h:230-242)."""
    if a.loc_5 != b.loc_5:
        return a.loc_5 < b.loc_5
    if a.loc_3 != b.loc_3:
        return a.loc_3 < b.loc_3
    return a.tm > b.tm


def bound_match_less(a, b):
    """sort_by_bound_match (reference bind_oligo.cpp:49-82)."""
    if a.loc_5 != b.loc_5:
        return a.loc_5 < b.loc_5
    if a.loc_3 != b.loc_3:
        return a.loc_3 < b.loc_3
    if a.tm == b.tm:
        if a.num_mm == b.num_mm:
            return len(a.alignment) > len(b.alignment)
        return a.num_mm > b.num_mm
    return a.tm > b.tm


def match_oligo(info_list, ctx, oligo, mask, minus, filt, conc):
    """match_oligo_to_{minus,plus}_strand: append unique-diagonal seed hits
    (pre-screened on device when a fragment panel ran)."""
    q_off, t_pos = ctx.seeds_for(oligo, minus, filt, conc)
    strand = MINUS_STRAND if minus else PLUS_STRAND
    for q, t in zip(q_off, t_pos):
        info_list.append(OligoInfo(int(q), int(t), mask | strand))


class MeltCaches:
    """Per-fragment memoization of melt evaluations, keyed like the
    reference BindCacheKey: (oligo string, target_start, target_stop)."""

    def __init__(self):
        self.plus = {}
        self.minus = {}


class BindContext:
    """Everything needed to bind oligos against one target fragment."""

    def __init__(self, engine, seq_codes, word_len, caches, defline="",
                 screen=None, panel_seeds=None):
        self.engine = engine
        self.seq = seq_codes          # db codes (uint8) of the fragment
        self.word_len = word_len
        self._frag = None             # lazy host k-mer index (fallback path)
        self.caches = caches
        self.defline = defline
        self.screen = screen          # optional TpuScreen (device DP filter)
        self.panel_seeds = panel_seeds  # slot_key -> (q, t) device seeds

    @property
    def frag(self):
        if self._frag is None:
            self._frag = seed.FragmentIndex(self.seq, self.word_len)
        return self._frag

    def seeds_for(self, oligo, minus, filt, conc):
        """Unique-diagonal seed list for one oligo-strand, in reference
        order.  Uses the device panel's pre-screened seeds when available
        (see parallel/panel.py for the soundness argument)."""
        if self.panel_seeds is not None:
            key = (oligo, bool(minus), float(filt["min_tm"]),
                   float(filt["max_dg"]), float(conc))
            got = self.panel_seeds.get(key)
            if got is not None:
                return got
        codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(),
                                              dtype=np.uint8)]
        q_off, t_pos = seed.find_seeds(self.frag, codes,
                                       complement=not minus)
        return seed.unique_diagonal_seeds(q_off, t_pos)

    def window_codes(self, start, stop, minus):
        w = self.seq[start:stop]
        if minus:
            m = C.DB_TO_MELT_COMPLEMENT[w][::-1]
        else:
            m = C.DB_TO_MELT_PLUS[w]
        return m[m != 255]


def _evaluate_windows(ctx, oligo_codes, keys, minus, strand_conc):
    """Batch-evaluate melt results for a list of (start, stop) windows."""
    n = len(keys)
    queries = [oligo_codes] * n
    targets = [ctx.window_codes(s, e, minus) for (s, e) in keys]
    sc = np.full(n, strand_conc, dtype=np.float32)
    return ctx.engine.eval_batch(native.HETERO, queries, targets, sc)


def _filter_and_fill(values, filt):
    """Apply the reference filter cascade to a cache value; return None if
    the entry is filtered out."""
    v = values
    if not isinstance(v, dict):
        # ScreenStub: the device screen proved this window cannot pass the
        # current filter (coverage was re-checked during the miss pass)
        return None
    if v["tm"] < filt["min_tm"] or v["tm"] > filt["max_tm"]:
        return None
    if v["dg"] < filt["min_dg"] or v["dg"] > filt["max_dg"]:
        return None
    if v["anchor_5"] < filt["clamp_5"] or v["anchor_3"] < filt["clamp_3"]:
        return None
    if v["num_mm"] > filt["max_mm"]:
        return None
    if v["num_gap"] > filt["max_gap"]:
        return None
    if v["max_poly_degen"] > filt["max_poly_degen"]:
        return None
    return v


def _make_cache_value(out, k, stage, target_5=0, target_3=0):
    """Cache entry mirroring the reference's partial-result caching: fields
    beyond the failing filter stage are zeroed."""
    v = {"tm": float(out["tm"][k]), "dg": 0.0, "dH": 0.0, "dS": 0.0,
         "anchor_5": 0, "anchor_3": 0, "target_5": 0, "target_3": 0,
         "num_mm": 0, "num_gap": 0, "max_poly_degen": 0, "align": ""}
    if stage >= 1:
        v["dg"] = float(out["dg"][k])
    if stage >= 2:
        v["anchor_5"] = int(out["anchor5"][k])
    if stage >= 3:
        v["anchor_3"] = int(out["anchor3"][k])
    if stage >= 4:
        v["num_mm"] = int(out["num_mm"][k])
    if stage >= 5:
        v["num_gap"] = int(out["num_gap"][k])
    if stage >= 6:
        v["max_poly_degen"] = int(out["max_degen"][k])
    if stage >= 7:
        v["dH"] = float(out["dH"][k])
        v["dS"] = float(out["dS"][k])
        v["target_5"] = target_5
        v["target_3"] = target_3
        v["align"] = out["align"][k]
    return v


def _compute_stage(out, k, filt):
    """Which filter stage does result k fail at? 7 = passes all."""
    if out["tm"][k] < filt["min_tm"] or out["tm"][k] > filt["max_tm"]:
        return 0
    if out["dg"][k] < filt["min_dg"] or out["dg"][k] > filt["max_dg"]:
        return 1
    if out["anchor5"][k] < filt["clamp_5"]:
        return 2
    if out["anchor3"][k] < filt["clamp_3"]:
        return 3
    if out["num_mm"][k] > filt["max_mm"]:
        return 4
    if out["num_gap"][k] > filt["max_gap"]:
        return 5
    if out["max_degen"][k] > filt["max_poly_degen"]:
        return 6
    return 7


def _window_locs(out, k, start, stop, window, minus):
    """Convert alignment ranges to target plus-strand extents (reference
    bind_oligo.cpp:364-379 minus / 1068-1083 plus)."""
    qr0, qr1 = int(out["q_range"][k][0]), int(out["q_range"][k][1])
    tr0, tr1 = int(out["t_range"][k][0]), int(out["t_range"][k][1])
    if minus:
        t5 = start + (stop - start - 1 - tr1) - qr0
        t3 = start + (stop - start - 1 - tr0) + (window - 1) - qr1
    else:
        t5 = start + tr0 - ((window - 1) - qr1)
        t3 = start + tr1 + qr0
    return t5, t3


def bind_oligo(ctx, info_list, oligo, minus, strand_conc, filt,
               oligo_mask=None, use_cache=True):
    """bind_oligo_to_{minus,plus}_strand.

    With oligo_mask=None: direct-from-seed variant (fresh seed search,
    dedup via oligo_info::operator<; reference bind_oligo.cpp:124-454).
    With oligo_mask set: consume pre-matched entries from info_list (dedup
    via sort_by_bound_match; reference bind_oligo.cpp:456-827/1159-1530).
    Returns the new info_list (the list is replaced/extended like the
    reference mutates its argument).
    """
    window = len(oligo)
    target_length = window + 2 * C.NUM_FLANK_BASE
    seq_size = len(ctx.seq)
    oligo_codes = C.ASCII_TO_MELT[np.frombuffer(oligo.encode(), dtype=np.uint8)]
    cache = (ctx.caches.minus if minus else ctx.caches.plus) if use_cache else {}

    if oligo_mask is None:
        q_off, t_pos = ctx.seeds_for(oligo, minus, filt, strand_conc)
        entries = [OligoInfo(int(q), int(t)) for q, t in zip(q_off, t_pos)]
        keep_rest = []
        direct = True
    else:
        want = oligo_mask | (MINUS_STRAND if minus else PLUS_STRAND)
        curr = []
        keep_rest = []
        for e in info_list:
            if (e.mask & want) == want:
                curr.insert(0, e)   # reference push_front
            else:
                keep_rest.append(e)
        entries = curr
        direct = False

    # Window key per entry + batch evaluation of cache misses
    keys = []
    for e in entries:
        start = max(e.target_loc - (e.query_loc + C.NUM_FLANK_BASE), 0)
        stop = min(start + target_length, seq_size)
        keys.append((start, stop))

    miss, seen = [], set()
    for kk in keys:
        ck = (oligo, kk[0], kk[1])
        v = cache.get(ck)
        if ck in seen:
            continue
        if v is None:
            seen.add(ck)
            miss.append(kk)
        elif not isinstance(v, dict) and not v.covers(filt, strand_conc):
            # ScreenStub proven against a different (stricter-elsewhere)
            # filter: must re-examine under the current one
            seen.add(ck)
            miss.append(kk)

    if miss and ctx.screen is not None:
        win_codes = [ctx.window_codes(s, e, minus) for (s, e) in miss]
        keep, ftm, fdg = ctx.screen.screen_windows(
            oligo_codes, win_codes, filt, strand_conc)
        for k, kk in enumerate(miss):
            if not keep[k]:
                cache[(oligo, kk[0], kk[1])] = ctx.screen.make_stub(
                    filt, strand_conc, ftm[k], fdg[k])
        miss = [kk for k, kk in enumerate(miss) if keep[k]]

    if miss:
        out = _evaluate_windows(ctx, oligo_codes, miss, minus, strand_conc)
        for k, (start, stop) in enumerate(miss):
            stage = _compute_stage(out, k, filt)
            if stage == 7:
                t5, t3 = _window_locs(out, k, start, stop, window, minus)
            else:
                t5 = t3 = 0
            cache[(oligo, start, stop)] = _make_cache_value(out, k, stage, t5, t3)

    survivors = []
    for e, (start, stop) in zip(entries, keys):
        v = _filter_and_fill(cache[(oligo, start, stop)], filt)
        if v is None:
            continue
        e.loc_5 = v["target_5"]
        e.loc_3 = v["target_3"]
        e.tm = v["tm"]
        e.dH = v["dH"]
        e.dS = v["dS"]
        e.anchor_5 = v["anchor_5"]
        e.anchor_3 = v["anchor_3"]
        e.num_mm = v["num_mm"]
        e.num_gap = v["num_gap"]
        e.alignment = v["align"]
        survivors.append(e)

    if direct:
        if not survivors:
            return []
        survivors = list_sort(survivors, bound_less)
    else:
        if not survivors:
            return keep_rest
        survivors = list_sort(survivors, bound_match_less)

    out_list = keep_rest
    out_list.append(survivors[0])
    for s in survivors[1:]:
        last = out_list[-1]
        if not (last.loc_5 == s.loc_5 and last.loc_3 == s.loc_3):
            out_list.append(s)
    return out_list
