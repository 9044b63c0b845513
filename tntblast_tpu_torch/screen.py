# Port of tntblast_tpu/screen.py: the object names its torch device; the
# screening tables are numpy arrays for the panel and cached per device for
# screen_windows.
"""Device-side candidate screening conditions.

The reference evaluates every seeded window with the full DP + co-optimal
enumeration + exact re-scoring cascade (reference bind_oligo.cpp:124-454).
Almost all windows fail the Tm/dG filters; the device pipeline discards them
with one batched device DP before the exact (bit-reproducing) engine ever
sees them.

Correctness argument (so the screened pipeline stays bit-identical):

  A reported hit must satisfy Tm >= min_tm and dG <= max_dg.  With
  Tk = min_tm + 273.15 and Ct the oligo strand concentration,

      Tm >= min_tm  <=>  dG_alignment(Tk) <= Tk * R * ln(Ct)

  (identical algebra to the reference Tm formula, nuc_cruc.cpp:2284-2297).
  The screen runs the DP over a SCREENING table in which every event the
  exact re-scorer (evaluate_alignment) may re-price — loops, bulges,
  terminal swaps — is charged an admissible LOWER bound (0), so the
  screening path energy never overcharges any alignment the re-scorer
  could produce.  The residual slack (per-alignment boundary effects the
  table cannot express: AT-closing, init terms, salt-count rounding) is
  bounded CONSTRUCTIVELY from the parameter tables themselves
  (screen_bound.slack_bound; derivation in docs/screen_bound.md).  Hence
  every window that can produce a hit satisfies

      dp_screen(Tk) - slack <= dG_alignment(Tk) <= Tk*R*ln(Ct)
      dp_screen(T*) - slack <= dG_alignment(T*) <= max_dg

  and a window failing either inequality is provably hit-free and is
  dropped without exact evaluation.  Windows are never dropped on the
  max_tm / min_dg / clamp / mismatch sides (dropping is only ever done on
  conditions every survivor must satisfy).

  NOTE an earlier (rounds 1-3) screen ran over the EXACT dp table with a
  corpus-fitted constant slack (4.0/7.0 kcal/mol); that argument was
  UNSOUND — a mismatch cluster routed through gap pairs overcharges the
  exact-table path linearly in cluster size, so no constant slack exists
  (docs/screen_bound.md records the counterexample).  Do not revive it.
"""

import math

import numpy as np

from tntblast_tpu_torch import constants as C

R_GAS = float(np.float32(1.9872e-3))


def pack_windows(oligo_codes, window_codes, batch):
    """The padded int32 arrays of one DP call over `window_codes` (a list
    of melt-code arrays, already strand-oriented) against one oligo:
    (q_codes (batch, wq), q_len, t_codes (batch, wq + 2 flanks), t_len);
    rows past the windows hold the oligo against an empty target."""
    wq = len(oligo_codes)
    wt = wq + 2 * C.NUM_FLANK_BASE
    qc = np.zeros((batch, wq), dtype=np.int32)
    qc[:] = oligo_codes.astype(np.int32)
    ql = np.full(batch, wq, dtype=np.int32)
    tc = np.zeros((batch, wt), dtype=np.int32)
    tl = np.zeros(batch, dtype=np.int32)
    for i, w in enumerate(window_codes):
        m = min(len(w), wt)
        tc[i, :m] = w[:m]
        tl[i] = m
    return qc, ql, tc, tl


class ScreenStub:
    """Cache sentinel for a screened-out window: records the filter bounds
    the screen proof was run against so later lookups with *weaker* bounds
    trigger exact evaluation instead of reusing the proof."""

    __slots__ = ("min_tm", "max_dg", "conc", "fail_tm", "fail_dg")

    def __init__(self, min_tm, max_dg, conc, fail_tm, fail_dg):
        self.min_tm = min_tm
        self.max_dg = max_dg
        self.conc = conc
        self.fail_tm = fail_tm
        self.fail_dg = fail_dg

    def covers(self, filt, conc):
        if self.fail_tm and conc == self.conc and filt["min_tm"] >= self.min_tm:
            return True
        if self.fail_dg and filt["max_dg"] <= self.max_dg:
            return True
        return False


class TpuScreen:
    """Batched DP screen bound to one native engine's parameter tables.

    The DP runs over the SCREENING table (update_dp_param_screen: event
    charges replaced by admissible lower bounds) and the slack is the
    constructive bound computed from the tables (screen_bound.py) — the
    previous corpus-fitted constants 4.0/7.0 were violated by mismatch
    clusters routed through gap pairs (docs/screen_bound.md)."""

    def __init__(self, engine, dangle=False, min_batch=64, device="cuda"):
        """`device` is where screen_windows runs its DP (a torch device or
        its name; the panel's own tables do not depend on it)."""
        from tntblast_tpu_torch.screen_bound import slack_bound
        self.engine = engine
        self.dangle = dangle
        self.device = device
        # max over the operating range (screening temperatures land in
        # [Tk_min, T*]; the bound is near-constant in T)
        self.slack = max(slack_bound(engine, t, dangle)
                         for t in (273.15, 293.15, 313.15, 333.15,
                                   353.15, 373.15)) + 0.1
        self.min_batch = min_batch
        self._tables = {}   # round(T,4) -> numpy int32 (2401,)
        # round(T,4) -> (flat table, canonical table) on self.device
        self._device_tables = {}
        t = engine._tables
        self._init_H = float(t.param_init_H)
        self._init_S = float(t.param_init_S)
        # canon / full: batches scored by the screen_dp kernel's DP and by
        # dp_max_score (window_scores)
        self.stats = {"screened": 0, "kept": 0, "batches": 0,
                      "canon": 0, "full": 0}

    def _dg_table(self, T):
        key = round(float(T), 4)
        tab = self._tables.get(key)
        if tab is None:
            tab = self.engine.delta_g_screen(
                np.float32(T)).astype(np.int32).reshape(-1)
            self._tables[key] = tab
        return tab

    def _init_dg(self, T):
        return self._init_H - float(T) * self._init_S

    def conditions(self, filt, conc):
        """[(tag, T, min_score)] — a surviving window needs DP score >=
        min_score at every temperature T (int fixed-point, x10000).

        The bound is alignment-agnostic, so it covers --dinkelbach too:
        the Dinkelbach iteration (reference nuc_cruc.cpp:2399-2440) only
        changes WHICH alignment A* of the window gets reported, never the
        evaluator.  The reported Tm/dG still come from evaluate_alignment
        on A*, hence  dG_exact(A*, T) >= path(A*, T) - slack >= dp(T) -
        slack  at every screening temperature T: the same two conditions
        remain necessary for a hit (test_screen_slack_property covers
        adversarial loop/bulge/frayed/dangling alignments at multiple
        temperatures)."""
        conds = []
        if filt["min_tm"] > 0 and conc > 0:
            tk = filt["min_tm"] + 273.15
            bound = tk * R_GAS * math.log(conc) + self.slack
            ms = int(math.ceil((self._init_dg(tk) - bound) * 10000.0))
            if ms > 0:
                conds.append(("tm", tk, ms))
        tstar = float(self.engine.target_T)
        bound = filt["max_dg"] + self.slack
        ms = int(math.ceil((self._init_dg(tstar) - bound) * 10000.0))
        if ms > 0:
            conds.append(("dg", tstar, ms))
        return conds

    def _tables_on_device(self, T):
        """(flat (2401,) table, canonical (30, 30, 7) table) of temperature
        T as int32 tensors on self.device, uploaded once."""
        import torch

        from tntblast_tpu_torch.ops.thermo_dp import build_t_canon

        key = round(float(T), 4)
        tabs = self._device_tables.get(key)
        if tabs is None:
            dg = self._dg_table(T)
            tabs = (torch.from_numpy(dg).to(self.device),
                    torch.from_numpy(build_t_canon(dg)).to(self.device))
            self._device_tables[key] = tabs
        return tabs

    def window_scores(self, oligo_codes, window_codes, temps):
        """The screening DP's best score of every window against the oligo
        at each temperature of `temps`: one int32 tensor per temperature on
        self.device, of the padded batch's length (max(min_batch, next power
        of two); rows past the windows hold the oligo against an empty
        target and score -1).

        The DP runs on self.device and raises when that is a card this
        machine lacks.  A batch whose codes all lie in {A, C, G, T, I} goes
        through dp_scores_canon (on a card the screen_dp kernel, one launch
        a temperature) and counts in stats["canon"]; a batch with a
        degenerate code, or an oligo wider than the kernel takes (windows
        past MAX_WT, 1032 columns: past MAX_SEQUENCE_LENGTH), goes through
        dp_max_score (tensor code) and counts in stats["full"].  Both give
        the same score."""
        import torch

        from tntblast_tpu_torch.ops.screen_dp import MAX_WT
        from tntblast_tpu_torch.ops.thermo_dp import (
            NUM_T5, build_qpair_rows, dp_max_score, dp_scores_canon)

        device = torch.device(self.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but CUDA is not available")

        wq = len(oligo_codes)
        wt = wq + 2 * C.NUM_FLANK_BASE
        n = len(window_codes)
        B = max(self.min_batch, 1 << (n - 1).bit_length())
        qc, ql, tc, tl = pack_windows(oligo_codes, window_codes, B)

        canon = (wt <= MAX_WT and int(qc.max()) < NUM_T5
                 and int(tc.max()) < NUM_T5)
        if canon:
            q_in = np.repeat(
                build_qpair_rows([oligo_codes], [wq], wq=wq), B, axis=0)
        else:
            q_in = qc
        self.stats["canon" if canon else "full"] += 1
        q_d, ql_d, tc_d, tl_d = (torch.from_numpy(a).to(device)
                                 for a in (q_in, ql, tc, tl))
        scores = []
        for T in temps:
            dg, t_canon = self._tables_on_device(T)
            if canon:
                scores.append(dp_scores_canon(q_d, ql_d, tc_d, tl_d, t_canon))
            else:
                scores.append(dp_max_score(q_d, ql_d, tc_d, tl_d, dg,
                                           wq=wq, wt=wt))
        return scores

    def screen_windows(self, oligo_codes, window_codes, filt, conc):
        """(keep, fail_tm, fail_dg) masks over windows.  window_codes: list
        of uint8 melt-code arrays (already strand-oriented).  The scores
        come from window_scores, on self.device."""
        conds = self.conditions(filt, conc)
        n = len(window_codes)
        fail_tm = np.zeros(n, dtype=bool)
        fail_dg = np.zeros(n, dtype=bool)
        if not conds or n == 0:
            return np.ones(n, dtype=bool), fail_tm, fail_dg

        keep = np.ones(n, dtype=bool)
        scores = self.window_scores(oligo_codes, window_codes,
                                    [T for _, T, _ in conds])
        for (tag, _, min_score), score in zip(conds, scores):
            failed = score[:n].cpu().numpy() < min_score
            keep &= ~failed
            # A ScreenStub must only claim the proof that actually fired.
            if tag == "dg":
                fail_dg |= failed
            else:
                fail_tm |= failed
        self.stats["batches"] += 1
        self.stats["kept"] += int(keep.sum())
        self.stats["screened"] += int(n - keep.sum())
        return keep, fail_tm, fail_dg

    def make_stub(self, filt, conc, failed_tm, failed_dg):
        return ScreenStub(filt["min_tm"], filt["max_dg"], conc,
                          fail_tm=bool(failed_tm), fail_dg=bool(failed_dg))
