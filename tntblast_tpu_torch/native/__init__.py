# Port of tntblast_tpu/native/__init__.py: the same bindings; the library is
# built into the package's _build/ directory through a private temporary file.
"""ctypes bindings for the native melt engine.

The shared library is built on first use (g++ is part of the toolchain) into
``tntblast_tpu_torch/_build/``; rebuilds happen automatically when a source
is newer than the binary.
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile

import numpy as np

from tntblast_tpu_torch.thermo import build_tables

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "frag_search.cpp")   # #includes melt_engine.cpp
_SRC_MELT = os.path.join(_HERE, "melt_engine.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD_DIR, "libtntmelt.so")

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _build():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build to a private file and rename: processes that reach the first
    # build together never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-std=c++14", "-shared", "-fPIC", "-pthread",
        # No -ffast-math: float semantics must be IEEE to match the
        # reference numerics bit-for-bit. (-march=native measured slower
        # than plain -O3 on the CPU the engine was tuned on — AVX512
        # downclocking/I-cache bloat.)
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _stale():
    return (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC_MELT))


def _load():
    if _stale():
        # one build at a time: processes that start together (parallel
        # test workers) wait for the first build instead of each compiling
        os.makedirs(_BUILD_DIR, exist_ok=True)
        with open(os.path.join(_BUILD_DIR, "libtntmelt.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _stale():
                _build()
    lib = ctypes.CDLL(_LIB)

    lib.tnt_engine_create.restype = ctypes.c_void_p
    lib.tnt_engine_create.argtypes = (
        [_f32p] * 11 + [ctypes.c_char_p, _f32p, _f32p, _f32p, _u8p]
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_int, ctypes.c_int])
    lib.tnt_engine_destroy.argtypes = [ctypes.c_void_p]
    lib.tnt_engine_delta_g.argtypes = [ctypes.c_void_p, ctypes.c_float, _i32p]
    lib.tnt_engine_delta_g_screen.argtypes = [
        ctypes.c_void_p, ctypes.c_float, _i32p]
    lib.tnt_engine_set_screen_slack.argtypes = [
        ctypes.c_void_p, ctypes.c_float]

    lib.tnt_eval_batch.restype = ctypes.c_int64
    lib.tnt_eval_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        _u8p, _i64p, _i32p,          # queries
        _u8p, _i64p, _i32p,          # targets
        _f32p,                       # strand conc
        _f32p, _f32p, _f32p, _f32p, _f32p,   # tm dH dS dg dp_dg
        _i32p, _i32p,                # anchors
        _i32p, _i32p, _i32p,         # num_mm num_gap max_degen
        _i32p, _i32p,                # q_range t_range
        _u8p,                        # valid
        ctypes.c_char_p, _i64p, ctypes.c_int64,  # align buf
        ctypes.c_int,
    ]

    lib.tnt_eval_alignment.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        _u8p, _u8p, _i64p, _i32p, _f32p,
        _f32p, _f32p, _f32p, _u8p,
    ]

    lib.tnt_frag_create.restype = ctypes.c_void_p
    lib.tnt_frag_create.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, ctypes.c_int]
    lib.tnt_frag_destroy.argtypes = [ctypes.c_void_p]
    lib.tnt_frag_search.restype = ctypes.c_int64
    lib.tnt_frag_search.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        _u8p, ctypes.c_int, _u8p, ctypes.c_int, _u8p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _f32p, _f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tnt_frag_align_bytes.restype = ctypes.c_int64
    lib.tnt_frag_align_bytes.argtypes = [ctypes.c_void_p]
    lib.tnt_frag_fetch.argtypes = [
        ctypes.c_void_p, _i32p, _f32p, ctypes.c_char_p, _i64p]
    lib.tnt_frag_candidates.restype = ctypes.c_int64
    lib.tnt_frag_candidates.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _i32p, _u8p, _u8p, ctypes.c_int64]
    lib.tnt_frag_set_verdicts.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _i32p, _u8p, ctypes.c_int64]
    lib.tnt_frag_set_seeds.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        _i32p, _i32p, ctypes.c_int64, ctypes.c_int64]
    lib.tnt_frag_stats.argtypes = [ctypes.c_void_p, _i64p, _i64p]
    lib.tnt_frag_stats2.argtypes = [ctypes.c_void_p, _i64p]
    lib.tnt_frag_set_evals.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int, ctypes.c_int,
        _f32p, ctypes.c_float,
        _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, ctypes.c_int64]
    lib.tnt_frag_profile.argtypes = [ctypes.c_void_p, _i64p]
    return lib


_lib = None


def get_lib():
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


HETERO, HOMO, HAIRPIN = 0, 1, 2

# base codes used by the engine (match tntblast_tpu_torch.constants BASE_*)
_ASCII_TO_CODE = {}
for _i, _c in enumerate("ACGTI$-MRSVWYHKDBN"):
    _ASCII_TO_CODE[_c] = _i
_ASCII_TO_CODE["E"] = 5  # synonym for the dangling-end virtual base


def seq_to_codes(s):
    return np.frombuffer(
        bytes(_ASCII_TO_CODE[c.upper()] for c in s), dtype=np.uint8).copy()


class MeltEngine:
    """Handle on a native melt engine instance.

    Parameters mirror the reference NucCruc configuration: temperature (K),
    [Na+] (M), dangling-end flags and the Dinkelbach iteration switch.
    """

    def __init__(self, target_T=310.15, na=0.05, dangle5=False, dangle3=False,
                 dinkelbach=False, n_threads=None, tables=None):
        lib = get_lib()
        t = tables if tables is not None else build_tables()
        if n_threads is None:
            n_threads = os.cpu_count() or 1

        seqs = np.zeros((131, 8), dtype="S1")
        packed = bytearray(131 * 8)
        for i, name in enumerate(t.hairpin_special_names):
            raw = name.encode()
            packed[i * 8:i * 8 + len(raw)] = raw
        del seqs

        scalars = np.array([
            t.param_init_H, t.param_init_S, t.param_AT_closing_H,
            t.param_AT_closing_S, t.param_symmetry_S, t.param_SALT,
            t.param_asymmetric_loop_dS, t.param_bulge_AT_closing_S,
        ], dtype=np.float32)

        def flat(a):
            return np.ascontiguousarray(a, dtype=np.float32).reshape(-1)

        self._tables = t
        self.target_T = float(target_T)
        self.na = float(na)
        self.n_threads = n_threads
        self.dinkelbach = bool(dinkelbach)
        self._h = lib.tnt_engine_create(
            flat(t.param_H), flat(t.param_S),
            flat(t.param_loop_terminal_H), flat(t.param_loop_terminal_S),
            flat(t.param_hairpin_terminal_H), flat(t.param_hairpin_terminal_S),
            flat(t.param_loop_S), flat(t.param_bulge_S), flat(t.param_hairpin_S),
            flat(t.param_hairpin_special_H), flat(t.param_hairpin_special_S),
            bytes(packed),
            flat(t.param_supp), flat(t.param_supp_salt), scalars,
            np.ascontiguousarray(t.watson_and_crick, dtype=np.uint8),
            np.float32(target_T), np.float32(na),
            int(dangle5), int(dangle3), int(dinkelbach), int(n_threads))
        self._lib = lib
        # constructive screening slack for the native host screen
        # (screen_bound.slack_bound; computed over the operating range)
        try:
            from tntblast_tpu_torch.screen_bound import slack_bound
            dangle = bool(dangle5 or dangle3)
            slack = max(slack_bound(self, tt, dangle)
                        for tt in (273.15, 293.15, 313.15, 333.15,
                                   353.15, 373.15)) + 0.1
            lib.tnt_engine_set_screen_slack(self._h, np.float32(slack))
            self.screen_slack = float(slack)
        except Exception:   # noqa: BLE001 — fall back to the safe 1.0
            self.screen_slack = 1.0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tnt_engine_destroy(self._h)
            self._h = None

    def delta_g_screen(self, target_T=None):
        """Screening-table variant (update_dp_param_screen): event
        charges zeroed to admissible lower bounds of the exact
        evaluator's corrections — see docs/screen_bound.md."""
        out = np.zeros(49 * 49, dtype=np.int32)
        self._lib.tnt_engine_delta_g_screen(
            self._h, np.float32(self.target_T if target_T is None
                                else target_T), out)
        return out.reshape(49, 49)

    def delta_g(self, target_T=None):
        out = np.zeros(49 * 49, dtype=np.int32)
        self._lib.tnt_engine_delta_g(
            self._h, np.float32(self.target_T if target_T is None else target_T), out)
        return out.reshape(49, 49)

    def eval_batch(self, mode, queries, targets, strand_conc, n_threads=None):
        """Evaluate a batch of melt problems.

        queries/targets: lists of uint8 code arrays (targets ignored for
        homodimer/hairpin modes); strand_conc: per-item total strand
        concentration.  Returns a dict of result arrays plus the rendered
        alignment strings.
        """
        n = len(queries)
        if n == 0:
            return None
        if n_threads is None:
            n_threads = self.n_threads

        q_len = np.array([len(q) for q in queries], dtype=np.int32)
        q_off = np.zeros(n, dtype=np.int64)
        np.cumsum(q_len[:-1], out=q_off[1:])
        q_data = (np.concatenate(queries).astype(np.uint8)
                  if n else np.zeros(0, np.uint8))

        if mode == HETERO:
            t_len = np.array([len(t) for t in targets], dtype=np.int32)
            t_off = np.zeros(n, dtype=np.int64)
            np.cumsum(t_len[:-1], out=t_off[1:])
            t_data = np.concatenate(targets).astype(np.uint8)
        else:
            t_len = np.zeros(n, dtype=np.int32)
            t_off = np.zeros(n, dtype=np.int64)
            t_data = np.zeros(1, dtype=np.uint8)

        sc = np.ascontiguousarray(strand_conc, dtype=np.float32)

        out = {k: np.zeros(n, dtype=np.float32)
               for k in ("tm", "dH", "dS", "dg", "dp_dg")}
        for k in ("anchor5", "anchor3", "num_mm", "num_gap", "max_degen"):
            out[k] = np.zeros(n, dtype=np.int32)
        out["q_range"] = np.zeros(2 * n, dtype=np.int32)
        out["t_range"] = np.zeros(2 * n, dtype=np.int32)
        out["valid"] = np.zeros(n, dtype=np.uint8)

        align_off = np.zeros(n + 1, dtype=np.int64)
        cap = max(4096, 512 * n)
        while True:
            buf = ctypes.create_string_buffer(cap)
            need = self._lib.tnt_eval_batch(
                self._h, mode, n,
                q_data, q_off, q_len, t_data, t_off, t_len, sc,
                out["tm"], out["dH"], out["dS"], out["dg"], out["dp_dg"],
                out["anchor5"], out["anchor3"],
                out["num_mm"], out["num_gap"], out["max_degen"],
                out["q_range"], out["t_range"], out["valid"],
                buf, align_off, cap, int(n_threads))
            if need == 0:
                break
            cap = int(need)
        raw = buf.raw
        out["align"] = [
            raw[align_off[k]:align_off[k + 1]].decode("latin1")
            for k in range(n)]
        out["q_range"] = out["q_range"].reshape(n, 2)
        out["t_range"] = out["t_range"].reshape(n, 2)
        return out

    def frag_search(self, seq_codes, word_len):
        """Native per-fragment search context (see frag_search.cpp)."""
        return FragSearch(self, seq_codes, word_len)

    def eval_alignments(self, q_rows, t_rows, strand_conc):
        """tm_from_align / tm_pm_duplex: evaluate explicit alignments."""
        n = len(q_rows)
        lens = np.array([len(q) for q in q_rows], dtype=np.int32)
        off = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=off[1:])
        qd = np.concatenate(q_rows).astype(np.uint8)
        td = np.concatenate(t_rows).astype(np.uint8)
        sc = np.ascontiguousarray(strand_conc, dtype=np.float32)
        tm = np.zeros(n, dtype=np.float32)
        dH = np.zeros(n, dtype=np.float32)
        dS = np.zeros(n, dtype=np.float32)
        ok = np.zeros(n, dtype=np.uint8)
        self._lib.tnt_eval_alignment(self._h, n, qd, td, off, lens, sc,
                                     tm, dH, dS, ok)
        return tm, dH, dS, ok


_EMPTY_U8 = np.zeros(0, dtype=np.uint8)

# Hit flag bits (frag_search.cpp HitFlags)
HF_PRIMER_PLUS = 1
HF_SWAP_F = 2
HF_SWAP_R = 4
HF_HAS_PROBE = 8
HF_PROBE_PLUS = 16
HF_HAS_PRIMERS = 32


class FragSearch:
    """Native fragment search context: k-mer index + melt caches over one
    target fragment; one `search` call per assay (frag_search.cpp)."""

    def __init__(self, engine, seq_codes, word_len):
        self._engine = engine              # keep alive
        self._lib = engine._lib
        seq = np.ascontiguousarray(seq_codes, dtype=np.uint8)
        self._h = self._lib.tnt_frag_create(
            engine._h, seq, len(seq), int(word_len))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.tnt_frag_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def search(self, assay_format, f_codes, r_codes, p_codes,
               fconc, rconc, pconc, primer_filt, probe_filt,
               max_len, single_primer_pcr, min_max_primer_clamp,
               target_strand):
        """Run one assay; returns (ints[n,13], floats[n,9], aligns[3n])
        or None when there are no hits (see tnt_frag_fetch layout)."""

        def filt9(f):
            return np.array([f["min_tm"], f["max_tm"], f["min_dg"],
                             f["max_dg"], f["clamp_5"], f["clamp_3"],
                             f["max_mm"], f["max_gap"],
                             f["max_poly_degen"]], dtype=np.float32)

        fc = (np.ascontiguousarray(f_codes, dtype=np.uint8)
              if f_codes is not None else _EMPTY_U8)
        rc = (np.ascontiguousarray(r_codes, dtype=np.uint8)
              if r_codes is not None else _EMPTY_U8)
        pc = (np.ascontiguousarray(p_codes, dtype=np.uint8)
              if p_codes is not None else _EMPTY_U8)

        n = self._lib.tnt_frag_search(
            self._h, int(assay_format),
            fc, len(fc), rc, len(rc), pc, len(pc),
            np.float32(fconc), np.float32(rconc), np.float32(pconc),
            filt9(primer_filt), filt9(probe_filt),
            int(max_len), int(single_primer_pcr),
            int(min_max_primer_clamp), int(target_strand))
        if n == 0:
            return None
        ab = self._lib.tnt_frag_align_bytes(self._h)
        ints = np.zeros((n, 13), dtype=np.int32)
        floats = np.zeros((n, 9), dtype=np.float32)
        off = np.zeros(3 * n + 1, dtype=np.int64)
        buf = ctypes.create_string_buffer(int(ab))
        self._lib.tnt_frag_fetch(self._h, ints.reshape(-1),
                                 floats.reshape(-1), buf, off)
        raw = buf.raw
        aligns = [raw[off[i]:off[i + 1]].decode("latin1")
                  for i in range(3 * n)]
        return ints, floats, aligns

    def candidates(self, oligo_codes, minus, wt_max):
        """Candidate windows of one (oligo, strand) slot for device
        screening: (starts[n] int32, eligible[n] uint8,
        windows[n, wt_max] int8 — oriented, pad=4)."""
        oc = np.ascontiguousarray(oligo_codes, dtype=np.uint8)
        empty_i = np.zeros(0, np.int32)
        empty_b = np.zeros(0, np.uint8)
        n = self._lib.tnt_frag_candidates(
            self._h, oc, len(oc), int(bool(minus)), int(wt_max),
            empty_i, empty_b, empty_b, 0)
        if n == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.uint8),
                    np.zeros((0, wt_max), np.int8))
        starts = np.zeros(n, np.int32)
        elig = np.zeros(n, np.uint8)
        win = np.zeros((n, wt_max), np.uint8)
        self._lib.tnt_frag_candidates(
            self._h, oc, len(oc), int(bool(minus)), int(wt_max),
            starts, elig, win.reshape(-1), n)
        return starts, elig, win.view(np.int8)

    def set_seeds(self, oligo_codes, minus, min_tm, max_dg, conc,
                  q, t, n_screened=0):
        """Inject a device-computed pre-screened seed list for one
        (oligo, strand) slot (tnt_frag_set_seeds): (q, t) pairs in
        reference order; honored only when the search's filter matches
        (min_tm, max_dg, conc) exactly."""
        oc = np.ascontiguousarray(oligo_codes, dtype=np.uint8)
        q = np.ascontiguousarray(q, dtype=np.int32)
        t = np.ascontiguousarray(t, dtype=np.int32)
        self._lib.tnt_frag_set_seeds(
            self._h, oc, len(oc), int(bool(minus)),
            np.float32(min_tm), np.float32(max_dg), np.float32(conc),
            q, t, len(q), int(n_screened))

    def set_evals(self, oligo_codes, minus, filt9, conc, q, t, evw):
        """Filter an injected slot by device gapless evaluations
        (tnt_frag_set_evals): seeds whose trusted windows fail the full
        filter cascade are dropped before the search builds match lists.
        evw is the (5, n) packed int32 block from the device resolve,
        parallel to the (q, t) seed arrays."""
        oc = np.ascontiguousarray(oligo_codes, dtype=np.uint8)
        q = np.ascontiguousarray(q, dtype=np.int32)
        t = np.ascontiguousarray(t, dtype=np.int32)
        f9 = np.ascontiguousarray(filt9, dtype=np.float32)
        rows = [np.ascontiguousarray(evw[i], dtype=np.int32)
                for i in range(5)]
        self._lib.tnt_frag_set_evals(
            self._h, oc, len(oc), int(bool(minus)), f9, np.float32(conc),
            q, t, rows[0], rows[1], rows[2], rows[3], rows[4], len(q))

    def stats2(self):
        a = np.zeros(1, np.int64)
        self._lib.tnt_frag_stats2(self._h, a)
        return {"dev_evaluated": int(a[0])}

    def set_verdicts(self, oligo_codes, minus, min_tm, max_dg, conc,
                     starts, flags):
        oc = np.ascontiguousarray(oligo_codes, dtype=np.uint8)
        self._lib.tnt_frag_set_verdicts(
            self._h, oc, len(oc), int(bool(minus)),
            np.float32(min_tm), np.float32(max_dg), np.float32(conc),
            np.ascontiguousarray(starts, dtype=np.int32),
            np.ascontiguousarray(flags, dtype=np.uint8), len(starts))

    def stats(self):
        a = np.zeros(1, np.int64)
        b = np.zeros(1, np.int64)
        c = np.zeros(1, np.int64)
        self._lib.tnt_frag_stats(self._h, a, b)
        self._lib.tnt_frag_stats2(self._h, c)
        return {"screened": int(a[0]), "evaluated": int(b[0]),
                "dev_evaluated": int(c[0])}

    def profile(self):
        """Phase cycle counters (rdtsc):
        index/seed/extract/screen/dp/tm/sort/pair."""
        t = np.zeros(8, np.int64)
        self._lib.tnt_frag_profile(self._h, t)
        names = ("index", "seed", "extract", "screen", "dp", "tm", "sort",
                 "pair")
        return dict(zip(names, (int(v) for v in t)))
