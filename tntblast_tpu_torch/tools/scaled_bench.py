"""BASELINE config 5 through the port: a multi-assay PCR batch and a padlock
batch over a sharded 1.024 Gb database, on the host, on one card, on the
mesh path and in two ranks whose results rank 0 merges.

The database and assays are those of the repository's scale benchmark
(tools/scaled_bench.py), generated here by the same draws in the same
order, so the files are byte-equal to that tool's for the same sizes:
`nseq` sequences of `seqlen` bases (8 x 128 Mb, seed 20260821) with 10 PCR
assays of 20-24-nt primers, 5 of them planted 40 times a sequence as
150-nt amplicons, and 6 padlock assays of 20-24-nt arms, 4 of them planted
40 times a sequence as ligation sites.  The rng draws the assays, the
padlocks and then one sequence after another, so the database of
`nseq` = 1 is a byte prefix of the full one and the query files are the
same for every `nseq`.  The files are written once into bench_work/
(build() takes any directory), named by `nseq` (and by `seqlen` where it
is not the default).

Each mode runs each assay family once, as its own process, with the JAX
tool's arguments (PCR: `-e 40 -E 45 -l 2000`; PADLOCK: `-e 40 -E 45`):
  host     python -m tntblast_tpu_torch, TNTBLAST_TPU_THREADS=2;
  screen   the same with --tpu-screen T (the device path, one card);
  mesh     the same with --mesh T (every visible card, one fragment a card
           a step);
  twoproc  two ranks of python -m tntblast_tpu_torch.parallel.multiproc,
           the host search, TNTBLAST_TPU_THREADS=1 each;
  ranks    the two ranks with --tpu-screen T and --device cuda:0: the
           multi-host merge of config 5 on one card;
  ref      the reference binary at $TNTBLAST_REF_BIN (default
           /tmp/refbuild/tntblast, the JAX tool's), skipped without it.

Each run prints one JSON line: mode, family, exit code, wall seconds
(process start-up included), Mb/s, the output's sha256, its hit count,
processes, host threads, each process's peak host memory, and the card's
nvidia-smi name and power limit;
a device mode adds its TNTBLAST_TPU_PROFILE line's fragments, steps, each
kernel's launches and fallbacks (a rank's each).  The tool exits non-zero
if a mode's sha256 differs from host's for the same family, if a run
fails, if a device mode has a fallback, or if a kernel's launches are not
what the steps ask: one step a panel group and batch of fragments
(ceil(fragments / 8) on one card; one a fragment on a one-card mesh; each
rank's own share), computed from the database and the panel before the
runs, not read back from them.

    python -m tntblast_tpu_torch.tools.scaled_bench [--nseq N] [mode ...]

Modes default to host and twoproc, as the JAX tool's.  Run it from the
repository root; the device modes need a CUDA device and nvcc.
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

NSEQ = 8
SEQLEN = 128_000_000           # 1.024 Gb in all
NASSAY = 10
NPLANT = 5
PLANTS_PER_SEQ = 40
AMPLEN = 150
NPAD = 6                       # padlock assays (4 planted)
NPAD_PLANT = 4
SEED = 20260821
LINE = 70                      # FASTA line width

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_BIN = os.environ.get("TNTBLAST_REF_BIN", "/tmp/refbuild/tntblast")

FAMILIES = ("PCR", "PADLOCK")
MODES = ("ref", "host", "screen", "mesh", "twoproc", "ranks")
DEVICE_MODES = ("screen", "mesh", "ranks")
# fragments a device step takes on one card (parallel/panel.py
# SINGLE_CHIP_BATCH)
BATCH = 8


def emit(o):
    o["t"] = time.strftime("%H:%M:%S")
    print(json.dumps(o))
    sys.stdout.flush()


def _to_str(codes):
    return BASES[codes].tobytes().decode()


def _revcomp(codes):
    return (3 - codes)[::-1]


def _fasta_lines(codes):
    """The bases of `codes` as LINE-wide lines, each ending in a newline."""
    txt = BASES[codes]
    full, rest = divmod(len(txt), LINE)
    out = np.empty(full * (LINE + 1) + (rest + 1 if rest else 0), np.uint8)
    rows = out[:full * (LINE + 1)].reshape(full, LINE + 1)
    rows[:, :LINE] = txt[:full * LINE].reshape(full, LINE)
    rows[:, LINE] = ord("\n")
    if rest:
        out[full * (LINE + 1):-1] = txt[full * LINE:]
        out[-1] = ord("\n")
    return out


def paths(workdir, nseq=NSEQ, seqlen=SEQLEN):
    """(database, PCR queries, padlock queries) of these sizes."""
    stem = f"scaled_n{nseq}" + ("" if seqlen == SEQLEN else f"_l{seqlen}")
    return tuple(os.path.join(workdir, stem + ext)
                 for ext in (".fna", "_pcr.txt", "_padlock.txt"))


def build(workdir, nseq=NSEQ, seqlen=SEQLEN):
    """Writes the database and both query files unless they are there;
    returns their paths (as `paths`)."""
    fna, pcr, pad = paths(workdir, nseq, seqlen)
    if all(os.path.exists(p) for p in (fna, pcr, pad)):
        return fna, pcr, pad
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(SEED)

    assays = []
    for a in range(NASSAY):
        f = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        r = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        assays.append((f"SCPCR{a:02d}", f, r))
    pads = []
    for a in range(NPAD):
        up = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        dn = rng.integers(0, 4, int(rng.integers(20, 25)), dtype=np.uint8)
        pads.append((f"SCPAD{a:02d}", up, dn))

    t0 = time.time()
    with open(fna + ".tmp", "wb") as fh:
        for s in range(nseq):
            g = rng.integers(0, 4, seqlen, dtype=np.uint8)
            for a in range(NPLANT):
                _, f, r = assays[a]
                rrc = _revcomp(r)
                for _ in range(PLANTS_PER_SEQ):
                    pos = int(rng.integers(0, seqlen - AMPLEN - 1))
                    g[pos:pos + len(f)] = f
                    g[pos + AMPLEN - len(rrc):pos + AMPLEN] = rrc
            for a in range(NPAD_PLANT):
                # the plus-strand ligation site is up_arm || down_arm with
                # no gap (the engine's down arm, query column 2, binds
                # first)
                _, up, dn = pads[a]
                site = np.concatenate([up, dn])
                for _ in range(PLANTS_PER_SEQ):
                    pos = int(rng.integers(0, seqlen - len(site) - 1))
                    g[pos:pos + len(site)] = site
            fh.write(f">scaled_seq_{s} synthetic 128 Mb sequence\n".encode())
            fh.write(_fasta_lines(g).tobytes())
            emit({"gen_seq": s, "s": round(time.time() - t0, 1)})
    os.replace(fna + ".tmp", fna)
    for path, rows in ((pcr, assays), (pad, pads)):
        with open(path + ".tmp", "w") as fh:
            for name, x, y in rows:
                fh.write(f"{name}\t{_to_str(x)}\t{_to_str(y)}\n")
        os.replace(path + ".tmp", path)
    return fna, pcr, pad


def family_argv(fmt, qfile, fna, out):
    """The JAX tool's search arguments of family `fmt`."""
    if fmt == "PCR":
        return ["-i", qfile, "-d", fna, "-A", "PCR", "-e", "40", "-E", "45",
                "-l", "2000", "-o", out]
    return ["-i", qfile, "-d", fna, "-A", "PADLOCK", "-e", "40", "-E", "45",
            "-o", out]


def planted(fmt, nseq):
    """Sites planted for the family over `nseq` sequences."""
    return (NPLANT if fmt == "PCR" else NPAD_PLANT) * PLANTS_PER_SEQ * nseq


def sha(path):
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def hits(path):
    """Hits in an output file: one "name = " line each."""
    n = 0
    with open(path, "rb") as fh:
        for line in fh:
            n += line.startswith(b"name = ")
    return n


def options(argv):
    """The parsed options of a search, its assays read and expanded as the
    CLI reads them."""
    from tntblast_tpu_torch import constants as C
    from tntblast_tpu_torch.model import (
        expand_degenerate_signatures, read_input_file)
    from tntblast_tpu_torch.options import Options

    opt = Options()
    with contextlib.redirect_stdout(io.StringIO()):     # its banner
        opt.parse(argv)
    opt.sig_list = expand_degenerate_signatures(
        read_input_file(opt.input_filename, opt.ignore_probe,
                        opt.assay_format == C.ASSAY_PROBE),
        opt.degen_rescale_ct)
    return opt


def step_plan(argv, db, mode, n_ranks=2, seq_lens=None):
    """What the device steps of `mode` ask for on this database, from the
    work items and the panel alone: {"fragments", "steps", launches of
    each step kernel}, a list of one such dict a process (one, or one a
    rank).  A step takes `BATCH` fragments on one card (one on a one-card
    mesh), in the order the process reads them, one step a panel group;
    it launches seed (the word-table path) or seed_dense (the dense path),
    pool, win_decode and kept once, screen_dp once a chunk of
    chunk_entries and eval_pack as often where the panel evaluates.  A
    mesh of n cards takes n fragments a submission, one step a card of one
    fragment each; "steps" counts submissions a panel group, as the panel
    manager's stats do.  `seq_lens` ({target: bases}) keeps the records'
    lengths between calls on one database."""
    from tntblast_tpu_torch.engine import (
        _fragment_work_items, make_melt_engine)
    from tntblast_tpu_torch.ops import STEP_KERNELS
    from tntblast_tpu_torch.parallel.device_search import chunk_starts
    from tntblast_tpu_torch.parallel.multiproc import partition_items
    from tntblast_tpu_torch.parallel.panel import FragmentPanelManager

    opt = options(argv)
    mgr = FragmentPanelManager(opt, make_melt_engine(opt, n_threads=1),
                               "cpu")
    n_dev = 1
    if mode == "mesh":
        import torch
        n_dev = max(1, torch.cuda.device_count())
    batch = n_dev if mode == "mesh" else BATCH
    per_step = 1 if mode == "mesh" else BATCH
    items, _ = _fragment_work_items(opt, db)
    seq_len = {} if seq_lens is None else seq_lens

    def frag_len(item):
        tgt, start, stop, _ = item
        if tgt not in seq_len:
            seq_len[tgt] = len(db.read(tgt)[1])
        end = min(stop + opt.max_product_length() + 2, seq_len[tgt] - 1)
        return max(0, end - start + 1)

    owner = (partition_items(items, n_ranks) if mode == "ranks"
             else [0] * len(items))
    plans = []
    for rank in range(n_ranks if mode == "ranks" else 1):
        lens = [frag_len(it) for it, o in zip(items, owner) if o == rank]
        if mode == "ranks":
            # a rank reads its batch, then queues those long enough to hash
            batches = [[n for n in lens[b0:b0 + batch]
                        if n >= opt.hash_word_size]
                       for b0 in range(0, len(lens), batch)]
        else:
            # the search loop fills its batch with fragments long enough
            lens = [n for n in lens if n >= opt.hash_word_size]
            batches = [lens[b0:b0 + batch]
                       for b0 in range(0, len(lens), batch)]
        batches = [b for b in batches if b]
        plan = dict.fromkeys(STEP_KERNELS, 0)
        plan.update(fragments=sum(map(len, batches)), steps=0)
        for frags in batches:
            tile = mgr._tile_len(max(frags))
            for g in mgr.groups:
                dp = g.device_panel(tile)
                cfg = dp.config
                chunks = len(chunk_starts(per_step * cfg.cap, cfg.wq_max,
                                          cfg.wt))
                plan["steps"] += 1
                # the word-table path where the panel has a word table
                seeder = ("seed" if dp.host_tables[1].shape[0] > 1
                          else "seed_dense")
                for name in (seeder, "pool", "win_decode", "kept"):
                    plan[name] += n_dev
                plan["screen_dp"] += n_dev * chunks
                if dp.eval_on:
                    plan["eval_pack"] += n_dev * chunks
        plans.append(plan)
    return plans


def card():
    """The card's nvidia-smi name and power limit, or None."""
    try:
        from tntblast_tpu_torch.tools.screen_probe import card_name
        return card_name()
    except Exception:       # noqa: BLE001 — no card, no nvidia-smi
        return None


def device_line(log):
    """The device line of a search's TNTBLAST_TPU_PROFILE output."""
    found = [ln for ln in log.splitlines()
             if ln.startswith("[profile] device ")]
    return found[-1] if found else None


def peak_kb(log):
    """The peak host memory a process reported on its profile line (a
    search's `[profile] peak host memory = N kB`, a rank's `maxrss N kB`),
    or None."""
    for ln in log.splitlines():
        if ln.startswith("[profile] peak host memory = "):
            return int(ln.split("= ")[1].split()[0])
        if " maxrss " in ln:
            return int(ln.split(" maxrss ")[1].split()[0])
    return None


def _device_record(line):
    from tntblast_tpu_torch.tools import launches

    if line is None:
        return None
    stats = launches.line_stats(line)
    return {"device": line.split(" device ", 1)[1].split()[0],
            "fragments": stats["fragments"],
            "steps": stats["steps"], "fallback": stats["fallback"],
            "launches": launches.rank_counts(line),
            "outside": (int(line.rsplit(" ", 1)[1])
                        if " outside " in line else None)}


def run_mode(mode, fmt, files, workdir, mb, timeout=7200):
    """One search of family `fmt` in `mode`; returns its record (as
    printed)."""
    from tntblast_tpu_torch.tools import launches

    fna, pcr, pad = files
    qfile = pcr if fmt == "PCR" else pad
    out = os.path.join(workdir, f"scaled_{fmt}_{mode}.out")
    for stale in (out, out + ".rank1.ignore"):
        if os.path.exists(stale):
            os.unlink(stale)
    argv = family_argv(fmt, qfile, fna, out) + ["-v", "F"]
    rec = {"mode": mode, "fmt": fmt, "nproc": 1, "threads": 2,
           "card": card()}
    env = dict(os.environ, PYTHONPATH=ROOT, TNTBLAST_TPU_PROFILE="1")
    t0 = time.time()
    if mode == "ref":
        if not os.path.exists(REF_BIN):
            rec["skipped"] = "no reference binary"
            emit(rec)
            return rec
        env["OMP_NUM_THREADS"] = "2"
        rc = subprocess.call([REF_BIN] + argv[:-2], env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL, timeout=timeout)
        rec["rcs"] = [rc]
    elif mode in ("host", "screen", "mesh"):
        env["TNTBLAST_TPU_THREADS"] = "2"
        flag = {"host": [], "screen": ["--tpu-screen", "T"],
                "mesh": ["--mesh", "T"]}[mode]
        proc = subprocess.run(
            [sys.executable, "-m", "tntblast_tpu_torch", *argv, *flag],
            env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, timeout=timeout)
        rec["rcs"] = [proc.returncode]
        rec["peak_kb"] = [peak_kb(proc.stderr)]
        if proc.returncode:
            rec["log"] = proc.stderr[-2000:]
        if mode != "host":
            rec["ranks"] = [_device_record(device_line(proc.stderr))]
    elif mode in ("twoproc", "ranks"):
        rec.update(nproc=2, threads=1)
        device = "cuda:0" if mode == "ranks" else None
        extra = ["--tpu-screen", "T"] if mode == "ranks" else []
        _, ranks = launches.run_ranks(
            argv + extra, ROOT, timeout=timeout, device=device,
            env={"TNTBLAST_TPU_THREADS": "1"})
        rec["rcs"] = [rc for rc, _ in ranks]
        lines = [launches.profile_line(log, r)
                 for r, (_, log) in enumerate(ranks)]
        rec["rank_lines"] = lines
        rec["peak_kb"] = [peak_kb(ln or "") for ln in lines]
        if any(rc for rc, _ in ranks):
            rec["log"] = [log[-2000:] for _, log in ranks]
        if mode == "ranks":
            rec["ranks"] = [_device_record(ln) for ln in lines]
    else:
        raise ValueError(f"unknown mode {mode}")
    dt = time.time() - t0
    rec.update(rc=max(rec["rcs"]), s=dt, mbps=mb / dt)
    if os.path.exists(out):
        rec.update(sha=sha(out), hits=hits(out))
    emit(rec)
    return rec


def gate(records, plans, nseq):
    """The failures of a set of runs: a run that failed or wrote nothing, a
    sha256 other than host's for the same family, fewer hits than sites
    planted, a device mode with a fallback, a module of jax or of the JAX
    package in a rank, or launches other than the steps ask
    (`plans[(mode, fmt)]`, as step_plan)."""
    bad = []
    host = {r["fmt"]: r.get("sha") for r in records if r["mode"] == "host"}
    for r in records:
        what = f"{r['mode']} {r['fmt']}"
        if r.get("skipped"):
            continue
        if r.get("rc") != 0 or r.get("sha") is None:
            bad.append(f"{what}: exit {r.get('rcs')}, output "
                       f"{'missing' if r.get('sha') is None else 'written'}")
            continue
        if r["fmt"] in host and r["sha"] != host[r["fmt"]]:
            bad.append(f"{what}: sha256 {r['sha']} != host's "
                       f"{host[r['fmt']]}")
        if r["hits"] < planted(r["fmt"], nseq):
            bad.append(f"{what}: {r['hits']} hits, "
                       f"{planted(r['fmt'], nseq)} sites planted")
        if r["mode"] not in DEVICE_MODES:
            continue
        want = plans.get((r["mode"], r["fmt"]))
        got = r.get("ranks") or []
        if want is None or len(got) != len(want) or None in got:
            bad.append(f"{what}: {len(got)} device lines, "
                       f"{0 if want is None else len(want)} processes")
            continue
        for i, (g, w) in enumerate(zip(got, want)):
            if g["fallback"]:
                bad.append(f"{what}, process {i}: {g['fallback']} "
                           f"fallbacks")
            if g["outside"]:
                bad.append(f"{what}, process {i}: {g['outside']} modules "
                           f"of jax or of the JAX package")
            seen = dict(g["launches"], fragments=g["fragments"],
                        steps=g["steps"])
            if seen != w:
                bad.append(f"{what}, process {i}: {seen}, the steps ask "
                           f"for {w}")
    return bad


def prebuild():
    """The step's kernels built before the timed runs (one nvcc a source,
    all at once), so that no run's wall holds a compile."""
    import threading

    from tntblast_tpu_torch import _kernels

    errors = []

    def one(name):
        try:
            _kernels.build(name)
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,))
               for n in _kernels.KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="*", default=["host", "twoproc"])
    ap.add_argument("--nseq", type=int, default=NSEQ,
                    help="sequences of the database (the first nseq of "
                         "the full one)")
    args = ap.parse_args(argv)
    unknown = set(args.modes) - set(MODES)
    if unknown:
        ap.error(f"unknown modes {sorted(unknown)}")
    work = os.path.join(ROOT, "bench_work")
    t0 = time.time()
    files = build(work, args.nseq)
    mb = args.nseq * SEQLEN / 1e6
    emit({"built": files[0], "mb": mb, "s": time.time() - t0})

    from tntblast_tpu_torch.io.fastx import open_database

    plans = {}
    if set(args.modes) & set(DEVICE_MODES):
        prebuild()
        t0 = time.time()
        db = open_database(files[0])
        seq_lens = {}
        for fmt in FAMILIES:
            qfile = files[1] if fmt == "PCR" else files[2]
            argv_ = family_argv(fmt, qfile, files[0], os.devnull)
            for mode in DEVICE_MODES:
                if mode in args.modes:
                    plans[mode, fmt] = step_plan(argv_, db, mode,
                                                 seq_lens=seq_lens)
        del db
        emit({"plans": {f"{m} {f}": p for (m, f), p in plans.items()},
              "s": time.time() - t0})
    modes = list(args.modes)
    if "host" in modes:             # the others are held to host's sha
        modes.remove("host")
        modes.insert(0, "host")
    records = [run_mode(mode, fmt, files, work, mb)
               for fmt in FAMILIES for mode in modes]
    bad = gate(records, plans, args.nseq)
    emit({"ok": not bad, "failures": bad})
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
