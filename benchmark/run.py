"""One run of one benchmark cell of tntblast_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  The cell's entry in BENCHMARK.json names
its traffic, benchmark/cells/<cell>.json, which names its configuration
(benchmark/configs/<config>.json), its generator
(benchmark/traffic/<generator>.py) and that generator's parameters, and
the searches the window runs, in order.  A run:

  1. imports the port and loads its kernels and native engine (built into
     tntblast_tpu_torch/_build/ of the checkout on the first run);
  2. makes the database and the queries from --seed in $TMPDIR;
  3. warms up: one search of each panel over the warm-up database the
     traffic file names, or else over the cell's own database.  Its
     record is sized so that its steps have the shapes of the cell's
     (full steps of fragments, and a last step of one short fragment, a
     smaller tile), so that the warm-up captures every step graph the
     window replays;
  4. runs the window: a closed loop of whole searches through
     tntblast_tpu_torch.cli.local_main(argv, device="cuda") on host
     threads for half the machine's cores, one at a time, each started as
     the last one ends, in whole rounds of the cell's searches, until
     --seconds have passed; the window ends when the last search ends;
  5. judges every distinct output with the plain reference
     (benchmark/reference.py: every record, and the whole hit list in the
     traffic file's count of slices drawn from --seed) and prints each
     compared number beside its limit on standard error and, last, one
     JSON line on standard output.  A run whose window captured a graph
     (a compile inside the window) prints no result.

With --trace 0 the line's metrics are the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (each read by benchmark/metrics/<name>.py
from the spans, counters and device trace of the window).  --rehearse
runs the cell at the rehearsal sizes of its traffic file on the CPU with
the kernels' plain versions (for the tests): no device metric, never a
measurement.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tntblast_tpu")
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import reference  # noqa: E402


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(kind, name):
    """benchmark/<kind>/<name>.py as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None):
    """Loaded modules (or `names`) whose top-level name is jax, jaxlib,
    flax or the JAX package (compared whole: the port's name begins with
    the JAX package's)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def window_rate(searches, bases_of):
    """Mb/s of a window: the bases of every search over the time from the
    first search's start to the last one's end."""
    if not searches:
        return None
    span = searches[-1]["end"] - searches[0]["start"]
    return sum(bases_of(s) for s in searches) / 1e6 / span


class Cell:
    """A cell's configuration, traffic and generated data."""

    def __init__(self, name, rehearse=False, bench=None):
        bench = bench or load_json(ROOT, "BENCHMARK.json")
        entry = {w["name"]: w for w in bench["workloads"]}[name]
        self.name, self.entry = name, entry
        self.chips = entry["chips"]
        self.traffic = load_json(HERE, "cells", f"{name}.json")
        self.config = load_json(HERE, "configs",
                                f"{self.traffic['config']}.json")
        self.params = dict(self.config["params"], **self.traffic["params"])
        if rehearse:
            self.params.update(self.traffic["rehearsal"])
        self.limits = self.traffic["limits"]
        self.slices = dict(self.traffic["slices"])
        self.warmup = dict(self.traffic.get("warmup") or {})
        if rehearse:
            self.slices.update(self.traffic["rehearsal"].get("slices", {}))
            self.warmup = {}
        self.data = None

    def generate(self, workdir, seed, **over):
        gen = load_module("traffic", self.traffic["generator"])
        data = gen.generate(workdir, seed % (1 << 63),
                            **dict(self.params, **over))
        if not over:
            self.data = data
        return data

    def argv(self, search, db, out, data=None):
        data = data or self.data
        return (["-i", data["queries"][search["queries"]], "-d", db]
                + search["argv"] + ["-o", out]
                + self.traffic["device_argv"])


def run_search(argv, device):
    """One whole search through local_main; (exit code, error text)."""
    from tntblast_tpu_torch import cli

    try:
        rc = cli.local_main(argv, stdout=io.StringIO(), device=device)
    except Exception:               # noqa: BLE001 — a failed search
        return 1, traceback.format_exc()
    return rc, None if rc == 0 else f"local_main returned {rc}"


class Window:
    """The closed loop of whole searches and what it leaves to judge."""

    def __init__(self, cell, workdir, device, sync):
        self.cell, self.workdir, self.device = cell, workdir, device
        self.sync = sync
        self.searches = []
        self.outputs = {}           # sha256 -> (search name, text)

    def one(self, i, db, trace=None, data=None):
        cell = self.cell
        search = cell.traffic["searches"][i % len(cell.traffic["searches"])]
        out = os.path.join(self.workdir, f"out_{search['name']}.txt")
        if os.path.exists(out):
            os.unlink(out)
        argv = cell.argv(search, db, out, data)
        n_mgr = len(trace.managers) if trace else 0
        c0 = os.times()
        t0 = time.perf_counter()
        rc, err = run_search(argv, self.device)
        self.sync()
        t1 = time.perf_counter()
        c1 = os.times()
        rec = {"search": search["name"], "start": t0, "end": t1, "rc": rc,
               "error": err, "sha": None, "first_step_end": None,
               "stats": None, "rss_mb": rss_mb(),
               "cpu_s": c1.user + c1.system - c0.user - c0.system}
        if rc == 0 and os.path.exists(out):
            with open(out, "rb") as fh:
                raw = fh.read()
            rec["sha"] = hashlib.sha256(raw).hexdigest()
            if rec["sha"] not in self.outputs:
                self.outputs[rec["sha"]] = (search["name"],
                                            raw.decode("latin1"))
        if trace is not None:
            mgrs = trace.managers[n_mgr:]
            if mgrs:
                rec["stats"] = dict(mgrs[-1].stats)
            main = threading.get_ident()
            ends = [e for n, th, s, e in trace.intervals
                    if th == main and s >= t0 and n in ("first step", "step")]
            rec["first_step_end"] = min(ends) if ends else None
        return rec

    def run(self, seconds, trace=None):
        db = self.cell.data["db"]
        t0 = time.perf_counter()
        i = 0
        while True:
            rec = self.one(i, db, trace)
            self.searches.append(rec)
            i += 1
            # whole rounds of the cell's searches, so that the mix in the
            # window is the cell's whatever the window's length
            if (rec["end"] - t0 >= seconds
                    and i % len(self.cell.traffic["searches"]) == 0):
                break
        return self.searches


def rss_mb():
    """The process's resident memory now, in MB (0 where /proc has none)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError):
        return 0.0


def host_cpu():
    """(steal, all) jiffies of the host's CPUs so far (/proc/stat; zeros
    where it has none): the hypervisor's share of the cores' time."""
    try:
        with open("/proc/stat") as fh:
            f = [int(x) for x in fh.readline().split()[1:9]]
        return f[7], sum(f)
    except (OSError, ValueError, IndexError):
        return 0, 0


def judge(cell, window, outputs=None, seed=0):
    """The numbers compared, each beside its limit: every distinct output
    judged once by the reference, in the same slices of the database
    (drawn from the run's seed); a search whose output fails, or that
    failed, counts in `failed`."""
    db = reference.read_fasta(cell.data["db"])
    spans = reference.fasta_spans(cell.data["db"])
    slices = reference.draw_slices(
        {k: (len(x), spans[k]) for k, x in db.items()}, seed,
        cell.slices["count"], cell.slices["size"])
    verdicts = {}
    outputs = window.outputs if outputs is None else outputs
    searches = {s["name"]: s for s in cell.traffic["searches"]}
    total = reference.Verdict()
    for sha, (name, text) in outputs.items():
        s = searches[name]
        v = reference.judge(
            text, db, reference.search_params(s["argv"]),
            cell.data["planted"][s["queries"]],
            reference.read_queries(cell.data["queries"][s["queries"]]),
            slices)
        verdicts[sha] = v
        total.add(v)
    failed = 0
    for s in window.searches:
        v = verdicts.get(s["sha"])
        if s["rc"] != 0 or v is None or not passes(v.numbers(), cell.limits):
            failed += 1
    numbers = dict(total.numbers(), failed=failed)
    return numbers, failed


def passes(numbers, limits):
    return all(numbers[k] <= lim for k, lim in limits.items()
               if k in numbers)


def checks_of(numbers, limits):
    return {k: {"value": numbers[k], "limit": lim}
            for k, lim in limits.items()}


class Trace:
    """What a per-layer metric reader gets."""

    def __init__(self, split, searches, window, device, mb):
        self.split, self.searches = split, searches
        self.window, self.device, self.mb = window, device, mb


def per_layer(bench, cell_name, trace):
    out = {}
    for m in bench["per_layer"]:
        if cell_name not in m.get("workloads", [cell_name]):
            continue
        value = load_module("metrics", m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(dev, split, window):
    import devtrace

    t0, t1 = window
    ops = sorted(devtrace.by_name(devtrace.clipped(dev.intervals, t0,
                                                   t1)).items(),
                 key=lambda kv: -kv[1])[:10]
    _, gaps = devtrace.busy_and_gaps(dev.intervals, t0, t1)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[devtrace.label_gap(g, split.intervals),
                           g[1] - g[0]] for g in gaps]}


def main(argv=None, fault=None, keep=None):
    """The run; `fault` (tests and benchmark/control.py) patches the
    program under the window, `keep` (a dict) receives the cell, the
    window and the compared numbers."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU rehearsal at the traffic file's "
                         "rehearsal sizes (tests; never a measurement)")
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(args.workload, args.rehearse, bench)

    import torch

    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < cell.chips):
        print(f"run.py: {cell.name} needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    device = "cpu" if args.rehearse else "cuda"
    # half the cores: the rest are the main thread's, the resolve
    # threads' and the CUDA driver's
    threads = 2 if args.rehearse else max(1, (os.cpu_count() or 2) // 2)
    os.environ["TNTBLAST_TPU_THREADS"] = str(threads)
    os.environ.pop("TNTBLAST_TPU_PROFILE", None)

    from tntblast_tpu_torch import _kernels
    from tntblast_tpu_torch.native import get_lib
    from tntblast_tpu_torch.parallel import step_graph

    get_lib()
    if device == "cuda":
        build_kernels(_kernels)
        torch.cuda.init()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    workdir = os.path.join(tempfile.gettempdir(), "tntblast_bench",
                           cell.name)
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        return _run(args, bench, cell, device, threads, workdir, sync,
                    step_graph, fault, keep)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def build_kernels(_kernels):
    """Every kernel loaded (built into the checkout's _build/ on the first
    run: one nvcc a source, all at once)."""
    errors = []

    def one(name):
        try:
            _kernels.load(name)
        except Exception as e:      # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,))
               for n in _kernels.KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _run(args, bench, cell, device, threads, workdir, sync, step_graph,
         fault, keep):
    import torch

    data = cell.generate(workdir, args.seed)
    warm = Window(cell, workdir, device, sync)
    wdata = data
    if cell.warmup:
        wdata = cell.generate(os.path.join(workdir, "warmup"), args.seed,
                              **cell.warmup)
    for i in range(len(cell.traffic["searches"])):
        rec = warm.one(i, wdata["db"], data=wdata)
        if rec["rc"] != 0:
            print(f"run.py: warm-up search failed:\n{rec['error']}",
                  file=sys.stderr)
            return 1
    sync()
    setup_s = time.perf_counter() - T_START
    captures0 = step_graph.stats["captures"]

    window = Window(cell, workdir, device, sync)
    split = dev = None
    steal0 = host_cpu()
    patch = fault(cell, args.seed) if fault else None
    try:
        if patch is not None:
            patch.__enter__()
        if args.trace:
            import instrument

            split = instrument.WallSplit()
            if device == "cuda":
                import devtrace
                dev = devtrace.DeviceTrace()
                dev.__enter__()
            with split:
                window.run(args.seconds, split)
            if dev is not None:
                sync()
                dev.__exit__(None, None, None)
        else:
            window.run(args.seconds)
    finally:
        if patch is not None:
            patch.__exit__(None, None, None)
    searches = window.searches
    steal1 = host_cpu()
    win = (searches[0]["start"], searches[-1]["end"])
    captures = step_graph.stats["captures"] - captures0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    bad = forbidden_modules()
    if bad:
        print(f"run.py: modules loaded in the run: {bad}", file=sys.stderr)
        return 4

    if captures:
        print(f"run.py: {captures} graph captures inside the window: a "
              f"step shape the warm-up did not run", file=sys.stderr)
        return 5
    t_ref = time.perf_counter()
    numbers, failed = judge(cell, window, seed=args.seed)
    reference_s = time.perf_counter() - t_ref
    if keep is not None:
        keep.update(cell=cell, window=window, numbers=numbers,
                    seed=args.seed)
        if "then" in keep:          # while the data are still there
            keep["then_result"] = keep["then"](cell, window, args.seed)
    checks = checks_of(numbers, cell.limits)
    correct = passes(numbers, cell.limits)
    for s in searches:
        if s["error"]:
            print(f"search {s['search']} failed:\n{s['error'][-2000:]}",
                  file=sys.stderr)

    bases = cell.data["bases"]
    if args.trace:
        mb = bases * len(searches) / 1e6
        metrics = per_layer(bench, cell.name,
                            Trace(split, searches, win, dev, mb))
    else:
        metrics = {"search_mbps": {"value": window_rate(
                       searches, lambda s: bases), "unit": "Mb/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    if device == "cuda":
        props = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": cell.chips, "memory_peak_bytes": int(peak)}
    else:
        props = {"platform": "cpu", "kind": "rehearsal", "count": 0,
                 "memory_peak_bytes": 0}
    if args.trace and dev is not None:
        import devtrace

        busy, _ = devtrace.busy_and_gaps(dev.intervals, *win)
        props.update(busy_s=busy, window_s=win[1] - win[0])
    result = {"correct": correct, "attempted": len(searches),
              "failed": failed, "metrics": metrics, "device": props,
              "host_threads": threads, "searches": [s["search"]
                                                    for s in searches],
              "records": numbers["records"],
              "search_s": [s["end"] - s["start"] for s in searches],
              "search_rss_mb": [s["rss_mb"] for s in searches],
              "search_cpu_s": [s["cpu_s"] for s in searches],
              "host_steal_share": ((steal1[0] - steal0[0])
                                   / max(steal1[1] - steal0[1], 1)),
              "reference_s": reference_s,
              "window_captures": captures}
    if args.trace and dev is not None:
        result["breakdown"] = breakdown(dev, split, win)
    if args.rehearse:
        result["rehearsal"] = True
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
