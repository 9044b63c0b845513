"""The readings that `correct`'s limits are set from, on the card at a
cell's own size.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        [--faults] --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell as run.py makes it (a
short window), and then

  sound     the numbers the reference gives the program's outputs;
  control   the same outputs with every oligo's Tm, dH, dS and dG
            replaced by the reference's scores of its printed alignment
            computed in bfloat16 (the nearest precision below the float32
            the thermodynamics are stated in), judged in float32: the
            control has to fail;
  faults    with --faults, a run with each fault of benchmark/faults.py
            planted under the window, and its numbers.

One JSON line a seed.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import faults  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402


def _g(x):
    return f"{x:g}"


def control_text(text, params):
    """`text` with each oligo's printed Tm, dH, dS and dG replaced by the
    reference's scores of its printed alignment in bfloat16."""
    head, *blocks = text.split("\nname = ")
    out = [head]
    for block in blocks:
        rec = reference.parse_records("\nname = " + block)[0]
        lines = block.split("\n")
        for role, o in rec["oligos"].items():
            got = reference.oligo_thermo(o, params["conc"][role], params,
                                         "bfloat16")
            if got is None:
                continue
            tm, dh, ds, dg = got[:4]
            for i, ln in enumerate(lines):
                if ln.startswith(f"{role} tm = "):
                    lines[i] = f"{role} tm = {_g(tm)}"
                elif ln.startswith(f"{role} dG["):
                    lines[i] = (f"{role} dG[{_g(dg)}] = dH[{_g(dh)}] - "
                                f"T*dS[{_g(ds)}]")
        out.append("\n".join(lines))
    return "\nname = ".join(out)


def readings(cell, window, seed):
    searches = {s["name"]: s for s in cell.traffic["searches"]}
    ctl = {sha: (name, control_text(text, reference.search_params(
               searches[name]["argv"])))
           for sha, (name, text) in window.outputs.items()}
    numbers, _ = run.judge(cell, window, outputs=ctl, seed=seed)
    return numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    base = ["--workload", args.workload, "--seconds", str(args.seconds)]
    if args.rehearse:
        base.append("--rehearse")
    rc = 0
    for seed in args.seeds:
        keep = {"then": readings}
        rc |= run.main(base + ["--seed", str(seed)], keep=keep)
        line = {"seed": seed, "sound": keep["numbers"],
                "control": keep["then_result"], "faults": {}}
        if args.faults:
            for name, fault in faults.FAULTS.items():
                k = {}
                rc |= run.main(base + ["--seed", str(seed)], fault=fault,
                               keep=k)
                line["faults"][name] = k.get("numbers")
        print("READINGS " + json.dumps(line))
        sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
