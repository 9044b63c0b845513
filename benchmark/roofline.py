"""The card's peaks and the least time of a device step.

A step's least time is the larger of its operations over the card's int32
rate and its bytes over the card's memory bandwidth.  Its operations are
the DP cells its candidates need, each candidate window at its own oligo
length times its own window width (the oligo and a flank of `flank` bases
on each side), times the int32 operations a cell needs in each screening
condition that is on for its slot and in the evaluation condition
(chip_smoke.py's OPS_PER_CELL: an add-max counted once).  Its bytes are
the packed payload and the panel's tables read once, and the header and
the kept entries (9 int32 words each) written once.  This is the work the
inputs need, whatever kernels implement it.

Peaks: NVIDIA H100 SXM, 132 SMs of 64 int32 lanes at 1980 MHz (the SM
clock the card shows under load), and 3.35 TB/s of HBM3 (NVIDIA's data
sheet), at its 700 W limit.
"""

INT32_OPS_PER_S = 64 * 132 * 1980e6
BYTES_PER_S = 3.35e12
OPS_PER_CELL = {"screen": 13, "eval": 19}
KEPT_WORDS = 9


def step_ops(step):
    ops = 0
    per_cell = [OPS_PER_CELL["screen"] * n
                + (OPS_PER_CELL["eval"] if step["eval_on"] else 0)
                for n in step["conds"]]
    for counts in step["counts"]:
        for c, n, k in zip(counts, step["slot_len"], per_cell):
            ops += c * n * (n + 2 * step["flank"]) * k
    return ops


def step_bytes(step):
    return (step["payload_bytes"] + step["table_bytes"]
            + step["header_bytes"] + 4 * KEPT_WORDS * step["n_kept"])


def least_seconds(step):
    return max(step_ops(step) / INT32_OPS_PER_S,
               step_bytes(step) / BYTES_PER_S)
