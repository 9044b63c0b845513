"""A CPU rehearsal of run.py at the tiny sizes of each traffic file's
"rehearsal" entry (the kernels' plain versions; no device metric), its
control, and each fault the cells can have under the timed path."""

import json

import pytest

import control
import faults
import run


def _run(capsys, cell, trace=0, fault=None, keep=None, seed=17):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.01", "--trace", str(trace), "--rehearse"],
                  fault=fault, keep=keep)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


CELL = "config5.chrom128"


def test_rehearsal_is_correct_and_reads_its_layers(capsys):
    res = _run(capsys, CELL, trace=1)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu" and res["rehearsal"]
    # no device metric from a CPU run
    for name in ("step_device_ms", "step_roofline", "device_idle_share"):
        assert name not in res["metrics"]
    for name in ("search_setup_ms", "ctx_ms_per_mb", "wait_share",
                 "kept_share", "fallback_frags"):
        assert name in res["metrics"]


def test_rehearsal_end_to_end_metrics(capsys):
    res = _run(capsys, CELL)
    assert set(res["metrics"]) == {"search_mbps", "setup_s"}
    assert res["metrics"]["search_mbps"]["value"] > 0
    assert res["checks"]["missing_planted"]["value"] == 0
    # the slices were judged, and held records
    assert res["checks"]["missing_hits"]["value"] == 0
    assert res["window_captures"] == 0


def test_control_fails(capsys):
    keep = {"then": control.readings}
    _run(capsys, CELL, keep=keep)
    limits = keep["cell"].limits
    assert keep["numbers"]["thermo_gap"] <= limits["thermo_gap"]
    assert keep["numbers"]["slice_records"] > 0
    ctl = keep["then_result"]
    assert ctl["thermo_gap"] > limits["thermo_gap"]
    assert ctl["failed"] >= 1


# two fragments a device step where the fault is about a step's later
# half, one where it is about the steps after the first
BATCH = {"half_batch": "2", "stale_step": "1"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_makes_the_run_incorrect(capsys, monkeypatch, fault):
    monkeypatch.setenv("TNTBLAST_TPU_BATCH", BATCH.get(fault, "2"))
    # seed 1: the slices hold a product of a binding no site planted, so
    # that drop_window finds a window to drop
    res = _run(capsys, CELL, fault=faults.FAULTS[fault], seed=1)
    assert res["correct"] is False and res["failed"] >= 1
    if fault == "drop_window":
        # only the slices' own hit list sees it
        assert res["checks"]["missing_hits"]["value"] >= 1
        assert res["checks"]["missing_planted"]["value"] == 0
