"""step_roofline's least time of a step, on a hand-counted step."""

import roofline


def test_least_time_of_a_hand_counted_step():
    step = {"slot_len": [20, 30], "conds": [2, 1], "eval_on": True,
            "flank": 4, "counts": [[10, 0], [5, 2]], "n_kept": 7,
            "payload_bytes": 1000, "table_bytes": 500, "header_bytes": 64}
    # cells: slot 0: 15 windows x 20 x 28; slot 1: 2 x 30 x 38
    # ops a cell: slot 0 2 x 13 + 19 = 45, slot 1 13 + 19 = 32
    ops = 15 * 20 * 28 * 45 + 2 * 30 * 38 * 32
    assert roofline.step_ops(step) == ops
    nbytes = 1000 + 500 + 64 + 7 * 9 * 4
    assert roofline.step_bytes(step) == nbytes
    assert roofline.least_seconds(step) == max(
        ops / (64 * 132 * 1980e6), nbytes / 3.35e12)


def test_no_eval_condition_and_off_conditions_cost_nothing():
    step = {"slot_len": [24], "conds": [0], "eval_on": False, "flank": 4,
            "counts": [[100]], "n_kept": 0, "payload_bytes": 0,
            "table_bytes": 0, "header_bytes": 0}
    assert roofline.step_ops(step) == 0
    assert roofline.least_seconds(step) == 0.0
