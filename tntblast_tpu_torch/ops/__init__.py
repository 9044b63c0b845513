"""The device step's hand-written kernels, each behind its wrapper.

Each wrapper adds one to its `launches` where it launches its kernel, and
nowhere else.  A CUDA graph of the device step launches the kernels it
captured without calling a wrapper, so the step's graph
(parallel/step_graph.py) takes back the counts its capture made, which
launched nothing, and `add`s them on each replay.  `reset()` sets the
counts of the step's kernels to 0 and `counts()` reads them (the runtime's
profile line, tools/launches.py).
"""

# the kernels of the device step, in the order the step launches them
STEP_KERNELS = ("seed", "seed_dense", "pool", "win_decode", "screen_dp",
                "eval_pack", "kept")


def wrappers():
    """{kernel name: its wrapper, whose `launches` counts its launches}."""
    from tntblast_tpu_torch.ops.eval_pack import eval_pack
    from tntblast_tpu_torch.ops.kept import kept
    from tntblast_tpu_torch.ops.pool import pool
    from tntblast_tpu_torch.ops.screen_dp import screen_dp
    from tntblast_tpu_torch.ops.seed import seed, seed_dense
    from tntblast_tpu_torch.ops.win_decode import win_decode
    return {"seed": seed, "seed_dense": seed_dense, "pool": pool,
            "win_decode": win_decode,
            "screen_dp": screen_dp, "eval_pack": eval_pack, "kept": kept}


def reset():
    for fn in wrappers().values():
        fn.launches = 0


def counts():
    """{kernel name: launches since the last reset()}."""
    return {name: fn.launches for name, fn in wrappers().items()}


def add(launches):
    """Adds {kernel name: launches} to the counts."""
    for name, fn in wrappers().items():
        fn.launches += launches.get(name, 0)
