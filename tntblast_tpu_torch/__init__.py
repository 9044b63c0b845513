"""tntblast_tpu_torch: the device seed+screen search path of tntblast_tpu
in PyTorch, with its screening DP as a hand-written CUDA kernel for NVIDIA
Hopper (sm_90a).

The JAX package tntblast_tpu stays the reference.  This package is
self-contained: it imports torch, never jax and nothing of tntblast_tpu.
The host modules (options, model, io, search, thermo, output, the native
C++ engine, the host work loop) are copies of the reference's, each under
the same relative path and named in its first line.

  - ``ops``      : screen DP and its probe (CUDA kernels + plain PyTorch
                   versions), canonical DP tables, gapless exact evaluator.
  - ``parallel`` : the device search step, its panel manager and the
                   multi-device mesh panel.
  - ``engine``   : run_search on an explicit torch device.
  - ``cli``      : ``python -m tntblast_tpu_torch``, the tntblast_tpu flags.
  - ``tools``    : ``python -m tntblast_tpu_torch.tools.screen_probe``.
"""
