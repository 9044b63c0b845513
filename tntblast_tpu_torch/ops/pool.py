"""The pooling stage of the device step: every fragment's seed candidates
in one slot-major stream.

`pool` launches the hand-written Hopper kernel (csrc/pool.cu) on CUDA
tensors; on CPU tensors it runs `pool_reference`, the plain PyTorch version
and the kernel's spec: a stable sort of the n x cap keys by slot and four
gathers.  Together they stand where the JAX package has the stable argsort
by slot of tntblast_tpu/parallel/device_search.py::panel_step_core
(:468-492), fused by XLA inside the jitted step; there is no Pallas
original.  The kernel sorts by counting, with no sort.

Inputs (n fragments of cap candidates, num_os slots):
  slot, p  (n, cap) int32  the seed stage's candidates, (diagonal, slot)
                           order, the first min(n_cand, cap) of a fragment
                           valid
  n_cand   (n,) int32      the true candidate count (may exceed cap)
Outputs (Bp = n * cap entries, entry f * cap + r is rank r of fragment f):
  slot_str, p_str, frag_str, order_str  (Bp,) int32  each entry's key
      (its slot if valid, num_os if not), p, fragment and index, in the
      order of a stable sort by key: the valid entries slot-major,
      fragment-major within a slot, rank order within a (fragment, slot),
      then the invalid tail in index order
  valid    (n, cap) bool   rank < min(n_cand, cap)

The kernel has one launch path, `PoolPlan`: a panel's static shapes,
checked once (DevicePanel._tables_on makes the plan, the step calls it),
then one call a step that allocates the five outputs and a scratch buffer
and makes one ctypes call for the kernel's two launches.  `pool`, the
checked call, checks every argument and launches through a plan of its
own.  Every call that launches counts one in `pool.launches`; a launch goes
to the tensors' card and that card's current stream and raises when it is
refused or fails: there is no plain fallback on a card.
"""

import ctypes

import torch

_I32 = torch.int32
MAX_SLOTS = 64          # csrc/pool.cu: a tile's counts by slot; the panel's
                        # groups hold 64 slots at most


def pool_reference(slot, p, n_cand, *, num_os):
    """Plain PyTorch version: the JAX step's stable argsort by slot, with
    invalid entries keyed num_os, and its gathers.  Returns (slot_str,
    p_str, frag_str, order_str, valid)."""
    n, cap = slot.shape
    Bp = n * cap
    dev = slot.device
    slot_f = slot.reshape(Bp)
    p_f = p.reshape(Bp)
    ar = torch.arange(Bp, dtype=_I32, device=dev)
    rank = ar % cap
    frag_f = ar // cap
    # compacted entries per fragment: the compaction truncates at cap
    # while n_cand is the TRUE count (overflowing fragments go to the
    # host)
    n_comp = torch.clamp_max(n_cand, cap)
    valid = rank < n_comp[frag_f.long()]
    key = torch.where(valid, slot_f, num_os)
    order = torch.sort(key, stable=True).indices
    # invalid entries carry key num_os and land after every real slot:
    # within a slot the order is fragment-major, p-ascending (reference
    # seed order)
    return (key[order], p_f[order], frag_f[order], order.to(_I32),
            valid.reshape(n, cap))


def _library():
    """The kernel's ctypes library, its entry points typed."""
    from tntblast_tpu_torch import _kernels
    lib = _kernels.load("pool")
    if lib.pool_launch_plan.argtypes is None:
        bind(lib)
    return lib


def bind(lib):
    """Sets the argument types of the entry points of a pool library (the
    package's, or the CPU tests' host build)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, types, res in (
            ("pool_plan_bytes", [], ctypes.c_int),
            ("pool_plan", [P, I, I, I], ctypes.c_int),
            ("pool_scratch_words", [P, I], ctypes.c_longlong),
            ("pool_launch_plan", [P] * 10 + [I, P], ctypes.c_int)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = res
    return lib


def make_plan(lib, *, num_os, cap, index):
    """A filled plan buffer of `lib`, or ValueError where the kernel
    refuses the shapes."""
    plan = (ctypes.c_uint64 * -(-lib.pool_plan_bytes() // 8))()
    rc = lib.pool_plan(plan, num_os, cap, index)
    if rc != 0:
        raise ValueError(f"pool: the kernel refuses num_os {num_os}, cap "
                         f"{cap}: CUDA error {rc}")
    return plan


def empty_outputs(n, cap, device):
    """The five outputs, uninitialised (the kernel writes every element)."""
    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    return (e((n * cap,), _I32), e((n * cap,), _I32), e((n * cap,), _I32),
            e((n * cap,), _I32), e((n, cap), torch.bool))


def launch_args(plan, slot, p, n_cand, out, scratch):
    """pool_launch_plan's arguments up to the stream."""
    return (plan, slot.data_ptr(), p.data_ptr(), n_cand.data_ptr(),
            *(t.data_ptr() for t in out), scratch.data_ptr(), slot.shape[0])


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"pool: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"pool: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"pool: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"pool: {name} must be contiguous")


class PoolPlan:
    """The kernel's one launch path: a panel's static shapes (num_os, cap)
    on one card, checked once, here.  A call then takes one step's

        slot, p (n, cap) int32, n_cand (n,) int32

    on the plan's card, contiguous, and reads only their pointers and n:
    the device step (panel_step_core) guarantees the rest, `pool` checks
    it.  It returns the five outputs, launches on the card's current
    stream, read each call, counts the call in `pool.launches`, and raises
    when a launch fails; there is no plain fallback, and CPU tensors are
    refused (a CPU panel runs the plain version)."""

    def __init__(self, device, *, num_os, cap):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"PoolPlan: {dev}; the plan serves a card")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.num_os, self.cap = int(num_os), int(cap)
        lib = _library()
        self._plan = make_plan(lib, num_os=self.num_os, cap=self.cap,
                               index=dev.index)
        self._per = lib.pool_scratch_words(self._plan, 1)
        self.device, self.index = dev, dev.index
        self._launch = lib.pool_launch_plan
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, slot, p, n_cand):
        if not slot.is_cuda:
            raise ValueError("PoolPlan: CPU tensors (call pool)")
        n = slot.shape[0]
        out = empty_outputs(n, self.cap, self.device)
        scratch = torch.empty(n * self._per, dtype=_I32, device=self.device)
        rc = self._launch(*launch_args(self._plan, slot, p, n_cand, out,
                                       scratch), self._stream(self.index))
        if rc != 0:
            raise RuntimeError(f"pool kernel launch failed: CUDA error {rc}")
        pool.launches += 1
        return out


def pool(slot, p, n_cand, *, num_os):
    """The pooling stage: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see the module docstring for the contract).
    Returns (slot_str, p_str, frag_str, order_str, valid)."""
    dev = slot.device
    if dev.type == "cpu":
        return pool_reference(slot, p, n_cand, num_os=int(num_os))
    if dev.type != "cuda":
        raise ValueError(f"pool: unsupported device {dev}")
    if slot.dim() != 2 or slot.shape[0] < 1 or slot.shape[1] < 1:
        raise ValueError(f"pool: slot must be (n, cap), got "
                         f"{tuple(slot.shape)}")
    n, cap = slot.shape
    for name, t, dtype, shape in (
            ("slot", slot, _I32, (n, cap)), ("p", p, _I32, (n, cap)),
            ("n_cand", n_cand, _I32, (n,))):
        _check(name, t, dev, dtype, shape)
    return PoolPlan(dev, num_os=num_os, cap=cap)(slot, p, n_cand)


pool.launches = 0
