"""Multi-device fragment search over a list of torch devices.

Port of tntblast_tpu/parallel/mesh.py.  The reference scales by handing
(target, fragment) work items to OpenMP threads or MPI workers (reference
tntblast_local.cpp:318-324, tntblast_master.cpp:429-511 — "database
segmentation").  The device equivalent is data parallelism over the
fragment axis:

  * database fragments are the split batch axis: device d of n_dev gets
    fragments [d * n_local, (d + 1) * n_local) of the padded batch,
  * the oligo panel, thermodynamic score tables and thresholds are
    replicated: one copy of the panel tables per device, uploaded once,
  * each device runs the pooled panel step (parallel/device_search.py) on
    its local fragments — seeding, compaction, and the chunked screening DP,
  * there is no collective: every device's outputs stay on that device and
    the host resolves one packed buffer per device, in submission order
    (the JAX step likewise leaves its outputs sharded and reads one shard
    per device).

Host-side exact re-scoring / pairing stays on the coordinator host exactly
like the reference master's reduce phase.
"""

import numpy as np
import torch

from tntblast_tpu_torch.parallel.device_search import DevicePanel


def make_mesh(devices=None):
    """The list of torch devices a MeshPanel spreads fragments over: all
    visible CUDA devices, or the given ones (any list; a device may repeat,
    each entry gets its own table replica)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available (pass a device "
                "list to build a mesh elsewhere)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: empty device list")
    if (any(d.type == "cuda" for d in mesh)
            and not torch.cuda.is_available()):
        raise RuntimeError(
            "make_mesh: a CUDA device was requested but CUDA is not "
            "available")
    return mesh


class MeshPanel(DevicePanel):
    """DevicePanel that fans a batch of fragments out across a device mesh.

    The panel (oligo words/tables/thresholds) is packed once and
    replicated; fragments split across devices; resolves unpack one packed
    buffer per device and return per-fragment host dicts in submission
    order — the same contract as DevicePanel, batched.
    """

    def __init__(self, panel, config, dg_tables, thresholds,
                 eval_dg=None, thermo_tables=None, *, mesh=None):
        self.mesh = make_mesh() if mesh is None else make_mesh(mesh)
        self.n_dev = len(self.mesh)
        self._replicas = None    # per-device panel tables, uploaded once
        super().__init__(panel, config, dg_tables, thresholds,
                         eval_dg=eval_dg, thermo_tables=thermo_tables,
                         device=self.mesh[0])

    def submit_fragments(self, frag_code_list, full=False):
        """Queue the step of every device for a batch of fragments (no
        host sync); resolve with `resolve_fragments`.  Pads the batch to a
        multiple of the mesh size with empty fragments (inert: zero
        seeds)."""
        n = len(frag_code_list)
        n_pad = -(-n // self.n_dev) * self.n_dev
        n_local = n_pad // self.n_dev
        padded = list(frag_code_list) + [
            np.zeros(0, np.uint8)] * (n_pad - n)
        if self._replicas is None:
            self._replicas = [self.tabs] + [
                self._tables_on(d) for d in self.mesh[1:]]
        outs = []
        for d, (device, tabs) in enumerate(zip(self.mesh, self._replicas)):
            payload = self._pack_host(
                padded[d * n_local:(d + 1) * n_local])
            # the step runs on its device's current stream: every device's
            # work is queued before any of it is resolved
            outs.append(self.step(payload, full=full, device=device,
                                  tabs=tabs))
        return (n, n_local), outs

    def _per_device(self, pending, resolver):
        (n, n_local), outs = pending
        results = []
        for block in outs:
            results.extend(resolver(n_local, block))
            if len(results) >= n:
                break
        return results[:n]

    def resolve_fragments(self, pending):
        return self._per_device(
            pending,
            lambda nl, block: DevicePanel.resolve_fragments(
                self, (nl, block)))

    def resolve_fragments_full(self, pending):
        return self._per_device(
            pending,
            lambda nl, block: DevicePanel.resolve_fragments_full(
                self, (nl, block)))
