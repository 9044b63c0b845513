"""Multi-process distributed runtime (the reference's MPI master/worker).

Port of tntblast_tpu/parallel/multiproc.py.  The reference scales across
machines with an MPI master that hands (query-block, target, fragment) work
items to workers and gathers packed `hybrid_sig` results (reference
tntblast_master.cpp:28, dispatch :429-511, gather :760-849;
tntblast_worker.cpp:23).  The equivalent here is an SPMD process group under
`torch.distributed`:

  * every process opens the database locally (no REMOTE pull-serving) and
    enumerates the SAME deterministic (target, fragment) work-item list the
    single-host engine uses (engine._fragment_work_items);
  * work items are partitioned by BASE COUNT with a deterministic LPT
    (longest-processing-time-first) assignment computed identically on
    every process — the replacement for the reference master's dynamic
    dispatch (tntblast_master.cpp:429-511): item costs are dominated by
    fragment length, the lengths are known up-front, and a
    communication-free balanced partition avoids both the dedicated
    scheduler rank and per-item round trips;
  * each process drives its own device through the fragment panel when a
    device flag is given (--tpu-screen / --tpu-frag / --mesh), in batches of
    the panel manager's size, one batch queued ahead of the host search;
  * per-hit secondary-structure Tms are computed worker-side, exactly
    like the reference worker (tntblast_worker.cpp:403-433);
  * results return to process 0 as length-prefixed byte blobs over an
    `all_gather` collective — the analogue of the chunked
    SIGNATURE_RESULTS mpi_pack stream (and of `synchronize_keys`: no
    string-table union is needed because strings ride inside each
    record);
  * process 0 re-applies the single-host accumulation order (prepend
    per work item), so the merged hit list is BYTE-IDENTICAL to the
    1-process run, then runs the identical output pipeline.

Run one process per rank:

    python -m tntblast_tpu_torch.parallel.multiproc \
        --coordinator 127.0.0.1:9876 --num-procs 2 --proc-id 0 \
        [--device cuda:0] -- \
        -i assays.txt -d db.fna -A PCR -e 40 -E 40 -o out.txt --tpu-screen T

A rank's device is `--device` if given, else `cuda:(proc-id modulo the
visible cards)`; with a device flag and no such device the rank raises (the
host search never stands in for a missing device).  With --mesh T a rank
spreads its fragments over every visible card, or over the one non-CUDA
device it was given.
"""

import datetime
import io
import os
import pickle
import sys
import time

import numpy as np
import torch

# Gather chunk size: bounds the peak allgather buffer at
# num_procs * GATHER_CHUNK bytes regardless of hit-list size — the
# analogue of the reference master's 1000-query SIGNATURE_RESULTS chunks
# (tntblast_master.cpp:760-849).
GATHER_CHUNK = 4 << 20

# How long a rank waits for the others to start (the rendezvous), in
# seconds: it ends the wait for a rank that never came up.
RENDEZVOUS_TIMEOUT_S = 600.0
# The result gather has no such limit, as the search has none: a rank that
# finished its shard waits for the slowest however long that takes (a skewed
# database can spread the ranks by hours).  A rank that raised closes its
# connections on the way out, and the ranks waiting for it fail at once.
GATHER_TIMEOUT = datetime.timedelta(days=365)


def _all_gather_u8(buf, num_processes, group=None):
    """(num_processes, len(buf)) uint8 array: every rank's `buf`."""
    import torch.distributed as dist

    got = [torch.empty_like(buf) for _ in range(num_processes)]
    dist.all_gather(got, buf, group=group)
    return torch.stack(got).numpy()


def _gather_blobs(payload, num_processes, group=None):
    """All-gather arbitrary per-process payloads as padded byte arrays
    (the SIGNATURE_RESULTS analogue), in fixed-size chunks so a giant
    hit list never materializes num_procs copies at once.  Runs over
    `group` (the default process group if None) on CPU tensors."""
    blob = np.frombuffer(pickle.dumps(payload), dtype=np.uint8)
    sizes = _all_gather_u8(
        torch.from_numpy(np.array([blob.size], dtype=np.int64).view(np.uint8)),
        num_processes, group).view(np.int64).reshape(num_processes)
    cap = int(sizes.max())
    rounds = max(1, -(-cap // GATHER_CHUNK))
    parts = [[] for _ in range(num_processes)]
    for r in range(rounds):
        lo = r * GATHER_CHUNK
        hi = min(lo + GATHER_CHUNK, cap)
        buf = np.zeros(hi - lo, dtype=np.uint8)
        if lo < blob.size:
            n = min(hi, blob.size) - lo
            buf[:n] = blob[lo:lo + n]
        got = _all_gather_u8(torch.from_numpy(buf), num_processes, group)
        for p in range(num_processes):
            take = min(max(int(sizes[p]) - lo, 0), hi - lo)
            if take:
                parts[p].append(got[p, :take])
    # the bytes are this program's own: every rank pickled its payload above
    return [pickle.loads(np.concatenate(parts[p]).tobytes())
            for p in range(num_processes)]


# copy of tntblast_tpu/parallel/multiproc.py:85-108 partition_items
def partition_items(items, num_processes):
    """Deterministic LPT partition of (target, start, stop, max_stop)
    work items by fragment base count.

    Returns a list: owner process id per item index.  Every process
    computes the identical assignment (sort by size descending with
    index tiebreak; assign to the least-loaded process, lowest id on
    ties), so no communication is needed — the load-balanced
    replacement for both the reference master's dynamic dispatch
    (tntblast_master.cpp:429-461) and a static idx % P shard, which has
    no answer to a skewed database."""
    import heapq

    sizes = [(-(stop - start + 1), idx)
             for idx, (_, start, stop, _) in enumerate(items)]
    sizes.sort()
    owner = [0] * len(items)
    heap = [(0, p) for p in range(num_processes)]
    heapq.heapify(heap)
    for neg_size, idx in sizes:
        load, p = heapq.heappop(heap)
        owner[idx] = p
        heapq.heappush(heap, (load - neg_size, p))
    return owner


def rank_device(process_id, device=None):
    """The torch device of a rank: `device` if given, else the rank's card,
    `cuda:(process_id % visible cards)`.  Raises where that card is
    missing."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {process_id}: device {device} requested but CUDA is "
                "not available")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {process_id}: no CUDA device is available (name another "
            "with --device)")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def _search_shard(opt, db, engine, process_id, num_processes, device=None):
    """Search this process's work items; returns
    (items_payload, fragment_target, panel_mgr) where items_payload is a
    list of (item_idx, [(sig_id, kept_hits)...]) — mirrors the reference
    worker loop (tntblast_worker.cpp:138-471) — and panel_mgr is the
    rank's device panel manager (None without a device flag).

    Like the single-host engine, each process drives its OWN local
    device(s) through the fragment panel: one process per host (or per
    card), that host's cards doing the seeding/screening/evaluation for its
    work items — the reference worker's compute role
    (tntblast_worker.cpp:200-361) mapped onto process-local devices.
    """
    from tntblast_tpu_torch import engine as eng
    from tntblast_tpu_torch.search.native_assays import (
        NativeFragContext, PanelAssays, search_assay)

    panel_mgr = None
    if (getattr(opt, "tpu_screen", False) or getattr(opt, "tpu_frag", False)
            or getattr(opt, "use_mesh", False)):
        from tntblast_tpu_torch.parallel.panel import FragmentPanelManager
        device = rank_device(process_id, device)
        mesh = None
        if getattr(opt, "use_mesh", False):
            from tntblast_tpu_torch.parallel.mesh import mesh_for
            # every visible card, or the one device the caller named
            mesh = mesh_for(device)
        panel_mgr = FragmentPanelManager(opt, engine, device, mesh=mesh)

    items, fragment_target = eng._fragment_work_items(opt, db)
    owner = partition_items(items, num_processes)
    mine = [idx for idx in range(len(items)) if owner[idx] == process_id]
    batch_n = panel_mgr.batch if panel_mgr is not None else 1

    def read_batch(b0):
        """This rank's work items [b0, b0 + batch_n): (idx, defline,
        codes) of each, and the queued device step of those long enough to
        hash (the step makes no host sync)."""
        frags = []
        for idx in mine[b0:b0 + batch_n]:
            tgt, start, stop, _ = items[idx]
            defline, seq_codes = db.read(
                tgt, start, stop + opt.max_product_length() + 2)
            frags.append((idx, defline, seq_codes))
        pending = None
        if panel_mgr is not None:
            dev_frags = [f[2] for f in frags
                         if len(f[2]) >= opt.hash_word_size]
            if dev_frags:
                pending = panel_mgr.submit_batch(dev_frags)
        return frags, pending

    assays = PanelAssays(opt.sig_list, opt)
    payload = []
    nxt = read_batch(0) if mine else None
    for b0 in range(0, len(mine), batch_n):
        frags, pending = nxt
        # the next batch's device step runs under this batch's host search
        nxt = (read_batch(b0 + batch_n) if b0 + batch_n < len(mine)
               else None)
        results = iter(panel_mgr.resolve_batch(pending)
                       if pending is not None else ())
        for idx, defline, seq_codes in frags:
            tgt, start, stop, max_stop = items[idx]
            target_len = len(seq_codes)
            if target_len < opt.hash_word_size:
                continue
            panel_result = next(results) if pending is not None else None
            ctx = NativeFragContext(engine, seq_codes, opt.hash_word_size,
                                    defline, panel_result=panel_result)
            per_sig = []
            if len(opt.sig_list) > 1:
                ctx.search_panel(assays, opt.sig_list)
            for sig in opt.sig_list:
                kept = []
                for h in search_assay(ctx, sig, opt):
                    # fragment-edge culling (reference worker :384-394)
                    if start != 0 and h.start_overlap(0):
                        continue
                    if stop != max_stop and h.stop_overlap(target_len - 1):
                        continue
                    h.seq_index = tgt
                    h.offset_ranges(start)
                    kept.append(h)
                eng.compute_secondary_tms(engine, kept, opt)
                per_sig.append((sig.id, kept))
            ctx.close()
            payload.append((idx, per_sig))
    if panel_mgr is not None:
        eng._warn_fallback(panel_mgr)
    return payload, fragment_target, panel_mgr


def distributed_main(argv, process_id, num_processes, coordinator,
                     stdout=None, device=None):
    """SPMD search entry; every process runs this with its own rank."""
    import torch.distributed as dist

    # The group carries one thing, the result gather, and its payload is
    # pickled host objects (hit records): gloo on every machine, the card's
    # too.  NCCL would need the bytes on the device and refuses two ranks
    # on one card, which is how a one-card machine runs two ranks.
    # The default group's timeout bounds the rendezvous alone; the gather
    # runs over a group of its own, made while every rank is known to be up.
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator}",
        rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    try:
        gather_group = dist.new_group(backend="gloo", timeout=GATHER_TIMEOUT)
        return _distributed_search(argv, process_id, num_processes, stdout,
                                   device, gather_group)
    finally:
        dist.destroy_process_group()


def _distributed_search(argv, process_id, num_processes, stdout, device,
                        gather_group=None):
    from tntblast_tpu_torch import constants as C
    from tntblast_tpu_torch import engine as eng
    from tntblast_tpu_torch import output as out
    from tntblast_tpu_torch.io.fastx import open_database
    from tntblast_tpu_torch.model import (
        read_input_file, expand_degenerate_signatures, multiplex_expansion)
    from tntblast_tpu_torch.options import Options, OptionsError

    is_root = process_id == 0
    if stdout is None:
        stdout = sys.stdout if is_root else io.StringIO()

    opt = Options()
    try:
        opt.parse(argv)
        if opt.input_filename:
            if opt.verbose:
                stdout.write(f"Reading assays from {opt.input_filename}\n")
            opt.sig_list = read_input_file(
                opt.input_filename, opt.ignore_probe,
                opt.assay_format == C.ASSAY_PROBE)
        if opt.multiplex:
            opt.sig_list = multiplex_expansion(opt.sig_list,
                                               opt.assay_format)
        opt.sig_list = expand_degenerate_signatures(
            opt.sig_list, opt.degen_rescale_ct)
        opt.validate_search_threshold()
        if len(opt.sig_list) == 0:
            raise OptionsError("No primers or probes found!")

        dbname = opt.dbase_filename or opt.local_dbase_filename
        if opt.verbose:
            stdout.write(f"Reading sequence database: {dbname}\n")
        db = open_database(dbname, blast_include=opt.blast_include,
                           blast_exclude=opt.blast_exclude)
        if db.size() == 0:
            raise OptionsError("Empty database -- no sequences found!")

        profile = time.time()
        melt = eng.make_melt_engine(
            opt, n_threads=int(os.environ.get("TNTBLAST_TPU_THREADS", 0))
            or None)

        t_search0 = time.time()
        payload, fragment_target, panel_mgr = _search_shard(
            opt, db, melt, process_id, num_processes, device)
        t_search = time.time() - t_search0

        # ---- result gather (SIGNATURE_RESULTS / synchronize_keys) ----
        t_g0 = time.time()
        shards = _gather_blobs(payload, num_processes, gather_group)
        if os.environ.get("TNTBLAST_TPU_PROFILE"):
            from tntblast_tpu_torch.ops import counts
            # one line a rank: a caller in another process reads from it
            # that the kernels ran here and nothing fell back
            launched = " ".join(f"{name}.launches {n}"
                                for name, n in counts().items())
            import resource
            print(f"rank {process_id}: setup "
                  f"{t_search0 - profile:.1f}s search {t_search:.1f}s "
                  f"gather {time.time() - t_g0:.1f}s "
                  f"device {panel_mgr.device if panel_mgr else None} "
                  f"{launched} "
                  f"stats {panel_mgr.stats if panel_mgr else None} "
                  f"maxrss "
                  f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} kB "
                  f"outside {_outside_modules()}",
                  file=sys.stderr)
        if not is_root:
            return 0

        # Re-apply the sequential accumulation order: work items in
        # ascending index, each prepending its kept hits (identical to
        # engine.run_search -> byte-identical final output).
        merged = []
        for shard in shards:
            merged.extend(shard)
        merged.sort(key=lambda kv: kv[0])

        state = eng.SearchState(len(opt.sig_list))
        state.fragment_target = fragment_target
        inverse_query = bool(opt.output_format & C.OUTPUT_INVERSE_QUERY)
        for _, per_sig in merged:
            for sig_id, kept in per_sig:
                if inverse_query:
                    if kept:
                        state.query_matches[sig_id] = True
                else:
                    state.search_results[sig_id] = (
                        kept + state.search_results[sig_id])

        # Output stream binding, identical to the local entry point
        # (cli.local_main / reference tntblast_local.cpp:72-133),
        # including -n T (one output file per query) on the root.
        fout = fout_sif = fout_atr = None
        if opt.output_filename:
            if not opt.one_output_file_per_query:
                if opt.output_format & (C.OUTPUT_STANDARD | C.OUTPUT_FASTA):
                    fout = open(opt.output_filename, "w")
                if opt.output_format & C.OUTPUT_NETWORK:
                    fout_sif = open(opt.output_filename + ".sif", "w")
            if opt.output_format & C.OUTPUT_NETWORK:
                fout_atr = open(opt.output_filename + ".atr", "w")
                fout_atr.write("FunctionalCatagory\n")
            if opt.output_format & (C.OUTPUT_INVERSE_TARGET
                                    | C.OUTPUT_INVERSE_QUERY):
                fout = open(opt.output_filename, "w")

        def open_per_query(name):
            nonlocal fout, fout_sif
            if opt.output_format & (C.OUTPUT_STANDARD | C.OUTPUT_FASTA):
                if fout is not None:
                    fout.close()
                fout = open(opt.output_filename + "." + name, "w")
            if opt.output_format & C.OUTPUT_NETWORK:
                if fout_sif is not None:
                    fout_sif.close()
                fout_sif = open(opt.output_filename + "." + name + ".sif",
                                "w")
            return (fout if fout is not None else stdout), fout_sif

        out.write_results(opt, state, db, stdout=stdout,
                          out_stream=fout if fout is not None else stdout,
                          sif_stream=fout_sif, atr_stream=fout_atr,
                          open_per_query=open_per_query
                          if opt.one_output_file_per_query else None)
        if opt.verbose:
            stdout.write(
                f"Search completed in {int(time.time() - profile)} sec\n")
        for fh in (fout, fout_sif, fout_atr):
            if fh is not None:
                fh.close()
    except OptionsError as e:
        print(f"Caught the error: {e}", file=sys.stderr)
        return 1
    return 0


def _outside_modules():
    """How many loaded modules belong to jax or to the JAX package (the
    profile line reports it: a rank is a process of its own, so only the
    rank can say)."""
    return sum(1 for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "tntblast_tpu"))


def main(argv=None):
    args = sys.argv[1:] if argv is None else list(argv)
    try:
        sep = args.index("--")
    except ValueError:
        print("usage: multiproc --coordinator H:P --num-procs N "
              "--proc-id I [--device D] -- <tntblast args>",
              file=sys.stderr)
        return 2
    own, rest = args[:sep], args[sep + 1:]
    kv = dict(zip(own[0::2], own[1::2]))
    return distributed_main(rest,
                            process_id=int(kv["--proc-id"]),
                            num_processes=int(kv["--num-procs"]),
                            coordinator=kv["--coordinator"],
                            device=kv.get("--device"))


if __name__ == "__main__":
    sys.exit(main())
