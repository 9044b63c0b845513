# Port of tntblast_tpu/cli.py: the same flags, messages and exit codes;
# local_main takes the torch device of the device step.
"""Command-line entry point (reference: tntblast.cpp:28-79 +
tntblast_local.cpp:25-231): parses options, reads assays, expands
multiplex/degenerate queries, opens the database, runs the search and
writes results.  Exit codes and error messages match the reference."""

import contextlib
import os
import sys
import time

from tntblast_tpu_torch import constants as C
from tntblast_tpu_torch import engine as eng
from tntblast_tpu_torch import output as out
from tntblast_tpu_torch import trace
from tntblast_tpu_torch.io.fastx import open_database
from tntblast_tpu_torch.model import (
    read_input_file, expand_degenerate_signatures, multiplex_expansion)
from tntblast_tpu_torch.options import Options, OptionsError


def usage_text():
    """Byte-identical reproduction of the reference usage screen
    (reference options.cpp:420-498, constants from tntblast.h), with the
    device-path flags appended at the end."""
    return (
        f"thermonucleotideBLAST v.{C.VERSION}\n"
        "Options:\n"
        "\t-i <input file of query oligos>\n"
        "\t-o <output file> (default is stdout)\n"
        "\t-d <database of target sequences to search against>\n"
        "\t[-D <local database of target sequences to search against>]\n"
        "\t[-l <maximum amplicon length> (default is 2000 bases)\n"
        "\t-e <minimum primer Tm>\n"
        "\t-E <minimum probe Tm>\n"
        "\t[-z <minimum primer delta G (in Kcal/Mol)>] (default is no limit)\n"
        "\t[-Z <minimum probe delta G (in Kcal/Mol)>] (default is no limit)\n"
        "\t[-x <maximum primer Tm>] (default is no limit)\n"
        "\t[-X <maximum probe Tm>] (default is no limit)\n"
        "\t[-g <maximum primer delta G (in Kcal/Mol)>] (default is no limit)\n"
        "\t[-G <maximum probe delta G(in Kcal/Mol)>] (default is no limit)\n"
        "\t[-s <salt concentration (in MOL)>] (default is 0.05 M)\n"
        "\t[-t <primer strand concentration (in MOL)>] (default is 9e-07 M)\n"
        "\t[-T <Probe strand concentration (in MOL)>] (default is 2.5e-07 M)\n"
        "\t[-y <ratio of forward/reverse strand concentrations>] (default is 1, i.e. symmetric PCR)\n"
        "\t[-A <PCR | PROBE | PADLOCK | MIPS | AFFY>] (assay format, default is PCR)\n"
        "\t[-W <2-8>] (hash word length, default is 7)\n"
        "\t[-m <output format>] \n"
        "\t\t0 = verbose output file (default)\n"
        "\t\t1 = fasta output file\n"
        "\t\t2 = network output files (*.atr and *.sif)\n"
        "\t\t3 = \"inverse target\" (targets that *don't* match any query)\n"
        "\t\t4 = \"inverse query\" (queries that *don't* match any target)\n"
        "\t[-a <T|F>] (show alignments, default is T)\n"
        "\t[-M <T|F>] (show matching sequence, default is T)\n"
        "\t[-k <T|F>] (Mask primer binding sites, default is F)\n"
        "\t[-K <T|F>] (Mask probe binding sites, default is F)\n"
        "\t[-r <T|F>] (Replace primer binding sites w/ primer sequence, default is F)\n"
        "\t[-v <T|F>] (Disable verbose terminal output, default is T)\n"
        "\t[-p <T|F>] (Ignore all probe oligos in inputfile, default is F)\n"
        "\t[-n <T|F>] (One output file per query, default is F)\n"
        "\t[-L <T|F>] (Append assay name to output defline, default is F)\n"
        "\t[-S <T|F>] (Ouput assay summary after searching, default is F)\n"
        "\t[-h|-?] (Command-line usage)\n"
        "\t[--primer-clamp <number of exact 3' primer matches required>] (default is 0 bases)\n"
        "\t[--min-max-primer-clamp <the minimum max number of exact 3' primer matches required>] (default is no limit)\n"
        "\t[--probe-clamp5 <number of exact 5' probe matches required>] (default is 0 bases)\n"
        "\t[--probe-clamp3 <number of exact 3' probe matches required>] (default is 0 bases)\n"
        "\t[--dangle5 <T|F>] (Allow dangling bases on the 5' query side of an alignment, default is F)\n"
        "\t[--dangle3 <T|F>] (Allow dangling bases on the 3' query side of an alignment, default is F)\n"
        "\t[--plex <T|F>] (All input assays in a single multiple reaction, default is F)\n"
        "\t[--temperature <temperature for computing Delta G (in Kelvin)>] (default is 310.15 K)\n"
        "\t[--single-primer-pcr <T|F>] (Allow amplicons produced by a single PCR primer binding in both forward and reverse orientation, default is T)\n"
        "\t[--target-strand <plus|minus|both>] (which strand to target with probes, default is \"both\")\n"
        "\t[--max-target-len <max len>] (max sequence length before targets are split, default is 500000 bases)\n"
        "\t[--query-seg <always | never | adaptive>] (query segmentation algorithm, default is \"never\")\n"
        "\t[--dump-query <T|F>] (write queries to stdout, default is F)\n"
        "\t[--dinkelbach <T|F>] (Use the Dinkelbach fractional programming algorithm, default is F)\n"
        "\t[--max-gap <number of gaps>] (Max number of allowed gaps in a DNA duplex, default is 999)\n"
        "\t[--max-mismatch <number of mismatches>] (Max number of allowed mismatches in a DNA duplex, default is 999)\n"
        "\t[--max-poly-degen <number of bases>] (maximum number of contiguous, fully or partially degenerate bases to allow in an oligo alignment, default is 3)\n"
        "\t[--rescale-ct <T|F>] (Use of degenerate bases results in rescaling of oligo concentration, default is T)\n"
        "\t[--best-match] (Only save the best match, in Tm, between a query and target)\n"
        "\t[--blast-include <Limit search to include accessions or NCBI TaxIds from a BLAST database>] (may be repeated)\n"
        "\t[--blast-exclude <Limit search to exclude accessions or NCBI TaxId from a BLAST database>] (may be repeated)\n"
        "\t[--tpu-screen <T|F>] (TPU seed+screen pipeline; output-invariant, default is F)\n"
        "\t[--tpu-frag <T|F>] (synonym for --tpu-screen)\n"
        "\t[--mesh <T|F>] (shard fragments over all torch devices; output-invariant, default is F)\n"
    )


def local_main(argv, stdout=None, device="cuda"):
    """reference tntblast_local.cpp:25-1394, device step on `device`.  The
    search is traced (trace.py) where TNTBLAST_TPU_PROFILE is set or a
    torch.profiler session records; with TNTBLAST_TPU_PROFILE its span
    summary follows the [profile] lines."""
    if stdout is None:
        stdout = sys.stdout
    # cli.options ends where the database opens; the stack ends it on an
    # early return too
    with trace.search("cli.search") as root, \
            contextlib.ExitStack() as options:
        rc = _search(argv, stdout, device, options)
    if root.traced and os.environ.get("TNTBLAST_TPU_PROFILE"):
        print(f"[profile] {trace.summary(root.search)}", file=sys.stderr)
    return rc


def _search(argv, stdout, device, options):
    options.enter_context(trace.span("cli.options"))
    opt = Options()
    try:
        opt.parse(argv)
    except OptionsError as e:
        print(f"Input error: {e}", file=sys.stderr)
        return 1

    if opt.print_usage:
        sys.stderr.write(usage_text())
        return 1
    trace.annotate(assay_format=opt.assay_format)

    try:
        if opt.input_filename:
            if opt.verbose:
                stdout.write(f"Reading assays from {opt.input_filename}\n")
            opt.sig_list = read_input_file(
                opt.input_filename, opt.ignore_probe,
                opt.assay_format == C.ASSAY_PROBE)

        # Output stream binding (reference tntblast_local.cpp:72-133)
        fout = None
        fout_sif = None
        fout_atr = None
        if opt.output_filename == "":
            ptr_out = stdout
        else:
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
            ptr_out = fout if fout is not None else stdout

        if opt.multiplex:
            opt.sig_list = multiplex_expansion(opt.sig_list, opt.assay_format)
        opt.sig_list = expand_degenerate_signatures(
            opt.sig_list, opt.degen_rescale_ct)

        if opt.dump_query:
            opt.write_queries(stdout)

        opt.validate_search_threshold()

        if len(opt.sig_list) == 0:
            raise OptionsError("tntblast_local.cpp:local_main: No primers or "
                               "probes found!")

        options.close()
        dbname = opt.dbase_filename or opt.local_dbase_filename
        if opt.verbose:
            stdout.write(f"Reading sequence database: {dbname}\n")
        with trace.span("io.open"):
            db = open_database(dbname, blast_include=opt.blast_include,
                               blast_exclude=opt.blast_exclude)
            num_seq = db.size()
            if num_seq == 0:
                raise OptionsError("tntblast_local.cpp:local_main: Empty "
                                   "database -- no sequences found!")
            effective_num_seq = db.effective_size(
                opt.fragment_target_threshold)
        if opt.verbose:
            stdout.write(f"Found {num_seq} database sequences")
            if num_seq == effective_num_seq:
                stdout.write("\n")
            else:
                stdout.write(f" ({effective_num_seq} after fragmentation)\n")
            out.echo_options(opt, stdout)

        profile = time.time()

        with trace.span("cli.melt_engine"):
            melt = eng.make_melt_engine(
                opt, n_threads=int(os.environ.get("TNTBLAST_TPU_THREADS", 0))
                or None)
        state = eng.run_search(opt, db, melt, stdout=stdout, device=device)

        if os.environ.get("TNTBLAST_TPU_PROFILE"):
            # reference PROFILE analogue (tntblast_worker.cpp:124-265):
            # exact-evaluation and screening work counters
            pr = getattr(state, "profile", {})
            print(f"[profile] exact melt evaluations = "
                  f"{pr.get('evaluated', 0)}", file=sys.stderr)
            print(f"[profile] device-evaluated windows = "
                  f"{pr.get('dev_evaluated', 0)}", file=sys.stderr)
            print(f"[profile] screened windows (host+device) = "
                  f"{pr.get('screened', 0)}", file=sys.stderr)
            print(f"[profile] device screen calls = "
                  f"{pr.get('device_calls', 0)}", file=sys.stderr)
            ph = getattr(state, "phases", {})
            if ph:
                tot = sum(ph.values()) or 1
                print("[profile] native phase cycles: " + "  ".join(
                    f"{k}={v} ({100.0 * v / tot:.1f}%)"
                    for k, v in ph.items()), file=sys.stderr)
            import resource
            print(f"[profile] peak host memory = "
                  f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} kB",
                  file=sys.stderr)
            if "device_stats" in pr:
                # the device path's one line, in the form of a rank's
                # (tools/launches.py rank_counts reads either)
                from tntblast_tpu_torch.ops import counts
                launched = " ".join(f"{name}.launches {n}"
                                    for name, n in counts().items())
                print(f"[profile] device {pr['device']} {launched} "
                      f"stats {pr['device_stats']}", file=sys.stderr)

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

        with trace.span("cli.output"):
            trace.count("output.records",
                        sum(len(r) for r in state.search_results))
            out.write_results(
                opt, state, db, stdout=stdout, out_stream=ptr_out,
                sif_stream=fout_sif, atr_stream=fout_atr,
                open_per_query=open_per_query
                if opt.one_output_file_per_query else None)

            profile = int(time.time() - profile)
            if opt.verbose:
                stdout.write(f"Search completed in {profile} sec\n")

            for fh in (fout, fout_sif, fout_atr):
                if fh is not None:
                    fh.close()
    except OptionsError as e:
        print(f"Caught the error: {e}", file=sys.stderr)
        return 1
    except (ValueError, OSError) as e:
        print(f"Caught the std exception: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    n_threads = int(os.environ.get("TNTBLAST_TPU_THREADS", 0)) \
        or (os.cpu_count() or 1)
    print(f"Running on local machine [{n_threads} thread(s)]")
    return local_main(argv)


if __name__ == "__main__":
    sys.exit(main())
