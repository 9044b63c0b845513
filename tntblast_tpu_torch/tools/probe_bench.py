"""The long-probe configuration: hybridization probes of 60 nt searched
against the bench genome for every site where they bind.

Users: panels of long hybridization or capture probes (the 50- to 60-mers
of microarray and capture-probe panels) checked against a genome for every
site where they bind (`-A PROBE`).  At the default word length of 7 a probe
of 60 nt has 54 words, more than the 31 of the word-table seeding path, so
every panel of this configuration takes the dense seeding path
(csrc/seed_dense.cu on a card).

The probes (deterministic, from SEED): NPROBE of PROBE_LEN nt, the first
NPLANT taken from the bench genome (bench_data.py) at fixed offsets, half
as they stand and half reverse-complemented, so that the search has real
hits on both strands; the rest random.  The search: `PROBE_ARGS` over the
bench genome (4 sequences of 2 Mb): 64 oligo-strand slots, max_words 54,
wq_max 60, wt_max 68, 500 kb fragments in tiles of 2^19, cap 131072
(parallel/panel.py MAX_CAP), eleven chunks of 98304 entries a step of 8
fragments (device_search.chunk_entries).

    python -m tntblast_tpu_torch.tools.probe_bench [WORKDIR]

writes WORKDIR/probes.txt (default bench_work/, beside the bench genome,
which it builds first) and prints its path.
"""

import os
import sys

import numpy as np

NPROBE = 32
NPLANT = 16                 # probes cut from the genome; half reverse
PROBE_LEN = 60
SEED = 20261017
PROBE_ARGS = ["-A", "PROBE", "-E", "40"]
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def read_sequences(fna):
    """The sequences of a FASTA file as lists of uppercase bytes."""
    seqs, cur = [], []
    with open(fna, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if cur:
                    seqs.append(b"".join(cur))
                cur = []
            else:
                cur.append(line.strip().upper())
    if cur:
        seqs.append(b"".join(cur))
    return seqs


def probe_sequences(fna):
    """[(name, sequence)] of the NPROBE probes over the genome `fna`."""
    rng = np.random.default_rng(SEED)
    seqs = read_sequences(fna)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    probes = []
    for i in range(NPROBE):
        if i < NPLANT:
            g = seqs[i % len(seqs)]
            x = int(rng.integers(0, len(g) - PROBE_LEN))
            site = g[x:x + PROBE_LEN]
            if i >= NPLANT // 2:
                site = site.translate(comp)[::-1]
            seq = site.decode()
        else:
            seq = BASES[rng.integers(0, 4, PROBE_LEN)].tobytes().decode()
        probes.append((f"PROBE{i:02d}", seq))
    return probes


def build(fna, workdir):
    """Writes workdir/probes.txt (name, tab, probe) for the genome `fna`
    unless it is there; returns its path."""
    path = os.path.join(workdir, "probes.txt")
    if os.path.exists(path):
        return path
    os.makedirs(workdir, exist_ok=True)
    with open(path + ".tmp", "w") as fh:
        for name, seq in probe_sequences(fna):
            fh.write(f"{name}\t{seq}\n")
    os.replace(path + ".tmp", path)
    return path


def probe_argv(fna, probes, out_path):
    """The long-probe search's arguments (the CLI's, without a device
    flag)."""
    return ["-i", probes, "-d", fna, *PROBE_ARGS, "-o", out_path]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    workdir = argv[0] if argv else os.path.join(os.getcwd(), "bench_work")
    sys.path.insert(0, os.getcwd())
    import bench_data

    fna, _ = bench_data.build(workdir)
    print(build(fna, workdir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
