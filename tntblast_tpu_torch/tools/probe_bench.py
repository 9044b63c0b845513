"""The long-probe configurations: hybridization probes searched against the
bench genome for every site where they bind.

Users: panels of long hybridization or capture probes checked against a
genome for every site where they bind (`-A PROBE`): the 50- to 60-mers of
microarray and capture-probe panels (`long`), and the 150-mers of
oligo-pool and long capture probes, past the 120 nt a window of 128
columns holds (`wide`).  At their word lengths (7 and 8) a probe has 54 or
143 words, more than the 31 of the word-table seeding path, so every panel
of either configuration takes the dense seeding path (csrc/seed_dense.cu on
a card).

The probes (deterministic, from SEED): `nprobe` of `length` nt, the first
`nplant` taken from the bench genome (bench_data.py) at fixed offsets, half
as they stand and half reverse-complemented, so that the search has real
hits on both strands; the rest random.  The searches, over the bench genome
(4 sequences of 2 Mb, 500 kb fragments in tiles of 2^19):
  long  32 probes of 60 nt, `-A PROBE -E 40`: 64 oligo-strand slots,
        max_words 54, wq_max 60, wt_max 68, cap 131072 (parallel/panel.py
        MAX_CAP), eleven chunks of 98304 entries a step of 8 fragments
        (device_search.chunk_entries);
  wide  16 probes of 150 nt, `-A PROBE -E 40 -W 8`: 32 slots, max_words
        143, wq_max 150, wt_max 158, cap 77824 (twice the 36608 diagonals
        the panel's words seed on random sequence, plus 1024, in whole
        chunks of 4096), 28 chunks of 22400 entries a step (one chunk of
        32768 would hold 3.1 GB of M rows, over M_ROWS_BYTES).  At -W 7
        the expected diagonals (147k) would pass MAX_CAP.

    python -m tntblast_tpu_torch.tools.probe_bench [WORKDIR] [--wide]

writes WORKDIR/probes.txt (probes_wide.txt; default bench_work/, beside
the bench genome, which it builds first) and prints its path.
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
# the configurations: probes, planted probes, length, search arguments and
# the probe file's name
CONFIGS = {
    "long": dict(nprobe=NPROBE, nplant=NPLANT, length=PROBE_LEN,
                 args=PROBE_ARGS, file="probes.txt"),
    "wide": dict(nprobe=16, nplant=8, length=150,
                 args=["-A", "PROBE", "-E", "40", "-W", "8"],
                 file="probes_wide.txt"),
}


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


def probe_sequences(fna, config="long"):
    """[(name, sequence)] of the probes of `config` over the genome
    `fna`."""
    c = CONFIGS[config]
    n, nplant, length = c["nprobe"], c["nplant"], c["length"]
    rng = np.random.default_rng(SEED)
    seqs = read_sequences(fna)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    probes = []
    for i in range(n):
        if i < nplant:
            g = seqs[i % len(seqs)]
            x = int(rng.integers(0, len(g) - length))
            site = g[x:x + length]
            if i >= nplant // 2:
                site = site.translate(comp)[::-1]
            seq = site.decode()
        else:
            seq = BASES[rng.integers(0, 4, length)].tobytes().decode()
        probes.append((f"PROBE{i:02d}", seq))
    return probes


def build(fna, workdir, config="long"):
    """Writes the probe file of `config` (name, tab, probe) into `workdir`
    for the genome `fna` unless it is there; returns its path."""
    path = os.path.join(workdir, CONFIGS[config]["file"])
    if os.path.exists(path):
        return path
    os.makedirs(workdir, exist_ok=True)
    with open(path + ".tmp", "w") as fh:
        for name, seq in probe_sequences(fna, config):
            fh.write(f"{name}\t{seq}\n")
    os.replace(path + ".tmp", path)
    return path


def probe_argv(fna, probes, out_path, config="long"):
    """The search's arguments of `config` (the CLI's, without a device
    flag)."""
    return ["-i", probes, "-d", fna, *CONFIGS[config]["args"], "-o",
            out_path]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config = "wide" if "--wide" in argv else "long"
    argv = [a for a in argv if a != "--wide"]
    workdir = argv[0] if argv else os.path.join(os.getcwd(), "bench_work")
    sys.path.insert(0, os.getcwd())
    import bench_data

    fna, _ = bench_data.build(workdir)
    print(build(fna, workdir, config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
