#!/usr/bin/env python
"""Generate alignment parity fixtures by running the *reference* soap4.

Builds a synthetic genome + read pairs, indexes with the reference
2bwt-builder, aligns with reference soap4 in megapath mode, and stores
its cfq stdout as the golden. Committed goldens let tests compare our
engine without the reference. Usage:

    python tests/fixtures/make_align_fixtures.py \
        --soap4 /tmp/refbuild/soap4/soap4 \
        --builder /tmp/refbuild/soap4/2bwt-lib/2bwt-builder
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from megapath.index.pack import COMPLEMENT, decode_seq  # noqa: E402

READ_LEN = 80
INSERT = 300
N_CLEAN = 60
N_MUT = 30
N_JUNK = 10


def make_genome(rng):
    seqs = {
        "ecoli_1 Escherichia coli test": rng.integers(0, 4, 6000).astype(np.uint8),
        "salm_1 Salmonella test": rng.integers(0, 4, 5000).astype(np.uint8),
        "virus_1 Virus test": rng.integers(0, 4, 3000).astype(np.uint8),
    }
    return seqs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--soap4", default="/tmp/refbuild/soap4/soap4")
    ap.add_argument("--builder", default="/tmp/refbuild/soap4/2bwt-lib/2bwt-builder")
    ap.add_argument("--ini", default="/root/reference/soap4/soap4-nt2.ini")
    args = ap.parse_args()

    rng = np.random.default_rng(2024)
    seqs = make_genome(rng)

    fa = os.path.join(HERE, "align_genome.fa")
    with open(fa, "w") as f:
        for name, codes in seqs.items():
            f.write(f">{name}\n{decode_seq(codes)}\n")

    # reads
    names = list(seqs)
    keys = [n.split()[0] for n in names]
    r1_path = os.path.join(HERE, "align_r1.fq")
    r2_path = os.path.join(HERE, "align_r2.fq")
    truth_path = os.path.join(HERE, "align_truth.tsv")
    with open(r1_path, "w") as f1, open(r2_path, "w") as f2, open(truth_path, "w") as ft:
        qual = "I" * READ_LEN
        idx = 0

        def emit(r1, r2, label):
            nonlocal idx
            name = f"rd{idx:05d}_{label}"
            f1.write(f"@{name}/1\n{decode_seq(r1)}\n+\n{qual}\n")
            f2.write(f"@{name}/2\n{decode_seq(r2)}\n+\n{qual}\n")
            ft.write(f"{name}\t{label}\n")
            idx += 1

        for _ in range(N_CLEAN):
            s = int(rng.integers(0, len(names)))
            codes = seqs[names[s]]
            p = int(rng.integers(0, len(codes) - INSERT))
            r1 = codes[p : p + READ_LEN]
            seg = codes[p + INSERT - READ_LEN : p + INSERT]
            r2 = COMPLEMENT[seg[::-1]]
            emit(r1, r2, keys[s])

        for _ in range(N_MUT):
            s = int(rng.integers(0, len(names)))
            codes = seqs[names[s]]
            p = int(rng.integers(0, len(codes) - INSERT))
            r1 = codes[p : p + READ_LEN].copy()
            seg = seqs[names[s]][p + INSERT - READ_LEN : p + INSERT]
            r2 = COMPLEMENT[seg[::-1]].copy()
            for arr in (r1, r2):
                for _ in range(2):
                    q = int(rng.integers(0, READ_LEN))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
            emit(r1, r2, keys[s] + "_mut")

        for _ in range(N_JUNK):
            r1 = rng.integers(0, 4, READ_LEN).astype(np.uint8)
            r2 = rng.integers(0, 4, READ_LEN).astype(np.uint8)
            emit(r1, r2, "junk")

    # reference index + alignment
    subprocess.run([args.builder, fa], check=True, cwd=HERE,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    # NOTE: the reference soap4 must be built with the mmp_worker
    # missing-return fixed (modern g++ deletes the loop bound check of
    # a non-void function that falls off the end — see verify skill).
    golden = os.path.join(HERE, "align_golden.cfq")
    with open(golden, "w") as out:
        subprocess.run(
            [
                args.soap4, "pair", fa + ".index", r1_path, r2_path,
                "-C", args.ini, "-F", "-nc",
                "-L", "121", "-T", "4", "-u", "750", "-top", "95",
            ],
            check=True, stdout=out, stderr=subprocess.DEVNULL,
        )
    print("wrote", golden)


if __name__ == "__main__":
    main()
