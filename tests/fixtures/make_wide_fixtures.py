#!/usr/bin/env python
"""Generate the WIDE soap4 parity fixture: 600 pairs covering clean /
mutated / indel-bearing / N-containing / 151 bp / junk reads, aligned
by the reference soap4 (cfq golden, -L 151).

NOTE on SAM-level goldens: soap4's BAM sink (-b) is memory-corrupt
under the modern toolchain on this machine — AddressSanitizer shows
wild-pointer reads of the query name inside initializeSAMAlgnmt2
(BGS-IO.cpp:552 via OutputDPResult.cpp:180's
queryNames[upkdReadIDs[...]-1] indirection) and the process segfaults
on every -b run, single-threaded included, while the cfq path is
clean. The committed golden is therefore cfq-level (best score + hit
sets); CIGAR/MAPQ evidence comes from planted-truth checks in
tests/test_parity_wide.py instead.

Usage: python tests/fixtures/make_wide_fixtures.py \
    [--soap4 /tmp/refbuild/soap4/soap4] \
    [--builder /tmp/refbuild/soap4/2bwt-lib/2bwt-builder]
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--soap4", default="/tmp/refbuild/soap4/soap4")
    ap.add_argument("--builder",
                    default="/tmp/refbuild/soap4/2bwt-lib/2bwt-builder")
    ap.add_argument("--ini", default="/root/reference/soap4/soap4-nt2.ini")
    args = ap.parse_args()

    out = os.path.join(HERE, "wide")
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(424)
    seqs = {
        "NC_000913.1 Escherichia": rng.integers(0, 4, 9000).astype(np.uint8),
        "NC_003197.1 Salmonella": rng.integers(0, 4, 7000).astype(np.uint8),
        "NC_045512.1 Virus": rng.integers(0, 4, 4000).astype(np.uint8),
    }
    fa = os.path.join(out, "genome.fa")
    with open(fa, "w") as f:
        for n, c in seqs.items():
            f.write(f">{n}\n{decode_seq(c)}\n")
    names = list(seqs)
    r1p, r2p = os.path.join(out, "r1.fq"), os.path.join(out, "r2.fq")
    truth = open(os.path.join(out, "truth.tsv"), "w")
    out1, out2 = open(r1p, "w"), open(r2p, "w")
    idx = 0

    def emit(s1, s2, tag, info=""):
        nonlocal idx
        nm = f"sr{idx:05d}_{tag}"
        out1.write(f"@{nm}/1\n{s1}\n+\n{'I'*len(s1)}\n")
        out2.write(f"@{nm}/2\n{s2}\n+\n{'I'*len(s2)}\n")
        truth.write(f"{nm}\t{tag}\t{info}\n")
        idx += 1

    def mkpair(c, L, ins):
        p = int(rng.integers(0, len(c) - ins))
        return (c[p : p + L].copy(),
                COMPLEMENT[c[p + ins - L : p + ins][::-1]].copy(), p)

    for _ in range(200):  # clean 100 bp
        s = names[int(rng.integers(0, 3))]
        a, b, p = mkpair(seqs[s], 100, 300)
        emit(decode_seq(a), decode_seq(b), "clean", f"{s.split()[0]}:{p}")
    for _ in range(100):  # mutated
        s = names[int(rng.integers(0, 3))]
        a, b, p = mkpair(seqs[s], 100, 300)
        for arr in (a, b):
            for _ in range(int(rng.integers(1, 5))):
                q = int(rng.integers(0, 100))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        emit(decode_seq(a), decode_seq(b), "mut", f"{s.split()[0]}:{p}")
    for _ in range(100):  # indel in read 1
        s = names[int(rng.integers(0, 3))]
        a, b, p = mkpair(seqs[s], 104, 310)
        k = int(rng.integers(1, 4))
        q = int(rng.integers(20, 80))
        if rng.integers(0, 2):
            a2 = np.concatenate([a[:q], a[q + k :]])
            kind = f"del{k}@{q}"
        else:
            a2 = np.concatenate(
                [a[:q], rng.integers(0, 4, k).astype(np.uint8), a[q:]]
            )[:104]
            kind = f"ins{k}@{q}"
        emit(decode_seq(a2[:100]), decode_seq(b[:100]), "indel",
             f"{s.split()[0]}:{p}:{kind}")
    for _ in range(50):  # N-containing
        s = names[int(rng.integers(0, 3))]
        a, b, p = mkpair(seqs[s], 100, 300)
        sa = list(decode_seq(a))
        for _ in range(int(rng.integers(1, 6))):
            sa[int(rng.integers(0, 100))] = "N"
        emit("".join(sa), decode_seq(b), "nn", f"{s.split()[0]}:{p}")
    for _ in range(100):  # 151 bp clean/mut
        s = names[int(rng.integers(0, 3))]
        a, b, p = mkpair(seqs[s], 151, 400)
        for arr in (a, b):
            for _ in range(int(rng.integers(0, 4))):
                q = int(rng.integers(0, 151))
                arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
        emit(decode_seq(a), decode_seq(b), "l151", f"{s.split()[0]}:{p}")
    for _ in range(50):  # junk
        emit(decode_seq(rng.integers(0, 4, 100).astype(np.uint8)),
             decode_seq(rng.integers(0, 4, 100).astype(np.uint8)), "junk")
    out1.close()
    out2.close()
    truth.close()

    subprocess.run([args.builder, fa], check=True, cwd=out,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    golden = os.path.join(out, "golden.cfq")
    with open(golden, "w") as gf:
        subprocess.run(
            [args.soap4, "pair", fa + ".index", r1p, r2p,
             "-C", args.ini, "-F", "-nc",
             "-L", "151", "-T", "4", "-u", "750", "-top", "95"],
            check=True, stdout=gf, stderr=subprocess.DEVNULL,
        )
    for f in os.listdir(out):
        if ".index" in f:
            os.remove(os.path.join(out, f))
    print("wrote", golden, f"({idx} pairs)")


if __name__ == "__main__":
    main()
