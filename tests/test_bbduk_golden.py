"""BBDuk oracle goldens: a direct transliteration of BBDuk2.java's
arithmetic (no Java runtime in this image) drives byte-level goldens
for the three stage-0 primitives under the MegaPath driver flags
(kmask=N qtrim=rl trimq=10 hdist=1; pass 2 entropy=0.75):

  * averageEntropy  — BBDuk2.java:3161-3248 (sliding countCounts fold,
    measurement window ``i2>=-1 && i<len``, entropy table :817-823)
  * testOptimal     — align2/TrimRead.java:264-315 (float32 Kadane,
    PROB_ERROR[0]=0.8f from QualityTools.makeQualityToFloat)
  * kmask           — BBDuk2.java:2953-3050 (canonical max(kmer,rkmer)
    middle-masked lookup, hit span [i-k+1-trimPad, i+trimPad],
    forbidNs=false because the driver's hdist=1, BBDuk2.java:559)

The oracle functions below are written against the Java line by line
(scalar loops, float32 where Java uses float) and are deliberately
structured differently from megapath.filters.bbduk's vectorized
implementations. A pinned byte golden (this file's GOLDEN constant)
locks the oracle's own output so regressions in either side surface.
"""

import numpy as np
import pytest

from megapath.filters.bbduk import (
    KmerRef,
    average_entropy,
    build_kmer_ref,
    kmask,
    quality_trim,
)

BASE = {"A": 0, "C": 1, "G": 2, "T": 3}


def enc(s: str) -> np.ndarray:
    # Dedupe.baseToNumber: non-ACGT (incl. N) -> 0
    return np.array([BASE.get(c, 0) for c in s], dtype=np.uint8)


# ---------------------------------------------------------------------------
# Java oracles (scalar transliterations)
# ---------------------------------------------------------------------------


def java_prob_error():
    """QualityTools.makeQualityToFloat(127)."""
    r = np.power(10.0, -0.1 * np.arange(127)).astype(np.float32)
    r[0] = np.float32(0.8)
    return r


def java_test_optimal(seq: str, quals: list, trimq: int = 10):
    """TrimRead.testOptimal: returns (left_trim, right_trim)."""
    PROB = java_prob_error()
    avg = PROB[trimq]
    nprob = np.float32(max(min(np.float32(avg) * np.float32(1.1), 1.0), 0.75))
    max_score = np.float32(0)
    score = np.float32(0)
    max_loc = -1
    max_count = -1
    count = 0
    for i, b in enumerate(seq):
        p = nprob if b == "N" else PROB[quals[i]]
        delta = np.float32(avg) - np.float32(p)
        score = np.float32(score + delta)
        if score > 0:
            count += 1
            if score > max_score or (score == max_score and count > max_count):
                max_score, max_count, max_loc = score, count, i
        else:
            score = np.float32(0)
            count = 0
    if max_score > 0:
        return max_loc - max_count + 1, len(seq) - max_loc - 1
    return 0, len(seq)


def java_average_entropy(seq: str, k: int = 5, window: int = 50):
    """BBDuk2.averageEntropy (scalar, double accumulation like Java)."""
    entropy = np.zeros(window + 2)
    for i in range(window + 2):
        pk = i / window
        entropy[i] = pk * np.log(pk) if pk > 0 else 0.0
    mult = -1.0 / np.log(window)
    kspace = 1 << (2 * k)
    mask = kspace - 1
    counts = np.zeros(kspace, np.int32)
    cc = np.zeros(window + 2, np.int32)
    cc[0] = window
    kmer = kmer2 = 0
    esum, nmeas = 0.0, 0
    n = len(seq)
    i2 = -window
    for i in range(n + window):
        if i < n:
            b = seq[i] if seq[i] in "ACGT" else "A"
            kmer = ((kmer << 2) | BASE[b]) & mask
            cc[counts[kmer]] -= 1
            counts[kmer] += 1
            cc[counts[kmer]] += 1
        if i2 >= 0:
            b2 = seq[i2] if seq[i2] in "ACGT" else "A"
            kmer2 = ((kmer2 << 2) | BASE[b2]) & mask
            cc[counts[kmer2]] -= 1
            counts[kmer2] -= 1
            cc[counts[kmer2]] += 1
        if i2 >= -1 and i < n:
            s = sum(int(cc[j]) * entropy[j] for j in range(1, window + 2))
            esum += s * mult
            nmeas += 1
        i2 += 1
    return float(np.float32(esum / max(1, nmeas)))


def java_store_kmers(refs, k, hdist=1, mask_middle=True):
    """Table load: canonical max(kmer, rkmer) of every ref k-mer and
    its Hamming<=hdist mutants, middle base cleared."""
    mm = ~(3 << (2 * (k // 2))) & ((1 << (2 * k)) - 1) if mask_middle else -1

    def rc(v):
        out = 0
        for _ in range(k):
            out = (out << 2) | (3 - (v & 3))
            v >>= 2
        return out

    stored = set()
    for s in refs:
        codes = enc(s)
        for i in range(len(s) - k + 1):
            v = 0
            for c in codes[i : i + k]:
                v = (v << 2) | int(c)
            muts = {v}
            if hdist >= 1:
                for pos in range(k):
                    for sub in range(4):
                        muts.add(
                            (v & ~(3 << (2 * pos))) | (sub << (2 * pos))
                        )
            for m in muts:
                stored.add(max(m, rc(m)) & mm)
    return stored, mm


def java_kmask(seq: str, stored, mm, k, trim_pad=0):
    """BBDuk2.kmask scan: query canonical middle-masked k-mer at every
    end position i>=k-1; a hit sets [max(0,i-(k-1-trimPad)), i+trimPad]."""
    mask_bits = np.zeros(len(seq), bool)
    kmer = rkmer = 0
    full = (1 << (2 * k)) - 1
    shift2 = 2 * (k - 1)
    for i, b in enumerate(seq):
        x = BASE.get(b, 0)
        kmer = ((kmer << 2) | x) & full
        rkmer = (rkmer >> 2) | ((3 - x) << shift2)
        if i >= k - 1:
            key = max(kmer, rkmer) & mm
            if key in stored:
                lo = max(0, i - (k - 1 - trim_pad))
                hi = min(len(seq) - 1, i + trim_pad)
                mask_bits[lo : hi + 1] = True
    return mask_bits


# ---------------------------------------------------------------------------
# adversarial inputs
# ---------------------------------------------------------------------------

ADAPTER = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC"  # TruSeq-style, 34 bp

ENTROPY_CASES = [
    "A" * 80,
    "ACGT" * 30,
    ("ACGTTGCAGGTCTTAAGCCTGATCGGCATTAGCCGATCAGGCT" * 3)[:120],
    "AAAAACCCCCGGGGGTTTTT" * 5,
    "ACGTN" * 24,
    "AC" * 60,
    "A" * 49,  # shorter than the window -> zero measurements
    "GATTACA" * 20,
]

QTRIM_CASES = [
    ("ACGTACGTACGTACGTACGT", [2, 2, 30, 30, 30, 30, 30, 30, 30, 30,
                              30, 30, 30, 30, 30, 30, 2, 2, 2, 2]),
    ("ACGTNCGTACGTACGTACGT", [30] * 20),
    ("ACGTACGTACGT", [2] * 12),  # all bad -> fully trimmed
    ("ACGTACGTACGTACGTACGTACGTACGTACGT",
     [0, 15, 40, 0, 40, 40, 12, 9, 40, 40, 40, 40, 40, 40, 40, 40,
      40, 2, 40, 40, 40, 40, 3, 3, 40, 40, 40, 40, 2, 2, 2, 2]),
    ("NNNNACGTACGTACGTACGT", [2, 2, 2, 2] + [35] * 16),
]

KMASK_CASES = [
    "C" * 20 + ADAPTER + "G" * 26,            # exact adapter, middle
    ADAPTER[:30] + "T" * 50,                  # truncated at k+3 on left
    "T" * 50 + ADAPTER,                       # right edge
    "C" * 20 + ADAPTER[:13] + "A" + ADAPTER[14:] + "G" * 26,  # 1 sub
    "C" * 20 + ADAPTER[:13] + "AC" + ADAPTER[15:] + "G" * 26,  # 2 subs
    "C" * 20 + ADAPTER[:20] + "N" + ADAPTER[21:] + "G" * 26,   # N inside
    "ACGTAGCTAGCATCGATCGATCGGCTAGCTAGCATCGATCGATCAGCT" * 2,  # no adapter
]

# Oracle outputs pinned as bytes: regenerate ONLY by re-running the
# oracle functions above (python tests/test_bbduk_golden.py).
GOLDEN = """\
entropy 0 0.0000000000000000
entropy 1 0.3566836118698120
entropy 2 0.9513867497444153
entropy 3 0.7600587010383606
entropy 4 0.4128125607967377
entropy 5 0.1801980733871460
entropy 6 0.0000000000000000
entropy 7 0.4981126189231873
qtrim 0 2 4
qtrim 1 5 0
qtrim 2 0 12
qtrim 3 4 15
qtrim 4 4 0
kmask 0 20 53
kmask 1 0 31
kmask 2 50 83
kmask 3 20 53
kmask 4 20 53
kmask 5 20 53
kmask 6 -1 -1
"""


def _oracle_lines():
    lines = []
    for i, s in enumerate(ENTROPY_CASES):
        lines.append(f"entropy {i} {java_average_entropy(s):.16f}")
    for i, (s, q) in enumerate(QTRIM_CASES):
        left, right = java_test_optimal(s, q)
        lines.append(f"qtrim {i} {left} {right}")
    stored, mm = java_store_kmers([ADAPTER], k=27, hdist=1)
    for i, s in enumerate(KMASK_CASES):
        bits = java_kmask(s, stored, mm, k=27)
        nz = np.flatnonzero(bits)
        lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (-1, -1)
        lines.append(f"kmask {i} {lo} {hi}")
    return "\n".join(lines) + "\n"


def test_oracle_matches_pinned_golden():
    assert _oracle_lines() == GOLDEN


def test_average_entropy_vs_java_oracle():
    L = max(len(s) for s in ENTROPY_CASES)
    codes = np.zeros((len(ENTROPY_CASES), L), np.uint8)
    lens = np.zeros(len(ENTROPY_CASES), np.int32)
    for i, s in enumerate(ENTROPY_CASES):
        codes[i, : len(s)] = enc(s)
        lens[i] = len(s)
    ours = average_entropy(codes, lens)
    for i, s in enumerate(ENTROPY_CASES):
        want = java_average_entropy(s)
        assert ours[i] == pytest.approx(want, abs=1e-6), (i, s[:20])


def test_quality_trim_vs_java_oracle():
    L = max(len(s) for s, _ in QTRIM_CASES)
    quals = np.zeros((len(QTRIM_CASES), L), np.int16)
    is_n = np.zeros((len(QTRIM_CASES), L), bool)
    lens = np.zeros(len(QTRIM_CASES), np.int32)
    for i, (s, q) in enumerate(QTRIM_CASES):
        quals[i, : len(q)] = q
        is_n[i, : len(s)] = np.frombuffer(s.encode(), np.uint8) == ord("N")
        lens[i] = len(s)
    start, stop = quality_trim(quals, is_n, lens, trimq=10)
    for i, (s, q) in enumerate(QTRIM_CASES):
        left, right = java_test_optimal(s, q)
        n = len(s)
        if left == 0 and right == n:  # fully trimmed
            assert start[i] == stop[i], (i, start[i], stop[i])
        else:
            assert (int(start[i]), n - int(stop[i])) == (left, right), i


def test_kmask_vs_java_oracle():
    ref = build_kmer_ref([ADAPTER], k=27, hdist=1)
    stored, mm = java_store_kmers([ADAPTER], k=27, hdist=1)
    L = max(len(s) for s in KMASK_CASES)
    codes = np.zeros((len(KMASK_CASES), L), np.uint8)
    is_n = np.zeros((len(KMASK_CASES), L), bool)
    lens = np.zeros(len(KMASK_CASES), np.int32)
    for i, s in enumerate(KMASK_CASES):
        codes[i, : len(s)] = enc(s)
        is_n[i, : len(s)] = np.frombuffer(s.encode(), np.uint8) == ord("N")
        lens[i] = len(s)
    ours = kmask(codes, lens, is_n, ref)
    for i, s in enumerate(KMASK_CASES):
        want = java_kmask(s, stored, mm, k=27)
        np.testing.assert_array_equal(
            ours[i, : len(s)], want, err_msg=f"case {i}"
        )


def test_kmask_vs_java_oracle_randomized():
    rng = np.random.default_rng(42)
    ref = build_kmer_ref([ADAPTER], k=27, hdist=1)
    stored, mm = java_store_kmers([ADAPTER], k=27, hdist=1)
    B, L = 24, 100
    reads = []
    for b in range(B):
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
        if b % 3 == 0:  # splice a (possibly mutated) adapter fragment
            frag = list(ADAPTER[: int(rng.integers(27, 35))])
            for _ in range(int(rng.integers(0, 3))):
                frag[int(rng.integers(0, len(frag)))] = "ACGTN"[
                    int(rng.integers(0, 5))
                ]
            p = int(rng.integers(0, L - len(frag)))
            s = s[:p] + "".join(frag) + s[p + len(frag):]
        reads.append(s)
    codes = np.stack([enc(s) for s in reads])
    is_n = np.stack(
        [np.frombuffer(s.encode(), np.uint8) == ord("N") for s in reads]
    )
    lens = np.full(B, L, np.int32)
    ours = kmask(codes, lens, is_n, ref)
    for i, s in enumerate(reads):
        want = java_kmask(s, stored, mm, k=27)
        np.testing.assert_array_equal(ours[i], want, err_msg=f"read {i}")


if __name__ == "__main__":
    print(_oracle_lines(), end="")
