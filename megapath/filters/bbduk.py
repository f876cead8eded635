"""bbduk-style read preprocessing: adapter kmask + quality trim + entropy.

Batch-vectorized equivalent of the two BBDuk2 invocations in
runMegaPath.sh:119 (/root/reference/bbmap/current/jgi/BBDuk2.java):

1. ``kmask=N qtrim=rl trimq=10 minlength=50 ref=adapters.fa hdist=1``:
   reference k-mers (k=27, both strands, middle base wildcarded,
   Hamming<=1 neighborhood) mark matching spans which are rewritten to
   N; then optimal quality trimming (Kadane max-subarray over
   error-probability deltas, TrimRead.testOptimal); pairs where either
   end falls under minlength are dropped.
2. ``entropy=0.75``: sliding 50-wide window of 5-mer counts; window
   entropy from count-of-counts (BBDuk2.averageEntropy:3161-3248);
   reads whose average window entropy is below the cutoff are split to
   the low-complexity output.

All scans are (batch,) numpy vector steps over read positions — the
same shape the jitted device path uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from megapath.index.pack import encode_seq
from megapath.io.fastq import FastqRecord, read_fastx

# byte -> 2-bit code (non-ACGT -> 0 = 'A', Dedupe.baseToNumber default)
_ENC_LUT = np.zeros(256, np.uint8)
for _b, _v in zip(b"ACGTacgt", (0, 1, 2, 3, 0, 1, 2, 3)):
    _ENC_LUT[_b] = _v
_IS_ACGT_LUT = np.zeros(256, bool)
_IS_ACGT_LUT[np.frombuffer(b"ACGTacgt", np.uint8)] = True

NPROB = 0.75  # TrimRead.NPROB


# QualityTools.PROB_ERROR (makeQualityToFloat): float32 10^(-q/10)
# with the q=0 slot pinned to 0.8f, not 1.0
_PROB_ERROR = np.power(
    10.0, -0.1 * np.arange(127, dtype=np.float64)
).astype(np.float32)
_PROB_ERROR[0] = np.float32(0.8)


def phred_error(q: np.ndarray) -> np.ndarray:
    return _PROB_ERROR[np.clip(np.asarray(q, np.int64), 0, 126)]


# ---------------------------------------------------------------------------
# adapter k-mer table
# ---------------------------------------------------------------------------


@dataclass
class KmerRef:
    """Sorted canonical k-mer array for adapter/contaminant matching."""

    k: int
    kmers: np.ndarray  # sorted uint64
    mask_middle: bool = True

    def middle_mask(self) -> int:
        # middleMask = ~(3 << (2*(k/2))) (BBDuk2.java:676)
        return ~(3 << (2 * (self.k // 2))) & ((1 << (2 * self.k)) - 1)


def _seq_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All full-length k-mer values of one sequence (big... rolling
    low-bits-newest encoding, matching BBDuk's (kmer<<2|n)&mask)."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    km = np.zeros(n - k + 1, dtype=np.uint64)
    val = 0
    mask = (1 << (2 * k)) - 1
    out = []
    for i, c in enumerate(codes.tolist()):
        val = ((val << 2) | int(c)) & mask
        if i >= k - 1:
            out.append(val)
    return np.asarray(out, dtype=np.uint64)


def _revcomp_kmer(vals: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of packed k-mers (2-bit, newest at LSB)."""
    out = np.zeros_like(vals)
    v = vals.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | (np.uint64(3) - (v & np.uint64(3)))
        v >>= np.uint64(2)
    return out


def build_kmer_ref(
    seqs: Iterable[str], k: int = 27, hdist: int = 1, rcomp: bool = True,
    mask_middle: bool = True,
) -> KmerRef:
    """Build the reference table: both strands, Hamming<=hdist mutants,
    middle base cleared (BBDuk2 table-load semantics)."""
    base: List[np.ndarray] = []
    for s in seqs:
        codes = encode_seq(s)
        km = _seq_kmers(codes, k)
        base.append(km)
        if rcomp:
            base.append(_revcomp_kmer(km, k))
    vals = np.unique(np.concatenate(base)) if base else np.zeros(0, np.uint64)

    if hdist >= 1 and len(vals):
        muts = [vals]
        for pos in range(k):
            for delta in (1, 2, 3):
                muts.append(vals ^ np.uint64(delta << (2 * pos)))
        vals = np.unique(np.concatenate(muts))

    if mask_middle and len(vals):
        mm = np.uint64(~(3 << (2 * (k // 2))) & ((1 << (2 * k)) - 1))
        vals = np.unique(vals & mm)
    return KmerRef(k=k, kmers=vals, mask_middle=mask_middle)


def load_adapters(path) -> List[str]:
    return [r.seq for r in read_fastx(path)]


# ---------------------------------------------------------------------------
# batch ops
# ---------------------------------------------------------------------------


def rolling_kmers(
    codes: np.ndarray, lens: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(B, L) codes -> (B, L) k-mer ending at each position + validity."""
    B, L = codes.shape
    km = np.zeros((B, L), dtype=np.uint64)
    val = np.zeros(B, dtype=np.uint64)
    mask = np.uint64((1 << (2 * k)) - 1)
    for i in range(L):
        val = ((val << np.uint64(2)) | codes[:, i].astype(np.uint64)) & mask
        km[:, i] = val
    pos = np.arange(L)[None, :]
    valid = (pos >= k - 1) & (pos < np.asarray(lens)[:, None])
    return km, valid


def kmask(
    codes: np.ndarray,
    lens: np.ndarray,
    is_n: np.ndarray,
    ref: KmerRef,
    trim_pad: int = 0,
    forbid_ns: bool = False,
) -> np.ndarray:
    """Mark spans covered by matching k-mers; returns bool (B, L) mask.

    A hit at k-mer end i masks [i-k+1-trimPad, i+trimPad]
    (BBDuk2 kmask span semantics). ``forbid_ns`` follows BBDuk2:559
    ``forbidNs=(forbidNs_ || hammingDistance<1)``: the MegaPath driver
    passes hdist=1 (runMegaPath.sh:119), so Ns are treated as 'A'
    (Dedupe.baseToNumber default 0) and do NOT disqualify a k-mer.
    """
    B, L = codes.shape
    k = ref.k
    km, valid = rolling_kmers(codes, lens, k)
    if ref.mask_middle:
        km = km & np.uint64(ref.middle_mask())
    idx = np.searchsorted(ref.kmers, km)
    idx = np.minimum(idx, max(len(ref.kmers) - 1, 0))
    hit = valid & (len(ref.kmers) > 0) & (ref.kmers[idx] == km)
    if forbid_ns and is_n.any():
        ncum = np.cumsum(is_n, axis=1)
        nprev = np.pad(ncum[:, :-1], ((0, 0), (1, 0)))
        first = np.maximum(np.arange(L)[None, :] - k + 1, 0)
        n_in_kmer = ncum - np.take_along_axis(
            np.pad(ncum, ((0, 0), (1, 0))), first, axis=1
        )
        hit &= n_in_kmer == 0
    # expand hits to spans via difference array
    span = np.zeros((B, L + 1), dtype=np.int32)
    bs, ps = np.nonzero(hit)
    if len(bs):
        starts = np.maximum(ps - k + 1 - trim_pad, 0)
        ends = np.minimum(ps + trim_pad, L - 1) + 1
        np.add.at(span, (bs, starts), 1)
        np.add.at(span, (bs, ends), -1)
    return np.cumsum(span[:, :-1], axis=1) > 0


def quality_trim(
    quals: np.ndarray,  # (B, L) phred values
    is_n: np.ndarray,  # (B, L) bool
    lens: np.ndarray,
    trimq: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal-mode quality trim (TrimRead.testOptimal:264-315).

    Kadane max-subarray over (avgErrorRate - probError); ties prefer
    the longer window. Returns (start, stop) kept range per read
    (stop exclusive); empty reads give start==stop.
    """
    B, L = quals.shape
    avg_err = float(phred_error(np.array(trimq)))
    nprob = max(min(avg_err * 1.1, 1.0), NPROB)

    from megapath.native.build import load_bbduk_lib

    lib = load_bbduk_lib()
    if lib is not None and B:
        import ctypes

        q = np.ascontiguousarray(quals, dtype=np.int16)
        nn = np.ascontiguousarray(is_n, dtype=np.uint8)
        ll = np.ascontiguousarray(lens, dtype=np.int32)
        start = np.empty(B, dtype=np.int32)
        stop = np.empty(B, dtype=np.int32)
        lib.bbduk_qtrim(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            nn.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ll.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(B), ctypes.c_int32(L),
            _PROB_ERROR.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_double(avg_err), ctypes.c_double(nprob),
            start.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            stop.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return start, stop
    prob = phred_error(quals)
    prob = np.where(is_n, nprob, prob)
    delta = (avg_err - prob).astype(np.float32)

    score = np.zeros(B, dtype=np.float32)
    count = np.zeros(B, dtype=np.int32)
    max_score = np.zeros(B, dtype=np.float32)
    max_count = np.full(B, -1, dtype=np.int32)
    max_loc = np.full(B, -1, dtype=np.int32)
    lens = np.asarray(lens)
    for i in range(L):
        live = i < lens
        score = np.where(live, score + delta[:, i], score)
        pos_mask = live & (score > 0)
        count = np.where(pos_mask, count + 1, np.where(live, 0, count))
        better = pos_mask & (
            (score > max_score) | ((score == max_score) & (count > max_count))
        )
        max_score = np.where(better, score, max_score)
        max_count = np.where(better, count, max_count)
        max_loc = np.where(better, i, max_loc)
        score = np.where(live & ~pos_mask, 0, score)

    keep = max_score > 0
    start = np.where(keep, max_loc - max_count + 1, 0)
    stop = np.where(keep, max_loc + 1, 0)
    return start.astype(np.int32), stop.astype(np.int32)


def average_entropy(
    codes: np.ndarray,  # (B, L) with N already mapped to A (0)
    lens: np.ndarray,
    k: int = 5,
    window: int = 50,
) -> np.ndarray:
    """Per-read average sliding-window entropy (BBDuk2:3161-3248).

    Incremental: maintain per-read 5-mer counts and the running
    Sigma cc[c]*e[c] via transition deltas. Reads shorter than the
    window have no measurements and score 0.
    """
    B, L = codes.shape
    lens = np.asarray(lens)

    from megapath.native.build import load_bbduk_lib

    lib = load_bbduk_lib()
    if lib is not None and B:
        import ctypes

        cc = np.ascontiguousarray(codes, dtype=np.uint8)
        ll = np.ascontiguousarray(lens, dtype=np.int32)
        out = np.empty(B, dtype=np.float64)
        lib.bbduk_entropy(
            cc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ll.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(B), ctypes.c_int32(L),
            ctypes.c_int32(k), ctypes.c_int32(window),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out

    kspace = 1 << (2 * k)
    mask = np.uint32(kspace - 1)
    # e[c] = (c/window) * ln(c/window)
    cvals = np.arange(window + 2, dtype=np.float64) / window
    with np.errstate(divide="ignore", invalid="ignore"):
        e = cvals * np.log(cvals)
    e[0] = 0.0
    mult = -1.0 / np.log(window)

    # one flat counts array indexed by row*kspace + kmer: one gather +
    # one scatter per transition (indices are unique per row, so plain
    # advanced-index writes suffice); de[c] = e[c+1] - e[c] folds the
    # two table reads per update into one
    counts = np.zeros(B * kspace, dtype=np.int16)
    de = np.zeros(window + 2, dtype=np.float64)
    de[:-1] = e[1:] - e[:-1]
    S = np.zeros(B, dtype=np.float64)  # Sigma cc[c] * e[c]
    esum = np.zeros(B, dtype=np.float64)
    nmeas = np.zeros(B, dtype=np.int64)
    row_base = np.arange(B, dtype=np.int64) * kspace

    kadd = np.zeros(B, dtype=np.uint32)
    krem = np.zeros(B, dtype=np.uint32)
    codes_u32 = codes.astype(np.uint32)
    for i in range(L + window):
        i2 = i - window
        if i < L:
            kadd = ((kadd << np.uint32(2)) | codes_u32[:, i]) & mask
            idx = row_base + kadd
            c_old = counts[idx]
            live = i < lens
            S += np.where(live, de[c_old], 0.0)
            counts[idx[live]] = c_old[live] + 1
        if i2 >= 0:
            krem = ((krem << np.uint32(2)) | codes_u32[:, i2]) & mask
            idx = row_base + krem
            c_old = counts[idx]
            live = (i2 < lens) & (c_old > 0)
            S -= np.where(live, de[np.maximum(c_old - 1, 0)], 0.0)
            counts[idx[live]] = c_old[live] - 1
        # measurement when i2 >= -1 and i < len
        meas = (i2 >= -1) & (i < lens)
        esum += np.where(meas, S * mult, 0.0)
        nmeas += meas
        if i >= L and i2 >= L:
            break
    return np.where(nmeas > 0, esum / np.maximum(nmeas, 1), 0.0)


# ---------------------------------------------------------------------------
# the two-stage pipeline entry
# ---------------------------------------------------------------------------


@dataclass
class BBDukResult:
    kept1: List[FastqRecord]
    kept2: List[FastqRecord]
    low_complexity: List[FastqRecord]
    removed_short: int = 0


class LazyRecList:
    """List façade that materializes its FastqRecords on first
    access — the array fast path of the pipeline never touches the
    record objects (alignment runs on the code matrices), so the
    string slicing/decoding cost is paid only when LSAM/FASTQ output
    actually needs them."""

    def __init__(self, build, n: int):
        self._build = build
        self._n = n
        self._cache = None

    def _mat(self):
        if self._cache is None:
            self._cache = self._build()
            assert len(self._cache) == self._n
        return self._cache

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())


@dataclass
class BBDukArrays:
    """bbduk_pair's decisions as arrays: trimmed/masked code matrices
    for the kept pairs (pack_reads-equivalent, N->code 2) plus lazy
    record views for the output layers."""

    codes1: np.ndarray  # uint8 [K, L]
    lens1: np.ndarray  # int32 [K]
    codes2: np.ndarray
    lens2: np.ndarray
    kept1: "LazyRecList"
    kept2: "LazyRecList"
    low_complexity: "LazyRecList"
    removed: int


def _bbduk_analyze(
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    adapters: Optional[KmerRef],
    min_len: int,
    trimq: int,
    entropy_cutoff: float,
    max_len: int,
):
    """Shared analysis of both driver BBDuk passes: packs, scans, and
    decides — returns everything downstream of the decisions (masks,
    trim offsets, keep/low flags, rewritten seq/qual buffers) without
    materializing output records."""
    n = len(recs1)
    L = max_len

    def pack(recs):
        """One concatenated-buffer scatter instead of per-record numpy
        calls (the per-record loop cost ~14 s on a 40k-pair batch)."""
        seqs = [r.seq[:L] for r in recs]
        lens = np.fromiter((len(s) for s in seqs), np.int32, count=n)
        total = int(lens.sum())
        buf = np.frombuffer("".join(seqs).encode("latin1"), np.uint8)
        qs = [r.qual[: int(l_)] for r, l_ in zip(recs, lens)]
        qbuf = np.frombuffer("".join(qs).encode("latin1"), np.uint8)
        if total == n * L and len(qbuf) == total:
            # uniform-length batch (the untrimmed stage-0 common case):
            # reshape the joined buffers directly, no scatter
            raw = buf.reshape(n, L)
            codes = _ENC_LUT[buf].reshape(n, L)
            is_n = (~_IS_ACGT_LUT[buf]).reshape(n, L)
            quals = (qbuf.astype(np.int16) - 33).reshape(n, L)
            return codes, is_n, quals, lens, raw
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        rows = np.repeat(np.arange(n), lens)
        pos = np.arange(total, dtype=np.int64) - offs[rows] + rows * L
        raw = np.zeros(n * L, dtype=np.uint8)
        codes = np.zeros(n * L, dtype=np.uint8)
        is_n = np.zeros(n * L, dtype=bool)
        quals = np.zeros(n * L, dtype=np.int16)
        raw[pos] = buf
        codes[pos] = _ENC_LUT[buf]
        is_n[pos] = ~_IS_ACGT_LUT[buf]
        qlens = np.fromiter((len(q) for q in qs), np.int32, count=n)
        qrows = np.repeat(np.arange(n), qlens)
        qoffs = np.zeros(n + 1, np.int64)
        np.cumsum(qlens, out=qoffs[1:])
        qpos = (
            np.arange(int(qlens.sum()), dtype=np.int64)
            - qoffs[qrows] + qrows * L
        )
        quals[qpos] = qbuf.astype(np.int16) - 33
        return (codes.reshape(n, L), is_n.reshape(n, L),
                quals.reshape(n, L), lens, raw.reshape(n, L))

    c1, n1, q1, l1, raw1 = pack(recs1)
    c2, n2, q2, l2, raw2 = pack(recs2)

    def process(codes, is_n, quals, lens):
        masked = (
            kmask(codes, lens, is_n, adapters)
            if adapters is not None and len(adapters.kmers)
            else np.zeros_like(is_n)
        )
        nn = is_n | masked
        start, stop = quality_trim(quals, nn, lens, trimq)
        return masked, start, stop

    m1, s1, e1 = process(c1, n1, q1, l1)
    m2, s2, e2 = process(c2, n2, q2, l2)

    len1 = e1 - s1
    len2 = e2 - s2
    ok = (len1 >= min_len) & (len2 >= min_len)

    # entropy on the trimmed reads (N/masked count as A = 0), shifted
    # to column 0 with one take_along_axis per end
    def shift_trimmed(codes, nn, start, length):
        vals = np.where(nn, 0, codes)
        moved = np.flatnonzero(start > 0)
        if len(moved):
            # only head-trimmed rows need the per-row gather (most
            # rows keep start 0 — the gather over the full matrix was
            # a top pipeline cost)
            src = np.clip(
                start[moved, None] + np.arange(L)[None, :], 0, L - 1
            )
            vals[moved] = np.take_along_axis(vals[moved], src, axis=1)
        live = np.arange(L)[None, :] < length[:, None]
        return np.where(live, vals, 0).astype(np.uint8)

    ent1 = average_entropy(
        shift_trimmed(c1, n1 | m1, s1, np.where(ok, len1, 0)),
        np.where(ok, len1, 0),
    )
    ent2 = average_entropy(
        shift_trimmed(c2, n2 | m2, s2, np.where(ok, len2, 0)),
        np.where(ok, len2, 0),
    )
    low = ok & ((ent1 < entropy_cutoff) | (ent2 < entropy_cutoff))

    # kmask rewrites bases to 'N' AND zeroes their quality (BBDuk2
    # kmask: "quals[i]=0" when trimSymbol=='N'); one vectorized pass
    mseq1 = np.where(m1, np.uint8(ord("N")), raw1)
    mseq2 = np.where(m2, np.uint8(ord("N")), raw2)
    mq1 = np.where(m1, np.uint8(ord("!")), 0)
    mq2 = np.where(m2, np.uint8(ord("!")), 0)

    # flatten once: per-record seq slices come from one bytes buffer
    # (bytes slicing beats 40k tiny numpy views), and the qual rewrite
    # happens only on rows the kmask actually touched
    flat1 = mseq1.tobytes()
    flat2 = mseq2.tobytes()
    any_mq1 = mq1.any(axis=1)
    any_mq2 = mq2.any(axis=1)

    def rec_out(recs, flat, mq, has_mask, i, s_, e_):
        r = recs[i]
        seq = flat[i * L + s_ : i * L + e_].decode("latin1")
        q = r.qual[s_:e_]
        if has_mask:
            row = mq[i, s_:e_]
            if row.any():
                qb = np.frombuffer(q.encode("latin1"), np.uint8).copy()
                np.putmask(qb[: len(row)], row[: len(qb)] > 0, ord("!"))
                q = qb.tobytes().decode("latin1")
        return FastqRecord(r.name, seq, q, r.comment)

    return {
        "n": n, "L": L, "ok": ok, "low": low,
        "s1": s1, "e1": e1, "s2": s2, "e2": e2,
        "m1": m1, "m2": m2, "n1": n1, "n2": n2,
        "raw1": raw1, "raw2": raw2,
        "flat1": flat1, "flat2": flat2,
        "mq1": mq1, "mq2": mq2,
        "any_mq1": any_mq1, "any_mq2": any_mq2,
        "rec_out": rec_out, "recs1": recs1, "recs2": recs2,
    }


def bbduk_pair(
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    adapters: Optional[KmerRef],
    min_len: int = 50,
    trimq: int = 10,
    entropy_cutoff: float = 0.75,
    max_len: int = 512,
) -> BBDukResult:
    """Full preprocessing of a pair batch (both driver BBDuk passes)."""
    a = _bbduk_analyze(
        recs1, recs2, adapters, min_len, trimq, entropy_cutoff, max_len
    )
    out1: List[FastqRecord] = []
    out2: List[FastqRecord] = []
    lowc: List[FastqRecord] = []
    removed = 0
    rec_out = a["rec_out"]
    ok_l = a["ok"].tolist()
    low_l = a["low"].tolist()
    s1_l, e1_l = a["s1"].tolist(), a["e1"].tolist()
    s2_l, e2_l = a["s2"].tolist(), a["e2"].tolist()
    m1_l, m2_l = a["any_mq1"].tolist(), a["any_mq2"].tolist()
    for i in range(a["n"]):
        if not ok_l[i]:
            removed += 1
            continue
        r1 = rec_out(recs1, a["flat1"], a["mq1"], m1_l[i], i, s1_l[i], e1_l[i])
        r2 = rec_out(recs2, a["flat2"], a["mq2"], m2_l[i], i, s2_l[i], e2_l[i])
        if low_l[i]:
            lowc.extend([r1, r2])
        else:
            out1.append(r1)
            out2.append(r2)
    return BBDukResult(out1, out2, lowc, removed)


def bbduk_pair_arrays(
    recs1: Sequence[FastqRecord],
    recs2: Sequence[FastqRecord],
    adapters: Optional[KmerRef],
    min_len: int = 50,
    trimq: int = 10,
    entropy_cutoff: float = 0.75,
    max_len: int = 512,
) -> BBDukArrays:
    """bbduk_pair for the array pipeline: the kept pairs come back as
    trimmed/masked CODE MATRICES (bit-identical to pack_reads over
    bbduk_pair's output records — kmask/N bases land on code 2, the
    N->G charMap of encode_seq) and the record views are lazy, so the
    aligner path skips ~0.2 s/40k-pair batch of string slicing and
    re-encoding."""
    from megapath.index.pack import _CODE as _PACK_CODE

    a = _bbduk_analyze(
        recs1, recs2, adapters, min_len, trimq, entropy_cutoff, max_len
    )
    n, L = a["n"], a["L"]
    ok, low = a["ok"], a["low"]
    keep = ok & ~low
    kept_rows = np.flatnonzero(keep)
    removed = int((~ok).sum())

    def trimmed_codes(raw, mask, s, e):
        b = np.where(mask, np.uint8(ord("N")), raw)[kept_rows]
        codes = _PACK_CODE[b]
        sk = s[kept_rows]
        lens = (e - s)[kept_rows].astype(np.int32)
        moved = np.flatnonzero(sk > 0)
        if len(moved):
            # per-row shift only for head-trimmed rows (rare)
            src = np.clip(
                sk[moved, None] + np.arange(L)[None, :], 0, L - 1
            )
            codes[moved] = np.take_along_axis(codes[moved], src, axis=1)
        live = np.arange(L)[None, :] < lens[:, None]
        return np.where(live, codes, 0).astype(np.uint8), lens

    codes1, lens1 = trimmed_codes(a["raw1"], a["m1"], a["s1"], a["e1"])
    codes2, lens2 = trimmed_codes(a["raw2"], a["m2"], a["s2"], a["e2"])

    rec_out = a["rec_out"]

    def build_end(recs, flat, mq, any_mq, s, e, rows):
        def build():
            s_l, e_l, m_l = s.tolist(), e.tolist(), any_mq.tolist()
            return [
                rec_out(recs, flat, mq, m_l[i], i, s_l[i], e_l[i])
                for i in rows
            ]

        return build

    low_rows = np.flatnonzero(ok & low)

    def build_low():
        b1 = build_end(
            recs1, a["flat1"], a["mq1"], a["any_mq1"], a["s1"], a["e1"],
            low_rows,
        )()
        b2 = build_end(
            recs2, a["flat2"], a["mq2"], a["any_mq2"], a["s2"], a["e2"],
            low_rows,
        )()
        out: List[FastqRecord] = []
        for r1, r2 in zip(b1, b2):
            out.extend([r1, r2])
        return out

    return BBDukArrays(
        codes1=codes1, lens1=lens1, codes2=codes2, lens2=lens2,
        kept1=LazyRecList(
            build_end(recs1, a["flat1"], a["mq1"], a["any_mq1"],
                      a["s1"], a["e1"], kept_rows),
            len(kept_rows),
        ),
        kept2=LazyRecList(
            build_end(recs2, a["flat2"], a["mq2"], a["any_mq2"],
                      a["s2"], a["e2"], kept_rows),
            len(kept_rows),
        ),
        low_complexity=LazyRecList(build_low, 2 * len(low_rows)),
        removed=removed,
    )

