"""Translated protein search: the AC-DIAMOND blastx stage, on device.

Replaces the external ``ac-diamond blastx -q contig.unmap.fa -d NR``
call of the assembly remap stage (/root/reference/runMegaPath.sh:312-316)
with an in-process translated aligner:

  1. 6-frame translation of DNA queries (vectorized codon lookup);
  2. seed join: exact amino-acid k-mer anchors against a sorted-array
     index of the protein DB (the same double-indexing idea AC-DIAMOND
     uses, reduced to one sorted join per frame);
  3. diagonal-band grouping of anchors -> one candidate window per
     (query frame, subject, band);
  4. batched affine-gap Smith-Waterman over BLOSUM62 on device
     (``ops.dp.sw_align_protein`` — the substitution row is fetched
     with a one-hot reduction, not a 2-D gather), scoring all
     candidates in one program;
  5. host traceback only for surviving hits to produce the m8 columns
     (pident/mismatch/gapopen), then Karlin-Altschul bitscore/evalue.

Output is DIAMOND-format m8 whose subject field carries taxids joined
by the literal ``0x1`` (matching m8_to_lsam.pl / classify.extras
expectations), so the existing m8 -> lsam -> report tail applies
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# 24-letter alphabet: 20 aa + B Z X + '*' (stop)
AA = "ARNDCQEGHILKMFPSTWYVBZX*"
AA_CODE = {c: i for i, c in enumerate(AA)}
N_AA = len(AA)
STOP = AA_CODE["*"]
X = AA_CODE["X"]

# BLOSUM62 (NCBI), rows/cols in AA order above; '*' column = -4, *,* = 1
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""
BLOSUM62 = np.array(
    [[int(x) for x in row.split()] for row in _B62.strip().split("\n")],
    dtype=np.int32,
)
assert BLOSUM62.shape == (N_AA, N_AA)

# standard genetic code, codon index = 16*b0 + 4*b1 + b2 (ACGT = 0..3)
_CODONS = (
    "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF"
)
CODON_AA = np.array([AA_CODE[c] for c in _CODONS], dtype=np.uint8)

_DNA_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)

# Karlin-Altschul gapped params for BLOSUM62, gap open 11 / extend 1
KA_LAMBDA = 0.267
KA_K = 0.041
LN2 = float(np.log(2.0))


def bitscore(raw: np.ndarray) -> np.ndarray:
    return (KA_LAMBDA * np.asarray(raw, np.float64) - np.log(KA_K)) / LN2


def evalue(bits: np.ndarray, qlen: int, db_len: int) -> np.ndarray:
    return float(qlen) * float(db_len) * np.power(2.0, -np.asarray(bits))


def translate_frames(codes: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """All 6 reading frames of a DNA code vector -> aa code vectors.

    Returns [(frame, aa_codes)] with frame in {1,2,3,-1,-2,-3}
    (blastx numbering: negative = reverse complement strand).
    """
    codes = np.asarray(codes, np.uint8)
    rc = _DNA_COMP[codes[::-1]]
    out: List[Tuple[int, np.ndarray]] = []
    for strand, seq in ((1, codes), (-1, rc)):
        for off in range(3):
            n = (len(seq) - off) // 3
            if n <= 0:
                out.append((strand * (off + 1), np.zeros(0, np.uint8)))
                continue
            c = seq[off : off + 3 * n].reshape(n, 3).astype(np.int32)
            aa = CODON_AA[16 * c[:, 0] + 4 * c[:, 1] + c[:, 2]]
            out.append((strand * (off + 1), aa))
    return out


@dataclass
class ProteinDB:
    """Sorted k-mer anchor index over concatenated protein sequences."""

    names: List[str]
    text: np.ndarray  # uint8 concatenated aa codes
    offsets: np.ndarray  # int64 [n_seqs + 1]
    k: int
    kmer_sorted: np.ndarray  # uint32 sorted k-mer keys
    kmer_pos: np.ndarray  # int64 text positions (order of kmer_sorted)

    @property
    def db_len(self) -> int:
        return int(self.offsets[-1])

    @classmethod
    def build(cls, seqs: Sequence[Tuple[str, str]], k: int = 4) -> "ProteinDB":
        """``seqs`` = [(name, aa_string)]; names may carry taxids the
        way the MegaPath NR build does (ids joined by '0x1')."""
        names = [n for n, _ in seqs]
        codes = [
            np.array([AA_CODE.get(c, X) for c in s.upper()], np.uint8)
            for _, s in seqs
        ]
        offsets = np.zeros(len(codes) + 1, np.int64)
        np.cumsum([len(c) for c in codes], out=offsets[1:])
        text = (
            np.concatenate(codes) if codes else np.zeros(0, np.uint8)
        )
        keys, pos = _kmer_scan(text, offsets, k)
        order = np.argsort(keys, kind="stable")
        return cls(
            names=names,
            text=text,
            offsets=offsets,
            k=k,
            kmer_sorted=keys[order],
            kmer_pos=pos[order],
        )


def _kmer_scan(
    text: np.ndarray, offsets: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(key, position) for every in-sequence k-mer without X or stop."""
    n = len(text)
    if n < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.int64)
    base = np.uint32(N_AA)
    keys = np.zeros(n - k + 1, np.uint32)
    ok = np.ones(n - k + 1, bool)
    for j in range(k):
        seg = text[j : n - k + 1 + j].astype(np.uint32)
        keys = keys * base + seg
        ok &= (seg != STOP) & (seg != X)
    # k-mers must not straddle sequence boundaries
    pos = np.arange(n - k + 1, dtype=np.int64)
    seq_of_start = np.searchsorted(offsets, pos, side="right") - 1
    seq_of_end = np.searchsorted(offsets, pos + k - 1, side="right") - 1
    ok &= seq_of_start == seq_of_end
    return keys[ok], pos[ok]


def _query_kmers(aa: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    n = len(aa)
    if n < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.int64)
    base = np.uint32(N_AA)
    keys = np.zeros(n - k + 1, np.uint32)
    ok = np.ones(n - k + 1, bool)
    for j in range(k):
        seg = aa[j : n - k + 1 + j].astype(np.uint32)
        keys = keys * base + seg
        ok &= (seg != STOP) & (seg != X)
    pos = np.arange(n - k + 1, dtype=np.int64)
    return keys[ok], pos[ok]


@dataclass
class BlastxParams:
    gap_open: int = -11
    gap_extend: int = -1
    min_bitscore: float = 40.0
    band: int = 16  # anchors within one band collapse to one candidate
    window_pad: int = 24  # subject window slack around the anchor span
    max_cands_per_query: int = 64
    max_target_seqs: int = 25


@dataclass
class M8Hit:
    qseqid: str
    sseqid: str
    pident: float
    length: int
    mismatch: int
    gapopen: int
    qstart: int  # 1-based DNA coordinates, blastx convention
    qend: int
    sstart: int
    send: int
    evalue_: float
    bitscore_: float

    def to_line(self) -> str:
        return "\t".join(
            [
                self.qseqid,
                self.sseqid,
                f"{self.pident:.2f}",
                str(self.length),
                str(self.mismatch),
                str(self.gapopen),
                str(self.qstart),
                str(self.qend),
                str(self.sstart),
                str(self.send),
                f"{self.evalue_:.2e}",
                f"{self.bitscore_:.1f}",
            ]
        )


def _traceback(
    q: np.ndarray, s: np.ndarray, params: BlastxParams
) -> Tuple[int, int, int, int, int, int, int, int]:
    """Full SW with traceback on one (small) candidate pair; returns
    (score, matches, mismatches, length, gapopens, qs, qe, ss, se)
    0-based half-open in aa coordinates."""
    nq, ns = len(q), len(s)
    go, ge = params.gap_open, params.gap_extend
    H = np.zeros((nq + 1, ns + 1), np.int32)
    E = np.full((nq + 1, ns + 1), -(1 << 30), np.int32)
    F = np.full((nq + 1, ns + 1), -(1 << 30), np.int32)
    sub = BLOSUM62[q[:, None], s[None, :]]
    for i in range(1, nq + 1):
        E[i] = np.maximum(H[i - 1] + go, E[i - 1] + ge)  # gap in subject
        row = H[i - 1, :-1] + sub[i - 1]
        h = np.zeros(ns + 1, np.int32)
        f = -(1 << 30)
        for j in range(1, ns + 1):
            f = max(h[j - 1] + go, f + ge)
            F[i, j] = f
            h[j] = max(0, row[j - 1], E[i, j], f)
        H[i] = h
    score = int(H.max())
    if score <= 0:
        return 0, 0, 0, 0, 0, 0, 0, 0, 0
    i, j = np.unravel_index(np.argmax(H), H.shape)
    qe, se = int(i), int(j)
    matches = mismatches = length = gapopens = 0
    state = "H"
    while i > 0 and j > 0 and H[i, j] > 0:
        if state == "H":
            if H[i, j] == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                if q[i - 1] == s[j - 1]:
                    matches += 1
                else:
                    mismatches += 1
                length += 1
                i, j = i - 1, j - 1
            elif H[i, j] == E[i, j]:
                state = "E"
            elif H[i, j] == F[i, j]:
                state = "F"
            else:
                break
        elif state == "E":
            length += 1
            if E[i, j] == H[i - 1, j] + params.gap_open:
                gapopens += 1
                state = "H"
            i -= 1
        else:  # F
            length += 1
            if F[i, j] == H[i, j - 1] + params.gap_open:
                gapopens += 1
                state = "H"
            j -= 1
    return score, matches, mismatches, length, gapopens, int(i), qe, int(j), se


def blastx(
    queries: Sequence[Tuple[str, np.ndarray]],
    db: ProteinDB,
    params: Optional[BlastxParams] = None,
    device: bool = True,
) -> List[M8Hit]:
    """Translated search of DNA queries (name, codes) against the DB.

    Candidate scoring runs as ONE batched device DP over every
    (query-frame, subject, band) candidate; only hits whose device
    score clears ``min_bitscore`` get the exact host traceback that
    fills the m8 columns (two-phase design, like the reference
    aligner's filter-then-output split).
    """
    params = params or BlastxParams()
    k = db.k

    # ---- 1+2+3: translate, seed join, band-group -> candidates ------
    cand = []  # (qi, frame, qlen_aa, q_aa, subj, s_lo, s_hi, q_lo, q_hi)
    for qi, (_, codes) in enumerate(queries):
        per_query = []
        for frame, aa in translate_frames(codes):
            if len(aa) < k:
                continue
            keys, qpos = _query_kmers(aa, k)
            lo = np.searchsorted(db.kmer_sorted, keys, side="left")
            hi = np.searchsorted(db.kmer_sorted, keys, side="right")
            m = hi > lo
            if not m.any():
                continue
            # expand all anchor matches (bounded: aa k-mer space is
            # huge so multiplicity is ~1 for real DBs)
            reps = (hi - lo)[m]
            qp = np.repeat(qpos[m], reps)
            sp = np.concatenate(
                [db.kmer_pos[a:b] for a, b in zip(lo[m], hi[m])]
            )
            subj = np.searchsorted(db.offsets, sp, side="right") - 1
            diag = (sp - db.offsets[subj]) - qp
            band = diag // params.band
            order = np.lexsort((qp, band, subj))
            subj, band, qp, sp = subj[order], band[order], qp[order], sp[order]
            first = np.r_[
                True, (subj[1:] != subj[:-1]) | (band[1:] != band[:-1])
            ]
            gidx = np.cumsum(first) - 1
            n_g = int(gidx[-1]) + 1
            qlo = np.full(n_g, 1 << 60, np.int64)
            qhi = np.zeros(n_g, np.int64)
            slo = np.full(n_g, 1 << 60, np.int64)
            shi = np.zeros(n_g, np.int64)
            np.minimum.at(qlo, gidx, qp)
            np.maximum.at(qhi, gidx, qp + k)
            np.minimum.at(slo, gidx, sp)
            np.maximum.at(shi, gidx, sp + k)
            g_subj = subj[first]
            nhits = np.bincount(gidx, minlength=n_g)
            for g in np.argsort(-nhits)[: params.max_cands_per_query]:
                s_idx = int(g_subj[g])
                s0 = int(db.offsets[s_idx])
                s1 = int(db.offsets[s_idx + 1])
                w_lo = max(s0, int(slo[g]) - int(qlo[g]) - params.window_pad)
                w_hi = min(s1, int(shi[g]) + (len(aa) - int(qhi[g]))
                           + params.window_pad)
                per_query.append(
                    (qi, frame, aa, s_idx, w_lo, w_hi)
                )
        cand.extend(per_query)

    if not cand:
        return []

    # ---- 4: batched device DP over all candidates --------------------
    QL = max(len(c[2]) for c in cand)
    WL = max(c[5] - c[4] for c in cand)
    B = len(cand)
    q_arr = np.zeros((B, QL), np.uint8)
    s_arr = np.full((B, WL), X, np.uint8)
    q_lens = np.zeros(B, np.int32)
    s_lens = np.zeros(B, np.int32)
    for b, (qi, frame, aa, s_idx, w_lo, w_hi) in enumerate(cand):
        q_arr[b, : len(aa)] = aa
        s_arr[b, : w_hi - w_lo] = db.text[w_lo:w_hi]
        q_lens[b] = len(aa)
        s_lens[b] = w_hi - w_lo
    from megapath.ops.dp import DPParams, sw_align_protein

    scores = np.asarray(
        sw_align_protein(
            q_arr, s_arr, q_lens, s_lens,
            DPParams(0, 0, params.gap_open, params.gap_extend),
        ).score
    )

    # ---- 5: exact traceback on survivors -> m8 ----------------------
    hits: List[M8Hit] = []
    by_query: Dict[int, List[int]] = {}
    for b in range(B):
        by_query.setdefault(cand[b][0], []).append(b)
    for qi, bs in by_query.items():
        qname = queries[qi][0]
        dna_len = len(queries[qi][1])
        rows = []
        seen_subj: Dict[int, float] = {}
        for b in sorted(bs, key=lambda b_: -scores[b_]):
            if bitscore(scores[b]) < params.min_bitscore:
                continue
            _, frame, aa, s_idx, w_lo, w_hi = cand[b]
            sc, mt, mm_, ln, go_, qs, qe, ss, se = _traceback(
                aa, db.text[w_lo:w_hi], BlastxParams(
                    gap_open=params.gap_open, gap_extend=params.gap_extend
                )
            )
            if ln == 0 or bitscore(sc) < params.min_bitscore:
                continue
            if s_idx in seen_subj and seen_subj[s_idx] >= sc:
                continue
            seen_subj[s_idx] = sc
            bits = float(bitscore(sc))
            ev = float(evalue(bits, dna_len, db.db_len))
            # aa -> DNA coordinates (blastx 1-based, strand-aware)
            off = abs(frame) - 1
            if frame > 0:
                dq_s = off + 3 * qs + 1
                dq_e = off + 3 * qe
            else:
                dq_s = dna_len - (off + 3 * qs)
                dq_e = dna_len - (off + 3 * qe) + 1
            s0 = int(db.offsets[s_idx])
            rows.append(
                M8Hit(
                    qseqid=qname,
                    sseqid=db.names[s_idx],
                    pident=100.0 * mt / ln,
                    length=ln,
                    mismatch=mm_,
                    gapopen=go_,
                    qstart=dq_s,
                    qend=dq_e,
                    sstart=w_lo - s0 + ss + 1,
                    send=w_lo - s0 + se,
                    evalue_=ev,
                    bitscore_=bits,
                )
            )
        rows.sort(key=lambda h: -h.bitscore_)
        hits.extend(rows[: params.max_target_seqs])
    return hits


def blastx_m8(
    queries: Sequence[Tuple[str, np.ndarray]],
    db: ProteinDB,
    params: Optional[BlastxParams] = None,
) -> List[str]:
    return [h.to_line() for h in blastx(queries, db, params)]
