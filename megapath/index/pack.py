"""Reference packing: FASTA -> 2-bit codes + annotation/ambiguity tables.

Equivalent of the reference's .pac/.ann/.amb trio built by 2bwt-builder
(/root/reference/soap4/2bwt-lib/TextConverter.c, HSP.c) and of the
charMap that maps N (and every non-ACGT code) to G
(/root/reference/soap4/IndexHandler.cpp:42-45). The packed text is a
numpy uint8 code array (A=0 C=1 G=2 T=3) ready for device transfer; all
sequences of a shard are concatenated with their start offsets recorded
so alignment positions can be mapped back to (sequence, offset) — the
role of soap4's .ann/seqOffset (BGS-IO.cpp:1312 decideTargetChr).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from megapath.io.fastq import FastqRecord, read_fastx

# Byte -> 2-bit code; non-ACGT maps to G(2) like the reference charMap.
_CODE = np.full(256, 2, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    _CODE[ord(ch)] = i
    _CODE[ord(ch.lower())] = i

_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)

COMPLEMENT = np.array([3, 2, 1, 0], dtype=np.uint8)  # A<->T, C<->G


def encode_seq(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 codes 0..3 (non-ACGT -> 2)."""
    b = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CODE[b]


def decode_seq(codes: np.ndarray) -> str:
    return _DECODE[codes].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]]


@dataclass
class PackedReference:
    """One index shard's packed text + per-sequence annotation."""

    codes: np.ndarray  # uint8 [total_len] values 0..3
    names: List[str]  # per-sequence FASTA name (first token)
    annotations: List[str]  # full header text (the cfq hit annotation)
    offsets: np.ndarray  # int64 [n_seq + 1] start offsets; [-1]=total_len
    ambiguous: np.ndarray  # int64 [n_amb, 2) start,end of non-ACGT runs

    @property
    def n_seqs(self) -> int:
        return len(self.names)

    @property
    def total_len(self) -> int:
        return int(self.offsets[-1])

    def seq_of_pos(self, pos: np.ndarray) -> np.ndarray:
        """Global position(s) -> sequence index via searchsorted."""
        return np.searchsorted(self.offsets, np.asarray(pos), side="right") - 1

    def local_pos(self, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        seq_idx = self.seq_of_pos(pos)
        return seq_idx, np.asarray(pos) - self.offsets[seq_idx]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            codes=self.codes,
            names=np.array(self.names, dtype=object),
            annotations=np.array(self.annotations, dtype=object),
            offsets=self.offsets,
            ambiguous=self.ambiguous,
        )

    @classmethod
    def load(cls, path: str) -> "PackedReference":
        z = np.load(path, allow_pickle=True)
        return cls(
            codes=z["codes"],
            names=list(z["names"]),
            annotations=list(z["annotations"]),
            offsets=z["offsets"],
            ambiguous=z["ambiguous"],
        )


def pack_fasta(records: Iterable[FastqRecord]) -> PackedReference:
    """Concatenate sequences into one packed text with annotations."""
    chunks: List[np.ndarray] = []
    names: List[str] = []
    annotations: List[str] = []
    offsets = [0]
    amb: List[Tuple[int, int]] = []
    total = 0
    for rec in records:
        codes = encode_seq(rec.seq)
        b = np.frombuffer(rec.seq.encode("ascii"), dtype=np.uint8)
        is_amb = (_CODE[b] == 2) & (b != ord("G")) & (b != ord("g"))
        if is_amb.any():
            # record [start,end) runs of ambiguity
            d = np.diff(np.r_[0, is_amb.astype(np.int8), 0])
            starts = np.flatnonzero(d == 1) + total
            ends = np.flatnonzero(d == -1) + total
            amb.extend(zip(starts.tolist(), ends.tolist()))
        chunks.append(codes)
        # the reference's .ann keeps the first header token as the
        # sequence name (2bwt-lib TextConverter); descriptions embedded
        # in rec.name would otherwise leak into hit annotations and
        # break accession->taxid lookup
        name = rec.name.split()[0] if rec.name.split() else rec.name
        desc = rec.name[len(name):].strip()
        if rec.comment:
            desc = f"{desc} {rec.comment}".strip()
        names.append(name)
        annotations.append(name if not desc else f"{name} {desc}")
        total += len(codes)
        offsets.append(total)
    return PackedReference(
        codes=np.concatenate(chunks) if chunks else np.zeros(0, np.uint8),
        names=names,
        annotations=annotations,
        offsets=np.asarray(offsets, dtype=np.int64),
        ambiguous=np.asarray(amb, dtype=np.int64).reshape(-1, 2),
    )


def pack_fasta_file(path) -> PackedReference:
    return pack_fasta(read_fastx(path))


def pack_reads(
    seqs: Sequence[str], max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Reads -> fixed-shape [N, max_len] code batch + length vector.

    Padding code is 0 (A); lengths mask all compute. Fixed shapes keep
    XLA from recompiling per batch (SURVEY.md §7 design stance).
    """
    n = len(seqs)
    out = np.zeros((n, max_len), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = encode_seq(s[:max_len])
        out[i, : len(c)] = c
        lens[i] = len(c)
    return out, lens
