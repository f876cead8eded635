"""Reference sharding: split a large FASTA into per-device index shards.

Functional replacement for /root/reference/splitFasta.pl (cuts NT at
3.9 Gbp because the 2bwt index uses 32-bit offsets).

**Shard-size design decision (pinned):** the device seeding path is
int32 end-to-end (DeviceFM occ rows, SA values, seed positions), so
the device shard cap is 2.0 Gbp — roughly half the reference's 3.9 Gbp,
i.e. ~2x the shard count for the same NT build. This is the permanent
design, not a stopgap: int32 keeps every hot array at half the HBM
footprint and bandwidth of an int64 port, and shards are processed
*in parallel across the mesh* (one shard per device column via
``MegaPathPipeline(devices=...)`` or ``parallel.spmd``), so shard
count scales with devices rather than wall-clock. A >2 Gbp shard
fails loudly at ``DeviceFM.from_host`` (``fm.n < 2**31`` assert).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

from megapath.io.fastq import FastqRecord, read_fastx, write_fastq

# splitFasta.pl:19 uses 3.9e9 (2bwt 32-bit *offsets*); the device FM
# uses int32 *signed* coordinates everywhere, so cap at 2.0 Gbp and
# run twice the shards concurrently across the mesh instead
DEFAULT_SHARD_BP = int(2.0e9)
REFERENCE_SHARD_BP = int(3.9e9)  # splitFasta.pl:19 (host-only paths)


def split_fasta(
    path, out_prefix: str, max_bp: int = DEFAULT_SHARD_BP
) -> List[str]:
    """Write ``{out_prefix}.{i}.fa`` shards each <= max_bp bases.

    A single sequence longer than max_bp gets its own shard (like the
    reference, which never splits within a sequence).
    """
    shard_paths: List[str] = []
    cur: List[FastqRecord] = []
    cur_bp = 0

    def flush():
        nonlocal cur, cur_bp
        if not cur:
            return
        p = f"{out_prefix}.{len(shard_paths)}.fa"
        write_fastq(cur, p, sep=" ")
        shard_paths.append(p)
        cur, cur_bp = [], 0

    for rec in read_fastx(path):
        if cur_bp and cur_bp + len(rec.seq) > max_bp:
            flush()
        cur.append(FastqRecord(rec.name, rec.seq, "", rec.comment))
        cur_bp += len(rec.seq)
    flush()
    return shard_paths


def build_shard_indexes(
    shard_paths: List[str],
    out_dir: str,
    sa_interval: int = 8,
    # lut_k=8 (not the 2bwt LOOKUP_SIZE=13): the lockstep device walk
    # gains nothing from empty-bucket exits and the 4^13 LUT gathers
    # cold device-memory rows (to be re-swept on the card, ROADMAP A6)
    lut_k: int = 8,
) -> List[Tuple[str, str]]:
    """Build (packed-ref, fm-index) npz pairs for every shard."""
    from megapath.index.fm import build_fm_index
    from megapath.index.pack import pack_fasta_file

    os.makedirs(out_dir, exist_ok=True)
    out: List[Tuple[str, str]] = []
    for i, p in enumerate(shard_paths):
        ref = pack_fasta_file(p)
        fm = build_fm_index(ref.codes, sa_interval=sa_interval, lut_k=lut_k)
        ref_path = os.path.join(out_dir, f"shard{i}.ref.npz")
        fm_path = os.path.join(out_dir, f"shard{i}.fm.npz")
        ref.save(ref_path)
        fm.save(fm_path)
        out.append((ref_path, fm_path))
    return out
