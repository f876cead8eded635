"""Insert-window candidate pairing.

Equivalent of pairEndMerge / mergeAndPairPairedEnd
(/root/reference/soap4/DV-DPfunctions.cpp:1968-2119): for each read
pair, (+)-strand left-leg positions join (-)-strand right-leg
positions within [left + length_low, left + length_high], where
length_low = max(0, insert_low - right_len - margin) and
length_high = insert_high - right_len + margin; left positions are
first compressed with divide-gap 5. Both leg assignments are tried:
(read1+, read2-) and (read2+, read1-). Implemented as sorted
searchsorted joins instead of pointer walks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from megapath.align.params import AlignParams
from megapath.align.seeding import SeedPositions


@dataclass
class Candidates:
    """Paired DP candidates. ``left_is_read2[i]`` marks the orientation
    where read2 is the (+)-strand left leg (isMatePositive=1)."""

    pair: np.ndarray  # int32 [C] pair index
    left_pos: np.ndarray  # int64 [C] left ((+)-strand) leg start
    right_pos: np.ndarray  # int64 [C] right ((-)-strand) leg start
    left_is_read2: np.ndarray  # bool [C]

    def __len__(self) -> int:
        return len(self.pair)


def _compress(pos: np.ndarray, gap: int) -> np.ndarray:
    """Keep the first of each run of positions within ``gap`` of the
    last kept one (MC_Compress, DV-DPfunctions.cpp:2015-2026)."""
    if len(pos) == 0:
        return pos
    keep = np.zeros(len(pos), dtype=bool)
    keep[0] = True
    last = pos[0]
    for i in range(1, len(pos)):
        if last + gap < pos[i]:
            keep[i] = True
            last = pos[i]
    return pos[keep]


def pair_candidates(
    sp1: SeedPositions,  # read1 (end 0) candidate positions
    sp2: SeedPositions,  # read2 (end 1)
    read_lens1: np.ndarray,
    read_lens2: np.ndarray,
    params: AlignParams,
) -> Candidates:
    """Join per-pair positions across the insert window (both leg
    assignments). Pair index = read index (ends stored separately)."""
    out_pair: List[np.ndarray] = []
    out_lp: List[np.ndarray] = []
    out_rp: List[np.ndarray] = []
    out_flip: List[np.ndarray] = []

    for flip, (lsp, rsp, rlen) in enumerate(
        (
            (sp1, sp2, read_lens2),  # read1 is + left leg; read2 - right
            (sp2, sp1, read_lens1),  # read2 is + left leg; read1 - right
        )
    ):
        lmask = lsp.strand == 0
        rmask = rsp.strand == 1
        lread = lsp.read[lmask]
        lpos = lsp.pos[lmask]
        rread = rsp.read[rmask]
        rpos = rsp.pos[rmask]
        if len(lread) == 0 or len(rread) == 0:
            continue

        lorder = np.lexsort((lpos, lread))
        rorder = np.lexsort((rpos, rread))
        lread, lpos = lread[lorder], lpos[lorder]
        rread, rpos = rread[rorder], rpos[rorder]

        # divide-gap compression of left positions per read (anchor
        # chain), vectorized as pointer jumping over a composite
        # (read, pos) key — one round per chain depth instead of one
        # searchsorted per anchor
        nl = len(lread)
        rchange = np.flatnonzero(np.r_[True, lread[1:] != lread[:-1], True])
        base = lpos.min()
        key = (lread.astype(np.int64) << 34) | (lpos - base)
        nxt = np.searchsorted(
            key,
            (lread.astype(np.int64) << 34) | (lpos - base + params.divide_gap),
            side="right",
        )
        seg_end = rchange[
            np.searchsorted(rchange, np.arange(nl, dtype=np.int64), side="right")
        ]
        keep = np.zeros(nl, dtype=bool)
        active = rchange[:-1].astype(np.int64)
        while len(active):
            keep[active] = True
            prev = active
            active = nxt[active]
            active = active[active < seg_end[prev]]
        lread, lpos = lread[keep], lpos[keep]

        # composite-key window join over ALL reads at once
        rl_arr = np.asarray(rlen, dtype=np.int64)[lread]
        margin = np.where(rl_arr > 100, 30, 25)
        length_low = np.maximum(0, params.insert_low - rl_arr - margin)
        length_high = params.insert_high - rl_arr + margin
        BIG = np.int64(1) << 40
        rkey = rread.astype(np.int64) * BIG + rpos
        lo_key = lread.astype(np.int64) * BIG + lpos + length_low
        hi_key = lread.astype(np.int64) * BIG + lpos + length_high
        s = np.searchsorted(rkey, lo_key, "left")
        e = np.searchsorted(rkey, hi_key, "right")
        counts = e - s
        tot = int(counts.sum())
        if tot == 0:
            continue
        lidx = np.repeat(np.arange(len(lread)), counts)
        within = np.arange(tot) - np.repeat(np.cumsum(counts) - counts, counts)
        ridx = s[lidx] + within
        out_pair.append(lread[lidx].astype(np.int32))
        out_lp.append(lpos[lidx])
        out_rp.append(rpos[ridx])
        out_flip.append(np.full(tot, bool(flip)))

    if not out_pair:
        z = np.zeros(0)
        return Candidates(
            z.astype(np.int32), z.astype(np.int64), z.astype(np.int64), z.astype(bool)
        )
    return Candidates(
        pair=np.concatenate(out_pair),
        left_pos=np.concatenate(out_lp),
        right_pos=np.concatenate(out_rp),
        left_is_read2=np.concatenate(out_flip),
    )
