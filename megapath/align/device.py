"""Device-resident alignment step (the jittable "forward" of the engine).

One fused XLA program per batch: gather candidate reference windows
from the device-resident shard, run the batched affine-gap DP for both
pair legs, threshold, and reduce per-candidate results to per-read
best scores. This is the hot path the per-chip throughput comes from;
host code only prepares candidate arrays (seeding/pairing).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from megapath.ops.dp import DPParams, sw_align

OFF_TEXT_CODE = 4


class AlignStepOut(NamedTuple):
    score: jnp.ndarray  # int32 [C] per-candidate DP score
    end_ref: jnp.ndarray  # int32 [C] window-relative alignment end
    end_read: jnp.ndarray  # int32 [C]
    passed: jnp.ndarray  # bool [C] score >= max(ratio*len, lb)


def gather_windows(
    ref_codes: jnp.ndarray, starts: jnp.ndarray, width: int
) -> jnp.ndarray:
    """[C] start positions -> [C, width] windows; off-text cells get
    OFF_TEXT_CODE (forced mismatch)."""
    n = ref_codes.shape[0]
    idx = starts[:, None] + jnp.arange(width, dtype=starts.dtype)[None, :]
    valid = (idx >= 0) & (idx < n)
    win = jnp.take(ref_codes, jnp.clip(idx, 0, n - 1), axis=0)
    return jnp.where(valid, win, OFF_TEXT_CODE).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("width", "params"))
def align_step(
    ref_codes: jnp.ndarray,  # uint8 [N] device-resident shard text
    reads: jnp.ndarray,  # uint8 [C, L] candidate read codes (oriented)
    read_lens: jnp.ndarray,  # int32 [C]
    win_starts: jnp.ndarray,  # int64/int32 [C] window start positions
    width: int,
    params: DPParams = DPParams(),
    cutoff_ratio: float = 0.2,
    cutoff_lb: int = 30,
) -> AlignStepOut:
    """Gather + DP + threshold as one compiled program."""
    wins = gather_windows(ref_codes, win_starts, width)
    wlens = jnp.full(reads.shape[0], width, dtype=jnp.int32)
    res = sw_align(reads, wins, read_lens, wlens, params=params)
    thr = jnp.maximum(
        (cutoff_ratio * read_lens).astype(jnp.int32), jnp.int32(cutoff_lb)
    )
    return AlignStepOut(
        score=res.score,
        end_ref=res.end_ref,
        end_read=res.end_read,
        passed=res.score >= thr,
    )


class FullAlignOut(NamedTuple):
    score: jnp.ndarray  # int32 [C]
    start_ref: jnp.ndarray  # int32 [C] window-relative alignment start
    end_ref: jnp.ndarray  # int32 [C] window-relative end (exclusive)
    end_read: jnp.ndarray  # int32 [C]
    start_read: jnp.ndarray  # int32 [C]


def align_with_starts(
    ref_codes: jnp.ndarray,  # uint8 [N] device-resident shard text
    reads: jnp.ndarray,  # uint8 [C, L]
    read_lens: jnp.ndarray,  # int32 [C]
    win_starts: jnp.ndarray,  # int32 [C]
    width: int,
    params: DPParams = DPParams(),
    win_lens: jnp.ndarray | None = None,  # int32 [C] effective lengths
) -> FullAlignOut:
    """Window gather + forward DP + reverse DP, one compiled program.

    ``win_lens`` bounds each row's usable window (soap4 clips the DNA
    window length per candidate, e.g. to leftHit + insert_high for the
    right pair leg, DV-DPfunctions.cpp:2954-2959); cells past it are
    excluded from the DP. Defaults to the full ``width``.
    """
    if win_lens is None:
        win_lens = jnp.full(reads.shape[0], width, dtype=jnp.int32)
    return _align_with_starts(
        ref_codes, reads, read_lens, win_starts,
        jnp.asarray(win_lens, jnp.int32), width, params
    )


@functools.partial(jax.jit, static_argnames=("width", "params"))
def _align_with_starts(
    ref_codes: jnp.ndarray,
    reads: jnp.ndarray,
    read_lens: jnp.ndarray,
    win_starts: jnp.ndarray,
    win_lens: jnp.ndarray,
    width: int,
    params: DPParams = DPParams(),
) -> FullAlignOut:
    """Window gather, then ``_align_with_starts_wins``."""
    wins = gather_windows(ref_codes, win_starts, width)
    return _align_with_starts_wins(
        reads, wins, read_lens, win_lens, width, params
    )


@functools.partial(jax.jit, static_argnames=("width", "params"))
def deep_dp_fused(
    ref_codes: jnp.ndarray,
    left_reads: jnp.ndarray,  # [C, L] forward codes of the left leg
    left_lens: jnp.ndarray,
    left_starts: jnp.ndarray,  # int32 window starts (pos - margin)
    left_win_lens: jnp.ndarray,
    right_reads: jnp.ndarray,  # [C, L] revcomp codes of the right leg
    right_lens: jnp.ndarray,
    right_starts: jnp.ndarray,
    right_full_wl: jnp.ndarray,  # readLen + 2*margin before clipping
    width: int,
    insert_high: int,
    params: DPParams = DPParams(),
) -> Tuple[FullAlignOut, FullAlignOut]:
    """Both deep-DP legs in ONE device program.

    The reference aligns the right end per left-passing candidate with
    the window clipped to leftHit + insert_high
    (DV-DPfunctions.cpp:2933-2959). Doing the clip ON DEVICE (the left
    hit position feeds the right win_lens without a host round trip)
    removes the mid-stage sync; the right leg is computed for every
    candidate and the left-leg threshold gates the OUTPUT on the host,
    so the kept hits are identical to the reference's sequential
    two-phase flow.
    """
    left = _align_with_starts(
        ref_codes, left_reads, left_lens, left_starts,
        left_win_lens, width, params,
    )
    hit_left = left_starts + left.start_ref
    bound = hit_left + jnp.int32(insert_high) - right_starts
    wl_r = jnp.clip(jnp.minimum(right_full_wl, bound), 0, width)
    right = _align_with_starts(
        ref_codes, right_reads, right_lens, right_starts,
        wl_r.astype(jnp.int32), width, params,
    )
    return left, right


def pack_ref_words(codes: "np.ndarray"):
    """Host one-time: uint8 codes [n] -> uint32 words [(n+15)//16],
    char j at bits 2*(j%16) of word j//16 (the seeding walk's packed
    layout)."""
    import numpy as np

    n = len(codes)
    nw = (n + 15) // 16
    pad = np.zeros(nw * 16, np.uint32)
    pad[:n] = codes
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (pad.reshape(nw, 16) << shifts).sum(axis=1, dtype=np.uint32)


def gather_windows_packed(
    ref_words: jnp.ndarray,  # uint32 [(n+15)//16]
    n_text: int,
    starts: jnp.ndarray,  # int32 [C]
    width: int,
) -> jnp.ndarray:
    """[C] window starts -> [C, width] char codes, gathering at PACKED
    WORD granularity: C x (width/16+1) word rows instead of C x width
    scalar gathers — the gather unit's cost is per row (~4 ns), so
    this is ~16x cheaper than the byte-level gather_windows. Off-text
    cells get OFF_TEXT_CODE."""
    assert width % 16 == 0, "packed window gather needs 16-aligned width"
    C = starts.shape[0]
    nw = width // 16 + 1
    nwords = ref_words.shape[0]
    w0 = starts >> 4
    cols = w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :]
    words = jnp.take(
        ref_words, jnp.clip(cols, 0, nwords - 1).reshape(-1), axis=0
    ).reshape(C, nw)
    b = (2 * (starts & 15)).astype(jnp.uint32)[:, None]
    aligned = (words[:, :-1] >> b) | jnp.where(
        b > 0, words[:, 1:] << (jnp.uint32(32) - b), jnp.uint32(0)
    )  # (C, width//16): char j of the window at bits 2*(j%16) of col j//16
    rep = jnp.repeat(aligned, 16, axis=1)[:, :width]
    j = jnp.arange(width, dtype=jnp.int32)
    chars = (
        (rep >> (2 * (j & 15)).astype(jnp.uint32)[None, :]) & jnp.uint32(3)
    ).astype(jnp.int32)
    idx = starts[:, None] + j[None, :]
    ok = (idx >= 0) & (idx < n_text)
    return jnp.where(ok, chars, OFF_TEXT_CODE).astype(jnp.uint8)


@functools.partial(
    jax.jit, static_argnames=("n_text", "nb", "width", "params")
)
def deep_dp_fused_walk(
    ref_words: jnp.ndarray,  # uint32 packed shard text
    n_text: int,
    walkers: jnp.ndarray,  # uint8 [2*nb, L]: [reads; revcomp] rows
    lens_all: jnp.ndarray,  # int32 [nb]
    nb: int,
    left_idx: jnp.ndarray,  # int32 [C] read rows of the left (+) legs
    left_starts: jnp.ndarray,
    left_win_lens: jnp.ndarray,
    right_idx: jnp.ndarray,  # int32 [C] read rows of the right (-) legs
    right_starts: jnp.ndarray,
    right_full_wl: jnp.ndarray,
    width: int,
    insert_high: int,
    params: DPParams = DPParams(),
) -> Tuple[FullAlignOut, FullAlignOut]:
    """Both deep-DP legs against the seeding walk's resident state:
    candidate reads come straight from the walker matrix (row i =
    forward read i, row nb+i = its revcomp — no on-device revcomp
    gather at all), and the reference windows gather at packed-word
    granularity (gather_windows_packed). The host ships only int32
    index arrays. Semantics identical to deep_dp_fused
    (DV-DPfunctions.cpp:2933-2959 right-window clip on device)."""
    left_reads = jnp.take(walkers, left_idx, axis=0)
    left_lens = jnp.take(lens_all, left_idx).astype(jnp.int32)
    right_reads = jnp.take(walkers, right_idx + jnp.int32(nb), axis=0)
    right_lens = jnp.take(lens_all, right_idx).astype(jnp.int32)
    wins_l = gather_windows_packed(ref_words, n_text, left_starts, width)
    left = _align_with_starts_wins(
        left_reads, wins_l, left_lens, left_win_lens, width, params
    )
    hit_left = left_starts + left.start_ref
    bound = hit_left + jnp.int32(insert_high) - right_starts
    wl_r = jnp.clip(jnp.minimum(right_full_wl, bound), 0, width)
    wins_r = gather_windows_packed(ref_words, n_text, right_starts, width)
    right = _align_with_starts_wins(
        right_reads, wins_r, right_lens, wl_r.astype(jnp.int32), width,
        params,
    )
    return left, right


@functools.partial(
    jax.jit, static_argnames=("n_text", "width", "params")
)
def align_rows_walk(
    ref_words: jnp.ndarray,
    n_text: int,
    walkers: jnp.ndarray,  # uint8 [2*nb, L]: [reads; revcomp]
    rows: jnp.ndarray,  # int32 [C] walker rows (idx + strand*nb)
    read_lens: jnp.ndarray,  # int32 [C]
    win_starts: jnp.ndarray,  # int32 [C]
    win_lens: jnp.ndarray,  # int32 [C]
    width: int,
    params: DPParams = DPParams(),
) -> FullAlignOut:
    """Single-leg DP (SE / mate rescue) against the walker matrix +
    packed window gather: the oriented read IS a walker row (forward
    at idx, revcomp at nb+idx), so the host ships only row indices."""
    reads = jnp.take(walkers, rows, axis=0)
    wins = gather_windows_packed(ref_words, n_text, win_starts, width)
    return _align_with_starts_wins(
        reads, wins, read_lens, win_lens, width, params
    )


def _align_with_starts_wins(
    reads: jnp.ndarray,
    wins: jnp.ndarray,
    read_lens: jnp.ndarray,
    win_lens: jnp.ndarray,
    width: int,
    params: DPParams,
) -> FullAlignOut:
    """Forward DP, then a reverse DP over the reversed read/window
    prefixes ending at the forward optimum: its end cell is the
    alignment start, so no backtrack table is needed and nothing
    round-trips to the host."""
    L = reads.shape[1]
    fwd = sw_align(reads, wins, read_lens, win_lens, params=params)
    jj = jnp.arange(L, dtype=jnp.int32)[None, :]
    rsrc = fwd.end_read[:, None] - 1 - jj
    rev_reads = jnp.where(
        rsrc >= 0,
        jnp.take_along_axis(reads, jnp.clip(rsrc, 0, L - 1), axis=1),
        0,
    ).astype(jnp.uint8)
    ii = jnp.arange(width, dtype=jnp.int32)[None, :]
    wsrc = fwd.end_ref[:, None] - 1 - ii
    rev_wins = jnp.where(
        wsrc >= 0,
        jnp.take_along_axis(wins, jnp.clip(wsrc, 0, width - 1), axis=1),
        OFF_TEXT_CODE,
    ).astype(jnp.uint8)
    rev = sw_align(
        rev_reads, rev_wins, fwd.end_read, fwd.end_ref, params=params
    )
    return FullAlignOut(
        score=fwd.score,
        start_ref=fwd.end_ref - rev.end_ref,
        end_ref=fwd.end_ref,
        end_read=fwd.end_read,
        start_read=fwd.end_read - rev.end_read,
    )


@functools.partial(jax.jit, static_argnames=("width", "params"))
def pair_align_step(
    ref_codes: jnp.ndarray,
    left_reads: jnp.ndarray,  # [C, L] forward codes of the + leg
    left_lens: jnp.ndarray,
    left_starts: jnp.ndarray,
    right_reads: jnp.ndarray,  # [C, L] revcomp codes of the - leg
    right_lens: jnp.ndarray,
    right_starts: jnp.ndarray,
    width: int,
    params: DPParams = DPParams(),
    cutoff_ratio: float = 0.2,
    cutoff_lb: int = 30,
):
    """Both pair legs in one batch; returns per-leg results + pair keep
    mask (both ends over threshold, DV-DPfunctions.cpp:3439-3440)."""
    reads = jnp.concatenate([left_reads, right_reads])
    lens = jnp.concatenate([left_lens, right_lens])
    starts = jnp.concatenate([left_starts, right_starts])
    out = align_step(
        ref_codes, reads, lens, starts, width, params, cutoff_ratio, cutoff_lb
    )
    C = left_reads.shape[0]
    keep = out.passed[:C] & out.passed[C:]
    return out, keep
