"""The two-pass start-finding DP (align.device) against the scalar oracle.

The forward pass gives the score and end cell; the reverse pass over the
reversed prefixes gives the start cell. Both must equal
``ops.dp.sw_align_oracle`` (first-encountered maximum in (read, ref)
scan order), the start cell being the oracle's end cell on the reversed
prefixes — which pins the start-cell tie-breaks too.
"""

import functools

import jax
import numpy as np
import pytest

from megapath.align.device import (
    _align_with_starts,
    _align_with_starts_wins,
    gather_windows,
)
from megapath.align.engine import dp_window_width
from megapath.ops.dp import DPParams, sw_align_oracle


def _oracle_full(read, win):
    score, end_ref, end_read = sw_align_oracle(read, win)
    _, rev_ref, rev_read = sw_align_oracle(
        read[:end_read][::-1], win[:end_ref][::-1]
    )
    return score, end_ref - rev_ref, end_ref, end_read, end_read - rev_read


def _world(kind, L, W, C=6, seed=0):
    """Reads, a reference text and per-row window starts/lengths.

    ``planted``: the read sits in its window with substitutions and an
    indel. ``ties``: windows hold the read twice and the reads are
    short-period repeats, so equal-score alignments start at several
    cells."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (C, L)).astype(np.uint8)
    if kind == "ties":
        for c in range(C):
            unit = rng.integers(0, 4, 2 + c % 3).astype(np.uint8)
            reads[c] = np.resize(unit, L)
            reads[c, L // 2] = (reads[c, L // 2] + 1) % 4
    read_lens = np.full(C, L, np.int32)
    read_lens[1::2] = L - 17
    text = rng.integers(0, 4, C * W + 64).astype(np.uint8)
    starts = (np.arange(C) * W + 32).astype(np.int32)
    for c in range(C):
        body = reads[c, : read_lens[c]].copy()
        body[5::37] = (body[5::37] + 2) % 4
        body = np.concatenate([body[:40], body[43:]])  # read insertion
        off = starts[c] + 11
        text[off: off + len(body)] = body
        if kind == "ties":
            half = min(len(body), W - 11 - len(body) - 4)
            if half > 0:
                text[off + len(body) + 4: off + len(body) + 4 + half] = (
                    body[:half]
                )
    win_lens = np.full(C, W, np.int32)
    win_lens[2::3] = W - 9
    return reads, read_lens, text, starts, win_lens


@pytest.mark.parametrize("kind", ["planted", "ties"])
@pytest.mark.parametrize("read_len", [100, 150])
def test_align_with_starts_matches_oracle(read_len, kind):
    W = dp_window_width(read_len)
    reads, read_lens, text, starts, win_lens = _world(kind, read_len, W)
    params = DPParams()
    got = _align_with_starts(
        text, reads, read_lens, starts, win_lens, W, params
    )
    wins = gather_windows(text, starts, W)
    got_w = jax.jit(
        functools.partial(_align_with_starts_wins, width=W, params=params)
    )(reads, wins, read_lens, win_lens)
    wins = np.asarray(wins)
    fields = ("score", "start_ref", "end_ref", "end_read", "start_read")
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(got_w, f))
        )
    for c in range(len(reads)):
        exp = _oracle_full(reads[c, : read_lens[c]], wins[c, : win_lens[c]])
        assert tuple(int(getattr(got, f)[c]) for f in fields) == exp, c
