"""Suffix-array construction (host-side index build).

Replaces the reference's QSufSort-based builder
(/root/reference/soap4/2bwt-lib/QSufSort.c, BWTConstruct.c) with a
numpy prefix-doubling sort: O(n log^2 n) but fully vectorized, which on
a build host beats the pointer-chasing qsufsort for the shard sizes we
index per device. A C++ SA-IS builder can slot in behind the same API
for the 3.9-Gbp production shards.

The text is the 2-bit code array; a virtual sentinel smaller than every
character terminates it (the suffix array covers positions 0..n-1, the
sentinel suffix is implicit and excluded, matching standard FM-index
construction).
"""

from __future__ import annotations

import numpy as np


def suffix_array(codes: np.ndarray, native: bool = True) -> np.ndarray:
    """Suffix array of ``codes`` (uint8, values 0..3) as int64 [n].

    Uses the native linear-time SA-IS builder when available
    (megapath.native), falling back to numpy prefix doubling.
    """
    if native and len(codes) > 1:
        try:
            from megapath.native.build import suffix_array_native

            sa = suffix_array_native(codes)
            if sa is not None:
                return sa
        except Exception as e:  # pragma: no cover - depends on toolchain
            import sys

            print(
                f"[suffix] native SA-IS builder unavailable ({e!r}); "
                "falling back to numpy prefix doubling",
                file=sys.stderr,
            )
    return _suffix_array_doubling(codes)


def _suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    """numpy prefix-doubling fallback (O(n log^2 n))."""
    n = len(codes)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)

    rank = codes.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        # second sort key: rank of suffix i+k, -1 past the end
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        # recompute ranks: same (first, second) pair -> same rank
        f = rank[order]
        s = second[order]
        changed = np.r_[False, (f[1:] != f[:-1]) | (s[1:] != s[:-1])]
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[order] = np.cumsum(changed)
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order
        k *= 2


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT over text+sentinel, returned WITHOUT the sentinel cell.

    Returns (bwt codes uint8 [n], primary) where ``primary`` is the row
    of the full (n+1)-row BWT matrix that would hold the sentinel —
    i.e. the rank of the full-text suffix plus one (row 0 is the
    sentinel suffix). bwt[i] for i>=primary corresponds to full-BWT row
    i+1. This matches the classic sentinel-free FM layout.
    """
    n = len(codes)
    # full BWT rows: row 0 = sentinel suffix "$" -> bwt char = last char
    # row r>0 = suffix sa[r-1]      -> bwt char = codes[sa[r-1]-1],
    #                                  sentinel where sa[r-1]==0
    out = np.empty(n, dtype=np.uint8)
    out[0] = codes[-1]  # row 0
    prev = sa - 1
    primary_row = int(np.flatnonzero(sa == 0)[0]) + 1
    # rows 1..n map to sa[0..n-1]; drop the sentinel cell at primary_row
    chars = codes[prev]  # garbage at sa==0, dropped below
    before = chars[: primary_row - 1]
    after = chars[primary_row:]
    out[1:primary_row] = before
    out[primary_row:] = after
    return out, primary_row


def validate_sa(codes: np.ndarray, sa: np.ndarray, samples: int = 50) -> bool:
    """Spot-check sorted order of sampled adjacent suffix pairs."""
    n = len(sa)
    if n < 2:
        return True
    rng = np.random.default_rng(0)
    for i in rng.integers(0, n - 1, size=min(samples, n - 1)):
        a = codes[sa[i] :].tobytes()
        b = codes[sa[i + 1] :].tobytes()
        if not (a < b or (a == b and sa[i] > sa[i + 1])):
            return False
    return True
