"""Device-resident MMP seeding: the FM backward-search state machine
as one compiled XLA while_loop.

Port of megapath.align.seeding.mmp_seed to jnp: all walkers step in
lockstep; each iteration issues two batched rank queries (occ
checkpoint gather + in-register popcount over the 2-bit BWT block) or
a k-mer LUT gather, applies the narrowing-tracked reseed/rollback
rules, and scatters emitted seeds into fixed per-walker slots. The
whole walk compiles to a single program, so the sequential structure
costs no launch overhead — the reference needs a pthread pool for this
(DV-DPfunctions.cpp:2443-2467); here it is one device call.

Device arrays are int32/uint32: shards must be < 2^31 chars (the
3.9 Gbp reference shard cap needs the uint32 paths; int32 keeps this
port at <= 2 Gbp per device shard, split finer by shard.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from megapath.align.params import MmpParams
from megapath.index.fm import FMIndex, OCC_BLOCK, WORD_CHARS

# Device-side occ granularity for HBM-resident shards, decoupled from
# the host layout: paired rows at 32-char blocks are 32 B (4 occ +
# 2+2 words) covering a 64-char span, so once a walker's interval is
# below the span BOTH rank queries resolve from ONE gathered row.
# blk=32 won a sweep of 16/32/64 on the previous accelerator; to be
# re-swept on the card (ROADMAP A6). Smaller rows fetch cheaper and
# halve the SWAR popcount until the extra wide-phase stalls win out.
# The sub-block checkpoints derive from the host's 128-grain table at
# commit time.
OCC_BLOCK_DEV = 32


@jax.tree_util.register_pytree_node_class
class DeviceFM:
    """FM-index arrays on device (int32 coordinate space).

    Registered as a pytree with the scalar metadata (n, primary,
    lut_k, sa_interval) as static aux data so jit treats them as
    compile-time constants.
    """

    def __init__(self, n, primary, bwt_words, fused_rows,
                 counts, lut_k, mark_rows, sa_sampled,
                 sa_interval, blk=OCC_BLOCK_DEV):
        self.n = n
        self.primary = primary
        # occ block granularity of fused_rows: < 128 = paired rows
        # (words span 2*blk chars from a blk-aligned base; both rank
        # queries of a narrow interval resolve from one row — the
        # HBM-resident two-phase walk mode), 128 = classic
        # single-block rows (the cache-resident layout)
        self.blk = blk
        self.bwt_words = bwt_words  # uint32 [n_words]
        # fused uint32 occ row table, one gather launch per rank batch:
        # row b = occ checkpoint (4 counts) || the block's packed BWT
        # words. The k-mer LUT rows prefix the table (see from_host).
        self.fused_rows = fused_rows
        self.counts = counts  # int32 [5]
        self.lut_k = lut_k
        # sampled-SA mark rank as one (bitmap word, rank checkpoint)
        # row per 32 BWT rows: 0.25 B/char on device instead of the
        # 4 B/char full int32 prefix array, and a mark lookup is ONE
        # row fetch (word and checkpoint ride together).
        self.mark_rows = mark_rows  # uint32 [ceil((n+1)/32), 2]
        self.sa_sampled = sa_sampled  # int32 [n_marked]
        self.sa_interval = sa_interval

    def tree_flatten(self):
        leaves = (self.bwt_words, self.fused_rows,
                  self.counts, self.mark_rows,
                  self.sa_sampled)
        aux = (self.n, self.primary, self.lut_k, self.sa_interval,
               self.blk)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        n, primary, lut_k, sa_interval, blk = aux
        (bwt_words, fused_rows, counts, mark_rows,
         sa_sampled) = leaves
        return cls(n, primary, bwt_words, fused_rows, counts,
                   lut_k, mark_rows, sa_sampled, sa_interval,
                   blk=blk)

    @classmethod
    def from_host(cls, fm: FMIndex, device=None,
                  paired: bool | None = None) -> "DeviceFM":
        """``device`` pins the arrays to a specific device (committed),
        so jit calls taking this DeviceFM execute there — the basis of
        the per-shard mesh placement in ``parallel.cascade``.

        ``paired`` selects the fused-row layout (None = auto by table
        size): paired OCC_BLOCK_DEV-char rows for HBM-resident shards
        (enables the single-gather two-phase walk), classic 128-char
        rows for cache-resident shards (the stall-free two-gather
        walk stays fastest there)."""
        assert fm.n < 2**31, "device seeding path requires shard < 2^31"

        def put(a):
            return jnp.asarray(a) if device is None else jax.device_put(a, device)

        lut_k = fm.lut_k
        if paired is None:
            paired = int(fm.n) * 3 // 4 > (64 << 20)  # ~0.75 B/char
        # PAIRED blk-char rows: row b = occ checkpoint at blk*b ||
        # packed words covering chars [blk*b, blk*b + 2*blk). Per the
        # measured gather model (tools/gather_probe.py: per-row cost
        # is fixed-ish + per-byte; neither constant-index redirects
        # nor duplicate indices make a fetch cheaper), ONE small row
        # per walker per step is the optimum: a walker whose interval
        # is < blk rows resolves BOTH rank queries from one row (wide
        # intervals take the two-phase path in the walk body).
        # blk=32 won the sweep — see OCC_BLOCK_DEV above.
        if paired:
            blk = OCC_BLOCK_DEV
            ratio = OCC_BLOCK // blk
            wpb = blk // WORD_CHARS
            B128 = fm.occ.shape[0] - 1
            w128 = fm.bwt_words.reshape(-1, OCC_BLOCK // WORD_CHARS)
            n_rows_tbl = ratio * B128 + 1
            occS = np.zeros((n_rows_tbl, 4), np.uint32)
            occS[0 : ratio * B128 + 1 : ratio] = fm.occ.astype(np.uint32)
            # sub-block checkpoints: prefix popcounts over the host
            # block's word groups
            pref = np.zeros((B128, 4), np.uint32)
            for q in range(1, ratio):
                wq = w128[:, (q - 1) * wpb : q * wpb]
                for c in range(4):
                    pat = np.uint32(c * 0x55555555)
                    x = ~(wq ^ pat)
                    mm_ = x & (x >> np.uint32(1)) & np.uint32(0x55555555)
                    pref[:, c] += np.bitwise_count(mm_).sum(
                        axis=1, dtype=np.uint32
                    )
                occS[q : ratio * B128 : ratio] = (
                    fm.occ[:B128].astype(np.uint32) + pref
                )
            wordsS = fm.bwt_words.reshape(-1, wpb)
            wS = np.concatenate(
                [wordsS, np.zeros((2, wpb), np.uint32)]
            )
            occ_fused = np.zeros(
                (n_rows_tbl, 4 + 2 * wpb), dtype=np.uint32
            )
            occ_fused[:, :4] = occS
            occ_fused[:, 4 : 4 + wpb] = wS[:n_rows_tbl]
            occ_fused[:, 4 + wpb :] = wS[1 : n_rows_tbl + 1]
        else:
            blk = OCC_BLOCK
            wpb128 = OCC_BLOCK // WORD_CHARS
            words2d = fm.bwt_words.reshape(-1, wpb128)
            n_blocks = fm.occ.shape[0] - 1
            occ_fused = np.zeros(
                (n_blocks + 1, 4 + wpb128), dtype=np.uint32
            )
            occ_fused[:, :4] = fm.occ.astype(np.uint32)
            m = min(n_blocks, words2d.shape[0])
            occ_fused[:m, 4:] = words2d[:m]
        if lut_k:
            # The k-mer LUT lives IN the fused table, as rows [0, 4^k)
            # BEFORE the occ blocks (occ block b at row 4^k + b, a
            # STATIC offset): fresh walkers need the LUT and not occ,
            # so the walk steers their occ-gather slot at the LUT row
            # instead of issuing a separate 1-row-per-walker LUT
            # gather — the gather unit's cost is per row (~4 ns), so
            # this cuts the per-step gather volume by 1/3.
            #
            # LUT rows are indexed by the LITTLE-endian 2-bit key: the
            # walk's funnel-shifted packed-word chunk holds chars at
            # bits 2t in ascending position order, so `chunk & mask`
            # is the key directly — no per-step big-endian recompose.
            keys = np.arange(4**lut_k, dtype=np.int64)
            rev = np.zeros_like(keys)
            for t in range(lut_k):
                rev |= ((keys >> (2 * t)) & 3) << (2 * (lut_k - 1 - t))
            lut_rows = np.zeros(
                (4**lut_k, occ_fused.shape[1]), dtype=np.uint32
            )
            lut_rows[:, 0] = fm.lut_lo.astype(np.uint32)[rev]
            lut_rows[:, 1] = fm.lut_hi.astype(np.uint32)[rev]
            fused = np.concatenate([lut_rows, occ_fused])
        else:
            fused = occ_fused
        mark_words, mark_chk = pack_mark_rank(fm.mark_rank, int(fm.n))
        mark_rows = np.stack(
            [mark_words, mark_chk.astype(np.uint32)], axis=1
        )
        return cls(
            n=int(fm.n),
            primary=int(fm.primary),
            bwt_words=put(fm.bwt_words),
            fused_rows=put(fused),
            counts=put(fm.counts.astype(np.int32)),
            lut_k=int(lut_k),
            mark_rows=put(mark_rows),
            sa_sampled=put(fm.sa_sampled.astype(np.int32)),
            sa_interval=int(fm.sa_interval),
            blk=int(blk),
        )


def pack_mark_rank(mark_rank: np.ndarray, n: int):
    """Host prefix-rank array [n+2] -> (bitmap uint32 [ceil((n+1)/32)],
    32-row rank checkpoints int32)."""
    mr = np.asarray(mark_rank, np.int64)
    marked = mr[1 : n + 2] != mr[: n + 1]  # marked(r), r in [0, n]
    nw = (n + 1 + 31) // 32
    pad = np.zeros(nw * 32, bool)
    pad[: n + 1] = marked
    bits = pad.reshape(nw, 32)
    shifts = np.arange(32, dtype=np.uint32)
    words = (bits.astype(np.uint32) << shifts[None, :]).sum(
        axis=1, dtype=np.uint32
    )
    chk = mr[0 : nw * 32 : 32].astype(np.int32)
    return words, chk


def _mark_lookup(dfm: DeviceFM, r: jnp.ndarray):
    """(is_marked(r), rank-of-marks-below-r): ONE row fetch carries
    both the bitmap word and its rank checkpoint."""
    rows = jnp.take(dfm.mark_rows, r >> 5, axis=0)
    w = rows[:, 0]
    bit = (r & 31).astype(jnp.uint32)
    hit = ((w >> bit) & jnp.uint32(1)) > 0
    below = w & ((jnp.uint32(1) << bit) - jnp.uint32(1))
    rank = rows[:, 1].astype(jnp.int32) + jax.lax.population_count(
        below
    ).astype(jnp.int32)
    return hit, rank


def _occ_from_rows(
    rows: jnp.ndarray, rel: jnp.ndarray, c: jnp.ndarray
) -> jnp.ndarray:
    """In-row rank from pre-gathered fused rows (occ4 || words).

    Row width is generic: paired-block rows carry 2*wpb words, so
    ``rel`` may range over [0, 2*OCC_BLOCK) when the caller's rank
    target lands in the row's second block."""
    four = jnp.arange(4, dtype=jnp.int32)[None, :]
    base = jnp.sum(
        jnp.where(four == c[:, None], rows[:, :4], jnp.uint32(0)), axis=1
    ).astype(jnp.int32)
    w = rows[:, 4:]
    pat = (c.astype(jnp.uint32) * jnp.uint32(0x55555555))[:, None]
    x = ~(w ^ pat)
    m = x & (x >> jnp.uint32(1)) & jnp.uint32(0x55555555)
    wpb = rows.shape[1] - 4
    char_base = (jnp.arange(wpb, dtype=jnp.int32) * WORD_CHARS)[None, :]
    k = jnp.clip(rel[:, None] - char_base, 0, WORD_CHARS)  # chars to keep
    kk = jnp.minimum(k, WORD_CHARS - 1).astype(jnp.uint32)
    mask = jnp.where(
        k >= WORD_CHARS,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (jnp.uint32(2) * kk)) - jnp.uint32(1),
    )
    cnt = jax.lax.population_count(m & mask).astype(jnp.int32).sum(axis=1)
    return base + cnt


def _counts_of(dfm: DeviceFM, c: jnp.ndarray) -> jnp.ndarray:
    """counts[c] as a 4-way select (no gather)."""
    four = jnp.arange(4, dtype=jnp.int32)[None, :]
    return jnp.sum(
        jnp.where(four == c[:, None], dfm.counts[None, :4], 0), axis=1
    )


class DeviceSeeds(NamedTuple):
    offset: jnp.ndarray  # uint8 [W, S] (read offsets < 256)
    length: jnp.ndarray  # uint8 [W, S]
    sa_lo: jnp.ndarray  # int32 [W, S]
    sa_count: jnp.ndarray  # uint8 [W, S] (capped at threshold+1)
    n_seeds: jnp.ndarray  # uint8 [W]


class SeedWalkState(NamedTuple):
    """Resumable MMP walk state (per walker), enabling segmented runs
    with straggler compaction between segments: most walkers finish in
    ~L steps, but revcomp/junk walkers run to the step limit — chunk
    the loop, compact the still-active rows, and continue on the
    smaller batch."""

    i: jnp.ndarray
    lo: jnp.ndarray
    hi: jnp.ndarray
    seed_len: jnp.ndarray
    last_lo: jnp.ndarray
    last_hi: jnp.ndarray
    last_len: jnp.ndarray
    active: jnp.ndarray
    out_meta: jnp.ndarray
    out_lo: jnp.ndarray
    n_seeds: jnp.ndarray
    pend: jnp.ndarray  # wide-interval two-phase stash (-1 = none)
    steps: jnp.ndarray  # per-walker lockstep steps spent (progress kill)
    sib: jnp.ndarray  # sibling-cull latch: -1 unlatched, bit0 probe, bit1 victim


@jax.jit
def build_walkers(reads: jnp.ndarray, lens: jnp.ndarray):
    """[reads; revcomp(reads)] walker matrix on device."""
    N, L = reads.shape
    lens = lens.astype(jnp.int32)
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = lens[:, None] - 1 - j
    ok = src >= 0
    rc = jnp.where(
        ok,
        3 - jnp.take_along_axis(
            reads.astype(jnp.int32), jnp.clip(src, 0, L - 1), axis=1
        ),
        0,
    ).astype(jnp.uint8)
    return jnp.concatenate([reads, rc], axis=0), jnp.concatenate([lens, lens])


@jax.jit
def compact_walk(walkers, lens, state: SeedWalkState, idx, n_valid):
    """Gather still-active rows (idx padded; rows >= n_valid masked
    inactive) for the next walk segment."""
    take = lambda a: jnp.take(a, idx, axis=0)
    mask = jnp.arange(idx.shape[0], dtype=jnp.int32) < n_valid
    st = SeedWalkState(*[take(f) for f in state])
    st = st._replace(active=st.active & mask)
    return take(walkers), take(lens), st


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "max_seeds", "max_steps", "finalize", "two_phase",
        "sibling", "charge_limit",
    ),
)
def device_mmp_seed(
    dfm: DeviceFM,
    walkers: jnp.ndarray,  # uint8 [W, L]
    lens: jnp.ndarray,  # int32 [W]
    params: MmpParams,
    max_seeds: int = 16,
    max_steps: int | None = None,
    state: SeedWalkState | None = None,
    finalize: bool = True,
    two_phase: bool = False,
    sibling: bool = True,
    charge_limit: int | None = None,
):
    """``max_steps`` bounds loop ITERATIONS (compaction-plan grain);
    ``charge_limit`` retires each walker at a CHARGED-step count —
    the mode-invariant walk bound. Callers wanting identical seeds
    from both walk modes pass charge_limit=3L+64 and give two-phase
    runs a doubled iteration budget (a stall iteration charges
    nothing, so two-phase needs up to ~2x iterations to deliver the
    same charged steps; audit-measured: the iteration-capped
    truncation cost 2/40000 read ends at kill=0 before this)."""
    Wn, L = walkers.shape
    # the sibling cull needs the [fwd; rc] row pairing intact: fresh
    # full-width walks only (a resumed/compacted segment has already
    # had its level-0 probe; arbitrary odd-width walker sets have no
    # sibling structure)
    sibling = bool(sibling) and state is None and Wn % 2 == 0
    # seed metadata packs (off, len, cnt) into 12/10/10 bits of one
    # int32 — fail loudly instead of silently corrupting seeds
    if L > 1023:
        raise ValueError(f"device seeding caps read length at 1023 (got {L})")
    if params.sa_size_threshold + 1 > 1023:
        raise ValueError(
            f"sa_size_threshold {params.sa_size_threshold} overflows the "
            "10-bit seed-count field (max 1022)"
        )
    k = dfm.lut_k
    n_rows = dfm.n + 1
    lens = lens.astype(jnp.int32)
    walkers_i = walkers.astype(jnp.int32)

    # 2-bit packed walker words: char j lives at bits 2*(j%16) of word
    # j//16. The per-step column picks then one-hot over L/16 word
    # columns instead of L char columns (and the k-mer LUT value is
    # recomposed from a 2-word window), cutting the dominant per-step
    # stream from 2*Wn*L int32 reads to ~3*Wn*(L/16).
    n_words = (L + 15) // 16
    W16 = n_words + 1  # +1 pad word so j0//16 + 1 never overflows
    Lp = n_words * 16
    wpad = (
        jnp.pad(walkers_i, ((0, 0), (0, Lp - L)))
        .astype(jnp.uint32)
        .reshape(Wn, n_words, 16)
    )
    body = jnp.zeros((Wn, n_words), jnp.uint32)
    for t in range(16):
        body = body | (wpad[:, :, t] << jnp.uint32(2 * t))
    packed = jnp.pad(body, ((0, 0), (0, 1)))
    cols16 = jnp.arange(W16, dtype=jnp.int32)[None, :]

    def fetch_words2(a, b):
        """packed[row, {a,b}[row]] in ONE masked reduce."""
        idx = jnp.stack([a, b], axis=1)  # [Wn, 2]
        hit = cols16[:, None, :] == idx[:, :, None]  # [Wn, 2, W16]
        return jnp.sum(
            jnp.where(hit, packed[:, None, :], jnp.uint32(0)), axis=2
        )  # [Wn, 2]

    def char_and_kmer(j, j0):
        """(walker char at column j, little-endian k-mer key starting
        at column j0) — A-padded past the read end like the old
        precomputed km table.

        j == j0 + k - 1 (the k-mer ENDS at the cursor), so with k <=
        16 the char's word is always one of the k-mer's two packed
        words: two one-hot word fetches serve both, and the
        device-side LUT is indexed little-endian (see from_host) so
        the key is just `chunk & mask` — no per-char recompose."""
        jc = jnp.clip(j, 0, L - 1)
        j0c = jnp.clip(j0, 0, L - 1)
        w2 = fetch_words2(j0c >> 4, (j0c >> 4) + 1)
        w0, w1 = w2[:, 0], w2[:, 1]
        cw = jnp.where((jc >> 4) == (j0c >> 4), w0, w1)
        ch = ((cw >> (2 * (jc & 15)).astype(jnp.uint32)) & jnp.uint32(3)).astype(jnp.int32)
        if k:
            bshift = (2 * (j0c & 15)).astype(jnp.uint32)
            chunk = (w0 >> bshift) | jnp.where(
                bshift > 0, w1 << (jnp.uint32(32) - bshift), jnp.uint32(0)
            )
            v = (chunk & jnp.uint32((1 << (2 * k)) - 1)).astype(jnp.int32)
        else:
            v = jnp.zeros(Wn, jnp.int32)
        return ch, v


    class S(NamedTuple):
        i: jnp.ndarray
        lo: jnp.ndarray
        hi: jnp.ndarray
        seed_len: jnp.ndarray
        last_lo: jnp.ndarray
        last_hi: jnp.ndarray
        last_len: jnp.ndarray
        active: jnp.ndarray
        out_meta: jnp.ndarray  # (off << 20) | (len << 10) | cnt
        out_lo: jnp.ndarray
        n_seeds: jnp.ndarray
        pend: jnp.ndarray  # wide-interval two-phase stash (-1 = none)
        steps: jnp.ndarray  # per-walker steps spent (for the progress kill)
        sib: jnp.ndarray  # sibling-cull latch (-1 / bit0 probe, bit1 victim)
        step: jnp.ndarray

    if state is None:
        init = S(
            i=jnp.zeros(Wn, jnp.int32),
            lo=jnp.zeros(Wn, jnp.int32),
            hi=jnp.full(Wn, n_rows, jnp.int32),
            seed_len=jnp.zeros(Wn, jnp.int32),
            last_lo=jnp.zeros(Wn, jnp.int32),
            last_hi=jnp.full(Wn, n_rows, jnp.int32),
            last_len=jnp.zeros(Wn, jnp.int32),
            active=lens >= params.seed_min_length,
            out_meta=jnp.zeros((Wn, max_seeds), jnp.int32),
            out_lo=jnp.zeros((Wn, max_seeds), jnp.int32),
            n_seeds=jnp.zeros(Wn, jnp.int32),
            pend=jnp.full(Wn, -1, jnp.int32),
            steps=jnp.zeros(Wn, jnp.int32),
            sib=jnp.full(Wn, -1, jnp.int32),
            step=jnp.int32(0),
        )
    else:
        init = S(*state, step=jnp.int32(0))
    limit = max_steps if max_steps is not None else int(3 * L + 64)

    min_len = jnp.int32(params.seed_min_length)

    def emit(s: S, idx_mask, at_end) -> S:
        """CHECK_AND_ADD_RANGE for masked walkers. ``at_end`` may be a
        bool (all rows) or a per-row bool array: at-end rows keep their
        cursor/state, mid-walk rows reset + roll the cursor back — one
        unified pass serves both the done-emit and the fail-emit, so
        the output buffers are touched once per iteration."""
        if isinstance(at_end, bool):
            end_mask = jnp.full(idx_mask.shape, at_end)
        else:
            end_mask = at_end
        sl = s.seed_len
        can = sl >= min_len
        rb = (
            idx_mask
            & can
            & (sl >= params.reseed_len)
            & ((s.last_hi - s.last_lo) <= params.sa_size_threshold)
            & (
                ((sl - s.last_len) <= params.reseed_abs_diff)
                | (sl.astype(jnp.float32) * params.reseed_rlt_ratio
                   < s.last_len.astype(jnp.float32))
            )
        )
        diff = jnp.where(rb, sl - s.last_len, 0)
        lo = jnp.where(rb, s.last_lo, s.lo)
        hi = jnp.where(rb, s.last_hi, s.hi)
        sl = jnp.where(rb, s.last_len, sl)

        keep = idx_mask & (sl >= min_len)
        off_val = lens - s.i
        cnt_val = jnp.minimum(hi - lo, params.sa_size_threshold + 1)
        room = keep & (s.n_seeds < max_seeds)

        # one-hot select instead of a scatter: pure elementwise work
        # over the (W, max_seeds) bufs.
        # (off, len, cnt) pack into one int32 (10 bits each, L <= 1023)
        # to halve the carried-buffer HBM traffic per loop iteration.
        slot_cols = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        sel = room[:, None] & (slot_cols == s.n_seeds[:, None])
        meta_val = (off_val << 20) | (sl << 10) | cnt_val

        def scat(buf, val):
            return jnp.where(sel, val[:, None], buf)

        out_meta = scat(s.out_meta, meta_val)
        out_lo = scat(s.out_lo, lo)
        n_seeds = s.n_seeds + room.astype(jnp.int32)

        mid = idx_mask & ~end_mask  # mid-walk (fail) rows
        i = jnp.where(mid, s.i - (diff + jnp.minimum(sl, min_len) - 1), s.i)
        # a walker whose output buffer just filled can store nothing
        # more: retire it (identical output, no wasted loop steps)
        return s._replace(
            i=i,
            active=s.active & (n_seeds < max_seeds),
            lo=jnp.where(mid, 0, s.lo),
            hi=jnp.where(mid, n_rows, s.hi),
            seed_len=jnp.where(
                mid, 0, jnp.where(idx_mask & end_mask, sl, s.seed_len)
            ),
            last_lo=jnp.where(mid, 0, s.last_lo),
            last_hi=jnp.where(mid, n_rows, s.last_hi),
            last_len=jnp.where(mid, 0, s.last_len),
            out_meta=out_meta,
            out_lo=out_lo,
            n_seeds=n_seeds,
        )

    def body(s: S) -> S:
        # progress kill: junk walkers grind ~5 lockstep steps per
        # consumed char while productive walkers run ~1/char — retire
        # any walker whose step budget (kill_ratio * i + kill_base) is
        # exhausted. Per-walker and deterministic, so emitted seeds do
        # not depend on batch composition (placement-invariance holds).
        # Buffered seeds are kept; the in-flight partial seed drops,
        # exactly like the 3L+64 hard-cap truncation this replaces as
        # the junk wall-clock floor.
        if charge_limit is not None:
            # mode-invariant hard walk bound, checked like the host
            # loop's top-of-iteration bound: a walker that has spent
            # charge_limit charged steps retires with its in-flight
            # seed dropped (matching the classic-mode iteration cap,
            # where iterations == charged). Walkers already at the
            # read end are left to this iteration's done-emit — the
            # host's post-loop live-emit covers exactly those.
            s = s._replace(
                active=s.active
                & ((s.steps < jnp.int32(charge_limit)) | (s.i >= lens))
            )
        if params.kill_ratio > 0:
            over = s.steps.astype(jnp.float32) > (
                params.kill_ratio * s.i.astype(jnp.float32)
                + jnp.float32(params.kill_base)
            )
            s = s._replace(active=s.active & ~over)
        T0 = getattr(params, "sibling_kill_steps", 0)
        if sibling and T0 > 0:
            # one-shot sibling-evidence cull (see MmpParams): latch at
            # charged step T0 or at retirement; a latched victim
            # FREEZES (uncharged) until its opposite-strand sibling
            # (row w +- Wn/2) latches, then dies iff the sibling
            # probed a >= good_seed_len extension. Latch state and the
            # freeze are functions of the per-walker charged clock
            # only, so the kill set and all survivor outputs are
            # mode- and placement-invariant.
            newly = (s.sib < 0) & ((s.steps >= jnp.int32(T0)) | ~s.active)
            probe_b = (s.seed_len >= jnp.int32(params.good_seed_len))
            victim_b = (
                s.active
                & (s.n_seeds == 0)
                & (s.last_len == 0)
                & (s.seed_len < min_len)
            )
            lat_val = probe_b.astype(jnp.int32) | (
                victim_b.astype(jnp.int32) << 1
            )
            sibv = jnp.where(newly, lat_val, s.sib)
            sib_other = jnp.roll(sibv, Wn // 2)
            mine = s.active & (sibv >= 0) & ((sibv >> 1) & 1 == 1)
            kill = mine & (sib_other >= 0) & ((sib_other & 1) == 1)
            sib_pause = mine & (sib_other < 0)
            s = s._replace(active=s.active & ~kill, sib=sibv)
        else:
            sib_pause = jnp.zeros_like(s.active)
        fresh = s.active & (s.seed_len == 0) & ~sib_pause
        ext = s.active & (s.seed_len != 0) & ~sib_pause

        # fresh: remaining-length check
        rem = lens - s.i
        die = fresh & (rem < min_len)
        fresh = fresh & ~die
        active = s.active & ~die

        # ext walkers whose cursor ran off the end: deferred to the
        # single unified emit at the bottom (their state is untouched
        # by the char step since done rows leave fresh/ext)
        done = ext & (s.i >= lens)
        active = active & ~done
        ext = ext & ~done

        # SINGLE-gather rank step (tools/gather_probe.py: per-row cost
        # is fixed whether indices repeat or hit a hot row, so the only
        # lever is issuing ONE row per walker):
        #   fresh + LUT      -> the LUT prefix row (jump, no occ)
        #   fresh, no LUT    -> interval = [C[c], C[c+1]) from counts
        #   ext, interval<64 -> paired row at blk_lo serves BOTH ends
        #   ext, wide        -> two-phase: this step fetches blk_lo's
        #                       row and stashes occ(lo) in ``pend``;
        #                       the next step fetches blk_hi's row and
        #                       completes (cursor frozen in between)
        blk = dfm.blk
        row_span = (dfm.fused_rows.shape[1] - 4) * WORD_CHARS
        adj_lo = s.lo - (s.lo > dfm.primary).astype(jnp.int32)
        adj_hi = s.hi - (s.hi > dfm.primary).astype(jnp.int32)
        occ_off = jnp.int32(4**k if k else 0)
        blk_lo = adj_lo // blk + occ_off
        blk_hi = adj_hi // blk + occ_off
        if two_phase:
            # both ends resolvable from lo's row iff hi lands within
            # the row's word span (layout-generic)
            near = (adj_hi - (blk_lo - occ_off) * blk) < row_span
            phase1 = s.pend >= 0
            wide_stall = ext & ~near & ~phase1
        else:
            wide_stall = jnp.zeros_like(ext)
        # the step budget charges PROGRESSING steps only: charging
        # stalls makes the kill fire on legitimate rollback-heavy
        # walkers (a k=0 walker re-extends its rolled-back range
        # through the wide phase twice — up to ~4 charged steps per
        # net char, breaching ratio 2.5), which breaks device-vs-host
        # seed parity. Because the charge is mode-invariant and the
        # hard walk bound is now ``charge_limit`` (in charged steps,
        # with the iteration budget doubled for two-phase so stalls
        # can never truncate a walker below its charged allowance —
        # audit-measured at 2/40000 read ends before the fix), the two
        # walk modes emit IDENTICAL seeds.
        s = s._replace(
            steps=s.steps
            + (s.active & ~wide_stall & ~sib_pause).astype(jnp.int32)
        )

        # Per-row column picks one-hot over the PACKED word columns
        # (L/16 wide) instead of char columns: no 2D fancy gather, and
        # the packed reduce streams ~16x less than the old per-char
        # (2Wn, L) int32 plane.
        jj = jnp.clip(lens - 1 - s.i, 0, L - 1)
        if k:
            c, v = char_and_kmer(jj, lens - s.i - k)
        else:
            c, _ = char_and_kmer(jj, jj)
        c_ext = jnp.where(ext, c, 0)

        if two_phase:
            blk_sel = jnp.where(ext & ~near & phase1, blk_hi, blk_lo)
            if k:
                slot = jnp.where(fresh, v, blk_sel)
            else:
                slot = blk_sel
            rows = jnp.take(dfm.fused_rows, slot, axis=0)  # (Wn, 4+2w)
            if k:
                lut_lo = rows[:, 0].astype(jnp.int32)
                lut_hi = rows[:, 1].astype(jnp.int32)
            base_blk = blk_sel - occ_off
            rel_lo = adj_lo - base_blk * blk
            rel_hi = adj_hi - base_blk * blk
            rr = _occ_from_rows(
                jnp.concatenate([rows, rows]),
                jnp.concatenate([rel_lo, rel_hi]),
                jnp.concatenate([c_ext, c_ext]),
            )
            b_lo = jnp.where(phase1, s.pend, rr[:Wn])
            b_hi = rr[Wn:]
            new_pend = jnp.where(wide_stall, rr[:Wn], jnp.int32(-1))
        else:
            # cache-resident tables: fetch BOTH rows every step (row
            # fetches are cheap; avoiding the wide-phase stall
            # iterations wins — pick per shard size in the engine)
            if k:
                slot_lo = jnp.where(fresh, v, blk_lo)
            else:
                slot_lo = blk_lo
            rows2 = jnp.take(
                dfm.fused_rows, jnp.concatenate([slot_lo, blk_hi]), axis=0
            )
            if k:
                lut_lo = rows2[:Wn, 0].astype(jnp.int32)
                lut_hi = rows2[:Wn, 1].astype(jnp.int32)
            rel2 = jnp.concatenate(
                [adj_lo - (blk_lo - occ_off) * blk,
                 adj_hi - (blk_hi - occ_off) * blk]
            )
            rr = _occ_from_rows(
                rows2, rel2, jnp.concatenate([c_ext, c_ext])
            )
            b_lo = rr[:Wn]
            b_hi = rr[Wn:]
            new_pend = s.pend
        C = _counts_of(dfm, c_ext)
        nlo_e = C + b_lo
        nhi_e = C + b_hi

        if k:
            nlo = jnp.where(fresh, lut_lo, nlo_e)
            nhi = jnp.where(fresh, lut_hi, nhi_e)
        else:
            # LUT-free fresh jump needs no gather at all: the 1-char
            # interval is [counts[c], counts[c+1]) by construction
            five = jnp.arange(5, dtype=jnp.int32)[None, :]
            cf = jnp.sum(
                jnp.where(five == c[:, None], dfm.counts[None, :], 0),
                axis=1,
            )
            cf1 = jnp.sum(
                jnp.where(five == (c + 1)[:, None], dfm.counts[None, :], 0),
                axis=1,
            )
            nlo = jnp.where(fresh, cf, nlo_e)
            nhi = jnp.where(fresh, cf1, nhi_e)

        ok = nlo < nhi
        # fresh success: jump k (or 1) chars
        if k:
            adv = jnp.where(fresh, k, 1).astype(jnp.int32)
            new_len = jnp.where(fresh, k, s.seed_len + 1).astype(jnp.int32)
        else:
            adv = jnp.ones(Wn, jnp.int32)
            new_len = jnp.where(fresh, 1, s.seed_len + 1).astype(jnp.int32)

        act_now = (fresh | ext) & ~wide_stall
        stepping = act_now & ok
        # CHECK_AND_SET_LAST (ext only; fresh has seed_len < min)
        narrow = (nhi - nlo) < (s.hi - s.lo)
        upd = ext & ~wide_stall & ok & (s.seed_len >= min_len) & narrow
        s3 = s._replace(
            last_lo=jnp.where(upd, s.lo, s.last_lo),
            last_hi=jnp.where(upd, s.hi, s.last_hi),
            last_len=jnp.where(upd, s.seed_len, s.last_len),
            lo=jnp.where(stepping, nlo, s.lo),
            hi=jnp.where(stepping, nhi, s.hi),
            seed_len=jnp.where(stepping, new_len, s.seed_len),
            i=jnp.where(stepping, s.i + adv, s.i),
            active=active,
            pend=new_pend,
        )
        # fresh failure (empty LUT bucket / first char dead): net +1
        fresh_fail = fresh & ~ok
        s3 = s3._replace(i=jnp.where(fresh_fail, s3.i + 1, s3.i))
        # done walkers emit keeping state; ext failures emit + reset
        # (+1 net advance folded into emit) — one buffer pass total
        s4 = emit(s3, done | (ext & ~wide_stall & ~ok), at_end=done)
        return s4._replace(step=s.step + 1)

    def cond(s: S) -> jnp.ndarray:
        return jnp.any(s.active) & (s.step < limit)

    final = jax.lax.while_loop(cond, body, init)
    if finalize:
        # walkers that ran out of the loop with a live seed
        live = final.active & (final.seed_len > 0) & (final.i >= lens)
        final = emit(final, live, at_end=True)
    # compact dtypes before the host pull
    small = jnp.uint8 if L < 256 else jnp.int16
    csmall = jnp.uint8 if params.sa_size_threshold + 1 < 256 else jnp.int16
    seeds = DeviceSeeds(
        offset=(final.out_meta >> 20).astype(small),
        length=((final.out_meta >> 10) & 1023).astype(small),
        sa_lo=final.out_lo,
        sa_count=(final.out_meta & 1023).astype(csmall),
        n_seeds=final.n_seeds.astype(jnp.uint8),
    )
    out_state = SeedWalkState(
        final.i, final.lo, final.hi, final.seed_len, final.last_lo,
        final.last_hi, final.last_len, final.active, final.out_meta,
        final.out_lo, final.n_seeds, final.pend, final.steps, final.sib,
    )
    return seeds, out_state


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "max_seeds", "max_steps", "seg_plan", "two_phase",
        "charge_limit",
    ),
)
def device_mmp_seed_staged(
    dfm: DeviceFM,
    walkers: jnp.ndarray,  # uint8 [W, L]
    lens: jnp.ndarray,  # int32 [W]
    params: MmpParams,
    max_seeds: int,
    max_steps: int,
    seg_plan: Tuple[Tuple[int, int], ...],
    two_phase: bool = False,
    charge_limit: int | None = None,
):
    """Multi-segment walk with ON-DEVICE straggler compaction.

    The lockstep walk's per-step cost is linear in walker count, but
    most walkers retire
    within ~1.3L steps while junk/repeat stragglers grind on to the
    progress-kill bound — so after each ``seg_plan`` segment the
    still-active rows are compacted (stable argsort, active rows
    first) into a statically smaller batch and the walk resumes at a
    fraction of the width. Everything happens inside one jit program:
    no host syncs and no extra dispatches, unlike the host-orchestrated
    segmentation (``AlignEngine.seed_segment_threshold``).

    ``seg_plan`` is a tuple of (steps, cap) pairs: run ``steps`` more
    lockstep steps, then keep only ``cap`` rows. If more than ``cap``
    rows are still active the result is INCOMPLETE: the ``overflow``
    flag (second return) is set and the caller must rerun the plain
    walk — caps are sized ~2.5-4x above the measured straggler
    fractions so this is a loud rare fallback, not a silent drop.

    Returns (DeviceSeeds full width, overflow bool scalar).
    """
    Wn = walkers.shape[0]

    def take_state(st: SeedWalkState, idx):
        return SeedWalkState(*[jnp.take(f, idx, axis=0) for f in st])

    def merge_rows(a_proc, a_unproc_src, order, inv, cap):
        """Full-size result: processed rows (first ``cap`` of
        ``order``) from a_proc, the rest from a_unproc_src — one
        concat + inverse-permutation gather instead of a row
        scatter)."""
        rest = jnp.take(a_unproc_src, order[cap:], axis=0)
        return jnp.take(jnp.concatenate([a_proc, rest], axis=0), inv, axis=0)

    overflow = jnp.zeros((), bool)
    spent = 0
    # level 0: full width. The sibling cull (active only here — later
    # levels are compacted, breaking the row pairing) must fully
    # resolve within this segment: every latch lands by charged step
    # T0, charged rate is >= 1/2 iterations (stalls alternate with
    # completions), so 2*T0 + 8 iterations suffice.
    T0 = getattr(params, "sibling_kill_steps", 0)
    steps0 = seg_plan[0][0]
    if T0 > 0 and steps0 < 2 * T0 + 8:
        raise ValueError(
            f"seg_plan first segment {steps0} cannot resolve the "
            f"sibling cull (needs >= {2 * T0 + 8}); lengthen it or "
            "set sibling_kill_steps=0"
        )
    # the unwrapped impl: staged is itself jitted (or traced inside
    # shard_map, where DeviceFM.primary rides as a tracer and could
    # not hash as the inner jit's static aux)
    _impl = device_mmp_seed.__wrapped__
    seeds_full, st = _impl(
        dfm, walkers, lens, params, max_seeds,
        max_steps=steps0, finalize=False, two_phase=two_phase,
        charge_limit=charge_limit,
    )
    spent += steps0
    # each later level walks a compacted subset; merges apply innermost
    # first, so collect (order, inv, cap, seeds_before) per level
    merges = []
    cur_w, cur_l, cur_seeds = walkers, lens, seeds_full
    for li in range(1, len(seg_plan) + 1):
        cap = seg_plan[li - 1][1]
        steps = (
            seg_plan[li][0] if li < len(seg_plan) else max_steps - spent
        )
        last = li == len(seg_plan)
        n_act = st.active.sum()
        overflow = overflow | (n_act > cap)
        # stable partition (active rows first, original order kept):
        # one key-value sort for the forward permutation; the INVERSE
        # permutation falls out of two cumsums (rank among actives /
        # inactives) — cheaper than a second 80k sort per level
        wn_cur = st.active.shape[0]
        key = jnp.where(st.active, 0, 1).astype(jnp.int32)
        _, order = jax.lax.sort(
            (key, jnp.arange(wn_cur, dtype=jnp.int32)),
            num_keys=1, is_stable=True,
        )
        ract = jnp.cumsum(st.active.astype(jnp.int32)) - 1
        rinact = n_act + jnp.cumsum(1 - st.active.astype(jnp.int32)) - 1
        inv = jnp.where(st.active, ract, rinact).astype(jnp.int32)
        idx = order[:cap]
        sub_w = jnp.take(cur_w, idx, axis=0)
        sub_l = jnp.take(cur_l, idx)
        sub_st = take_state(st, idx)
        sub_seeds, st = _impl(
            dfm, sub_w, sub_l, params, max_seeds,
            max_steps=steps, state=sub_st, finalize=last,
            two_phase=two_phase, charge_limit=charge_limit,
        )
        spent += steps
        merges.append((order, inv, cap, cur_seeds))
        cur_w, cur_l, cur_seeds = sub_w, sub_l, sub_seeds
    # unwind: merge the innermost results outward to full width
    out = cur_seeds
    for order, inv, cap, before in reversed(merges):
        out = DeviceSeeds(
            offset=merge_rows(out.offset, before.offset, order, inv, cap),
            length=merge_rows(out.length, before.length, order, inv, cap),
            sa_lo=merge_rows(out.sa_lo, before.sa_lo, order, inv, cap),
            sa_count=merge_rows(
                out.sa_count, before.sa_count, order, inv, cap
            ),
            n_seeds=merge_rows(out.n_seeds, before.n_seeds, order, inv, cap),
        )
    return out, overflow


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "max_seeds", "max_steps", "seg_plan", "cap",
        "two_phase", "charge_limit",
    ),
)
def device_seed_pipeline(
    dfm: DeviceFM,
    reads: jnp.ndarray,  # uint8 [N, L] forward reads (both ends stacked)
    lens: jnp.ndarray,  # int32 [N]
    params: MmpParams,
    max_seeds: int,
    max_steps: int,
    seg_plan: Tuple[Tuple[int, int], ...],
    cap: int,
    two_phase: bool = False,
    charge_limit: int | None = None,
):
    """ONE dispatch for the whole seeding leg: build [reads; revcomp]
    walkers, run the staged (or plain, seg_plan=()) walk, and compact
    the seed slots for the host pull — one dispatch and one sync
    instead of the build/walk/flatten sequence.

    Returns (n_valid, walker, offset, length, sa_lo, sa_count,
    overflow)."""
    walkers, wlens = build_walkers(reads, lens)
    if seg_plan:
        seeds, overflow = device_mmp_seed_staged(
            dfm, walkers, wlens, params, max_seeds, max_steps, seg_plan,
            two_phase=two_phase, charge_limit=charge_limit,
        )
    else:
        seeds, _ = device_mmp_seed(
            dfm, walkers, wlens, params, max_seeds, max_steps=max_steps,
            two_phase=two_phase, charge_limit=charge_limit,
        )
        overflow = jnp.zeros((), bool)
    # walkers ride along DEVICE-RESIDENT (the caller must NOT pull
    # them): row i = forward read i, row N+i = its revcomp — the
    # deep-DP stage gathers its candidate reads from this matrix
    # (deep_dp_fused_walk) instead of re-uploading host gathers
    return flatten_seeds(seeds, cap) + (overflow, walkers)


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "max_seeds", "max_steps", "seg_plan", "cap", "lcap",
        "two_phase", "charge_limit",
    ),
)
def device_seed_pipeline_loc(
    dfm: DeviceFM,
    reads: jnp.ndarray,  # uint8 [N, L] forward reads (both ends stacked)
    lens: jnp.ndarray,  # int32 [N]
    params: MmpParams,
    max_seeds: int,
    max_steps: int,
    seg_plan: Tuple[Tuple[int, int], ...],
    cap: int,
    lcap: int,
    two_phase: bool = False,
    charge_limit: int | None = None,
):
    """device_seed_pipeline + the SA locate of every decoded position
    in the SAME program: the flat seeds' SA intervals are expanded
    (searchsorted over the count cumsum, static cap ``lcap``) and
    LF-walked to text positions, so the engine's decode stage starts
    from text coordinates without a second dispatch/sync round trip.

    Returns (n_valid, walker, offset, length, sa_lo, sa_count,
    text_pos[lcap], n_rows, walk_overflow, loc_overflow, walkers) —
    ``loc_overflow`` means ``n_rows > lcap`` (positions incomplete;
    the seeds themselves are still usable); ``walkers`` is the
    device-resident [reads; revcomp] matrix (do not pull)."""
    out = device_seed_pipeline(
        dfm, reads, lens, params, max_seeds, max_steps, seg_plan, cap,
        two_phase=two_phase, charge_limit=charge_limit,
    )
    (n_valid, walker, offset, length, sa_lo, sa_count, overflow,
     walkers) = out
    cnt = sa_count.astype(jnp.int32)
    cum = jnp.cumsum(cnt)
    tot = cum[-1]
    loc_overflow = tot > lcap
    r = jnp.arange(lcap, dtype=jnp.int32)
    seed_idx = jnp.searchsorted(cum, r, side="right").astype(jnp.int32)
    seed_idx = jnp.minimum(seed_idx, cap - 1)
    within = r - (jnp.take(cum, seed_idx) - jnp.take(cnt, seed_idx))
    rows = jnp.take(sa_lo, seed_idx) + within
    valid = r < tot
    rows = jnp.where(valid, rows, 0)
    pos = device_locate(dfm, rows, dfm.sa_interval)
    return (
        n_valid, walker, offset, length, sa_lo, sa_count, pos, tot,
        overflow, loc_overflow, walkers,
    )


@functools.partial(jax.jit, static_argnames=("sa_interval",))
def device_locate(dfm: DeviceFM, rowsv: jnp.ndarray, sa_interval: int) -> jnp.ndarray:
    """Batched LF-walk locate of full rows (int32)."""
    rowsv = rowsv.astype(jnp.int32)

    def lf(r):
        # ONE fused-row fetch serves BOTH the BWT char and its rank:
        # the row's packed words cover adj, so the separate bwt_words
        # gather the old two-fetch lf paid per step disappears (the
        # LF walk is gather-latency-bound like the seeding walk)
        adj = r - (r > dfm.primary).astype(jnp.int32)
        off = jnp.int32(4**dfm.lut_k if dfm.lut_k else 0)
        block = adj // dfm.blk
        rows = jnp.take(dfm.fused_rows, block + off, axis=0)
        rel = adj - block * dfm.blk
        nw = rows.shape[1] - 4
        cols = jnp.arange(nw, dtype=jnp.int32)[None, :]
        w = jnp.sum(
            jnp.where(
                cols == (rel // WORD_CHARS)[:, None],
                rows[:, 4:], jnp.uint32(0),
            ),
            axis=1,
        )
        c = (
            (w >> (2 * (rel % WORD_CHARS)).astype(jnp.uint32))
            & jnp.uint32(3)
        ).astype(jnp.int32)
        out = _counts_of(dfm, c) + _occ_from_rows(rows, rel, c)
        return jnp.where(r == dfm.primary, 0, out)

    pos = jnp.full(rowsv.shape, -1, jnp.int32)
    cur = rowsv
    steps = jnp.zeros(rowsv.shape, jnp.int32)
    for _ in range(sa_interval + 1):
        marked, rank = _mark_lookup(dfm, cur)
        hit = (pos < 0) & marked
        pos = jnp.where(hit, dfm.sa_sampled[rank] + steps, pos)
        todo = pos < 0
        cur = jnp.where(todo, lf(cur), cur)
        steps = steps + todo.astype(jnp.int32)
    return pos


@functools.partial(jax.jit, static_argnames=("cap",))
def flatten_seeds(seeds: DeviceSeeds, cap: int):
    """Compact the (W, S) seed slots into flat arrays on device.

    The host pull shrinks from W*S slots (mostly empty) to ``cap``
    rows; row-major nonzero order matches the host-side flatten.
    Returns (n_valid, walker, offset, length, sa_lo, sa_count) —
    callers must fall back to the 2-D pull when n_valid > cap.
    """
    Wn, S = seeds.offset.shape
    cols = jnp.arange(S, dtype=jnp.int32)[None, :]
    mask = cols < seeds.n_seeds[:, None].astype(jnp.int32)
    n_valid = mask.sum()
    ws, js = jnp.nonzero(mask, size=cap, fill_value=0)
    idx = ws.astype(jnp.int32) * S + js.astype(jnp.int32)
    valid = jnp.arange(cap) < n_valid

    def take(a, dt):
        v = jnp.take(a.reshape(-1), idx)
        return jnp.where(valid, v, 0).astype(dt)

    # compact dtypes shrink the device-to-host pull (offsets/lengths
    # < 1024, counts < 1023)
    return (
        n_valid,
        jnp.where(valid, ws.astype(jnp.int32), 0),
        take(seeds.offset.astype(jnp.int32), jnp.uint16),
        take(seeds.length.astype(jnp.int32), jnp.uint16),
        take(seeds.sa_lo, jnp.int32),
        take(seeds.sa_count.astype(jnp.int32), jnp.uint16),
    )
