"""The batch alignment engine: seed -> pair -> DP -> hits.

Replaces soap4's per-batch stage sequence (soap3_dp_pair_align,
/root/reference/soap4/alignment.cpp:29-355): deep-DP on paired
candidates, single-end DP for leftover reads, insert-window mate
rescue, and unpaired output. All stages operate on flat numpy/JAX
arrays; the DP runs as one batched device call per window-width class.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from megapath.align.pairing import Candidates, pair_candidates
from megapath.align.params import AlignParams
from megapath.align.seeding import (
    SeedPositions,
    decode_seeds,
    make_walkers_fast,
    mmp_seed,
)
from megapath.index.fm import FMIndex
from megapath.index.pack import COMPLEMENT, PackedReference
from megapath.ops.dp import DPParams, sw_align

# sentinel: the staged seeding walk's compaction caps overflowed and
# the caller must rerun the plain full-width walk
OVERFLOW = object()

OFF_TEXT_CODE = 4  # never equals a read code -> forced mismatch


@dataclass
class BatchHits:
    """Flat per-alignment hit table for one read-pair batch."""

    read: np.ndarray  # int32 pair index
    end: np.ndarray  # int8 0 = first mate, 1 = second
    seq: np.ndarray  # int32 reference sequence index
    score: np.ndarray  # int32 normalized score (paired => sum of ends)
    raw_score: np.ndarray  # int32 own-end DP score
    start: np.ndarray  # int64 text start (global coords)
    stop: np.ndarray  # int64 text end (exclusive)
    strand: np.ndarray  # int8 0=+, 1=-
    paired: np.ndarray  # bool properly paired on same sequence

    @classmethod
    def empty(cls) -> "BatchHits":
        z = np.zeros(0)
        i32, i8, i64 = z.astype(np.int32), z.astype(np.int8), z.astype(np.int64)
        return cls(i32, i8, i32.copy(), i32.copy(), i32.copy(), i64, i64.copy(), i8.copy(), z.astype(bool))

    @classmethod
    def concat(cls, parts: List["BatchHits"]) -> "BatchHits":
        parts = [p for p in parts if len(p.read)]
        if not parts:
            return cls.empty()
        return cls(*[np.concatenate([getattr(p, f) for p in parts]) for f in
                     ("read", "end", "seq", "score", "raw_score", "start",
                      "stop", "strand", "paired")])

    def __len__(self) -> int:
        return len(self.read)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _concat_sp(parts: List[SeedPositions]) -> SeedPositions:
    parts = [p for p in parts if len(p.read)]
    if not parts:
        z = np.zeros(0)
        return SeedPositions(
            z.astype(np.int32), z.astype(np.int8), z.astype(np.int64),
            z.astype(np.int32),
        )
    if len(parts) == 1:
        return parts[0]
    return SeedPositions(
        *[np.concatenate([getattr(p, f) for p in parts])
          for f in ("read", "strand", "pos", "coverage")]
    )


def extract_windows(
    codes: np.ndarray, starts: np.ndarray, width: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather ref windows [start, start+width) with off-text cells
    marked OFF_TEXT_CODE. Returns (windows, clipped_starts, lens)."""
    n = len(codes)
    starts = np.asarray(starts, dtype=np.int64)
    idx = starts[:, None] + np.arange(width)
    valid = (idx >= 0) & (idx < n)
    win = np.full((len(starts), width), OFF_TEXT_CODE, dtype=np.uint8)
    win[valid] = codes[idx[valid]]
    return win, starts, np.full(len(starts), width, dtype=np.int32)


def _revcomp_rows(reads: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-row reverse complement within each row's valid length."""
    n, L = reads.shape
    j = np.arange(L)[None, :]
    src = np.asarray(lens, np.int64)[:, None] - 1 - j
    ok = src >= 0
    src = np.clip(src, 0, L - 1)
    rc = COMPLEMENT[np.take_along_axis(reads, src, axis=1)]
    return np.where(ok, rc, 0).astype(np.uint8)


def dp_window_width(read_len: int) -> int:
    """Reference-window width of the deep-DP and single-end DP calls for
    reads up to ``read_len``: the read, a 30-base margin on each side
    and 2 spare cells, rounded up to 64 so few widths compile."""
    return _round_up(read_len + 2 * 30 + 2, 64)


def _bucket(n: int) -> int:
    """Round batch sizes up to jit-cache-friendly buckets.

    Small batches go to powers of two (few compile-cache entries);
    large ones pad at 4096 grain — the DP cost is linear in rows, so
    a 2^k bucket would waste up to 2x device time, while the 4096
    grain still bounds the number of compiled programs."""
    if n <= 256:
        return 256
    if n <= 4096:
        b = 256
        while b < n:
            b *= 2
        return b
    return _round_up(n, 4096)


def _batched_dp(
    reads: np.ndarray,
    read_lens: np.ndarray,
    windows: np.ndarray,
    win_lens: np.ndarray,
    params: AlignParams,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One device DP call; returns numpy (score, end_ref, end_read).

    Batches are zero-padded to power-of-two buckets so XLA compiles a
    handful of shapes once per process instead of one per batch.
    """
    n = reads.shape[0]
    nb = _bucket(n)
    if nb != n:
        reads = np.concatenate(
            [reads, np.zeros((nb - n, reads.shape[1]), dtype=reads.dtype)]
        )
        windows = np.concatenate(
            [windows, np.zeros((nb - n, windows.shape[1]), dtype=windows.dtype)]
        )
        read_lens = np.concatenate([read_lens, np.zeros(nb - n, read_lens.dtype)])
        win_lens = np.concatenate([win_lens, np.zeros(nb - n, win_lens.dtype)])
    dp = DPParams(params.match, params.mismatch, params.gap_open, params.gap_extend)
    res = sw_align(reads, windows, read_lens.astype(np.int32),
                   win_lens.astype(np.int32), params=dp)
    import jax

    score, e_ref, e_read = jax.device_get((res.score, res.end_ref, res.end_read))
    return (score[:n], e_ref[:n], e_read[:n])


def _exact_starts(
    reads: np.ndarray,
    windows: np.ndarray,
    end_ref: np.ndarray,
    end_read: np.ndarray,
    scores: np.ndarray,
    params: AlignParams,
) -> Tuple[np.ndarray, np.ndarray]:
    """Start cells via a second DP on reversed prefixes.

    Aligning reversed read[:end_read] vs reversed window[:end_ref]
    reproduces the same optimal score; its end cell is the distance
    from the forward end back to the start.
    """
    B, R = reads.shape
    W = windows.shape[1]
    j = np.arange(R)[None, :]
    src = np.asarray(end_read, np.int64)[:, None] - 1 - j
    rev_reads = np.where(src >= 0, np.take_along_axis(reads, np.clip(src, 0, R - 1), 1), 0).astype(np.uint8)
    i = np.arange(W)[None, :]
    wsrc = np.asarray(end_ref, np.int64)[:, None] - 1 - i
    rev_wins = np.where(
        wsrc >= 0,
        np.take_along_axis(windows, np.clip(wsrc, 0, W - 1), 1),
        OFF_TEXT_CODE,
    ).astype(np.uint8)
    s2, er2, ej2 = _batched_dp(
        rev_reads, end_read.astype(np.int32), rev_wins, end_ref.astype(np.int32), params
    )
    start_ref = end_ref - er2
    start_read = end_read - ej2
    return start_ref, start_read


class AlignEngine:
    """One NT-shard aligner instance.

    ``device_seeding=True`` runs the MMP walk + SA locate on device
    (seeding_jax), falling back to the numpy state machine otherwise.
    """

    def __init__(
        self,
        ref: PackedReference,
        fm: FMIndex,
        params: AlignParams,
        device_seeding: bool = False,
        device=None,
        lazy_device: bool = False,
    ):
        self.ref = ref
        self.fm = fm
        self.params = params
        self.dfm = None
        self.device = device
        self._ref_dev = None
        self._walk_two_phase = False  # set by commit() from table size
        self._device_seeding = device_seeding
        self.seed_segment_threshold: Optional[int] = None  # see _device_seeds
        # on-device straggler compaction for the seeding walk (see
        # device_mmp_seed_staged); purely device-side, no host sync.
        # Applied when the walker count reaches seed_compact_min (below
        # that the extra argsort/gather levels cost more than they
        # save).
        self.seed_compact: bool = True
        self.seed_compact_min: int = 16384
        # reference-exact rescue (round 5, see _exact_rescue): pairs
        # ending with a zero-hit end re-run through the undialed walk,
        # making the dialed results byte-exact vs the reference at
        # ~dialed speed on matching-heavy workloads; junk-heavy
        # streams flip to the direct exact walk.
        self.exact_rescue: bool = True
        self._exact_direct = False
        # adaptive compaction plan (round 5): after the sibling cull,
        # matching-heavy batches (most reads seed — the final cascade
        # shard, the bench) go junk-free by ~1.3L iterations, so their
        # NEXT batch uses the aggressive schedule; junk-heavy batches
        # (typical mid-cascade NT shard: reads mostly don't match this
        # shard, the cull has no sibling evidence to fire on) stay on
        # the robust schedule. Promotion is measured per batch from
        # the seeded-walker fraction; any staged overflow demotes.
        self._plan_fast = False
        # (id, walkers_dev, lens_dev, N, Nb): the seeding walk's
        # device state, reused by deep-DP's on-device candidate gather
        self._batch_dev = None
        self._ref_words_dev = None  # packed shard text (lazy)
        # pipelined-batch chunk size (pairs): batches >= 2 chunks run
        # seed-walk(i+1) before decode(i) so host work hides behind the
        # device, at the price of one dispatch and pull per chunk.
        # Off (0) by default; whether it pays on the card is to be
        # measured on the card (ROADMAP A5).
        self.chunk_pairs: int = 0
        # lazy_device keeps the shard's tables in host RAM until
        # commit(): with more shards than devices the pipeline rotates
        # shards through HBM between waves instead of double-booking it
        # (the 250 GB NT build is ~125 shards at the 2 Gbp cap,
        # /root/reference/README.md:13, splitFasta.pl:19)
        if not lazy_device:
            self.commit()

    def commit(self) -> None:
        """Stage this shard's device tables into its device's HBM."""
        if self._device_seeding and self.dfm is None:
            from megapath.align.seeding_jax import DeviceFM

            self.dfm = DeviceFM.from_host(self.fm, device=self.device)
            # walk mode follows the layout from_host picked by table
            # size: paired 64-char rows (HBM-resident shards) enable
            # the single-gather two-phase walk; classic 128-char rows
            # (cache-resident shards) run the stall-free two-gather
            # walk. Seeds are identical either way (mode-invariant
            # step charging).
            self._walk_two_phase = self.dfm.blk < 128  # paired layout
        if self.device is not None and self._ref_dev is None:
            # commit the shard text now so every jit call on this
            # engine executes on its mesh device (uncommitted numpy
            # inputs follow the committed arguments)
            import jax

            self._ref_dev = jax.device_put(self.ref.codes, self.device)

    def evict(self) -> None:
        """Drop the shard's device tables (host copies stay); the next
        commit() re-stages them."""
        self.dfm = None
        self._ref_dev = None
        self._batch_dev = None
        self._ref_words_dev = None

    @property
    def committed(self) -> bool:
        return self.dfm is not None or self._ref_dev is not None

    # ------------------------------------------------------------------
    def seed_positions(
        self, reads: np.ndarray, lens: np.ndarray, mmp=None
    ) -> SeedPositions:
        """``mmp`` overrides the seeding parameters for one call (deep-DP
        rounds past the first re-seed with their own MmpParams,
        alignment.cpp:91-137 / IniParam.cpp seedingProperties)."""
        mmp = mmp or self.params.mmp
        if self.dfm is not None:
            seeds, pre_pos = self._device_seeds_pos(reads, lens, mmp)
            locate = self._device_locate
        else:
            walkers, wlens = make_walkers_fast(reads, lens)
            seeds = mmp_seed(walkers, wlens, self.fm, mmp)
            locate, pre_pos = None, None
        return decode_seeds(
            seeds, self.fm, lens, len(reads), mmp, locate_fn=locate,
            pre_pos=pre_pos,
        )

    def _device_seeds(self, reads: np.ndarray, lens: np.ndarray, mmp=None):
        seeds, _ = self._device_seeds_pos(reads, lens, mmp)
        return seeds

    def _device_seeds_pos(
        self, reads: np.ndarray, lens: np.ndarray, mmp=None
    ):
        """Device MMP over [reads; revcomp] (walkers built on device).

        Runs in two segments with straggler compaction: most walkers
        retire within ~1.3L steps, but revcomp/junk walkers grind to
        the 3L+64 limit — after segment 1 the still-active rows gather
        into a smaller batch that runs the remainder, cutting the
        lockstep loop's per-step cost roughly in half.
        """
        import jax.numpy as jnp

        from megapath.align.seeding import Seeds
        from megapath.align.seeding_jax import (
            build_walkers,
            compact_walk,
            device_mmp_seed,
        )

        N, L = reads.shape
        orig_reads_id = id(reads)  # pre-padding identity (deep-DP key)
        # finer padding than the DP buckets: the seeding loop's cost is
        # proportional to walker count, so a 4096-grain pad beats the
        # power-of-two bucket (40k -> 41k instead of 65k rows); small
        # batches (the exact-rescue subsets are typically tens of
        # pairs) get a 512 bucket so the rescue walk doesn't pay a
        # 4096-end minimum — two grains only, bounded compile cache
        Nb = 512 if N <= 512 else max(_round_up(N, 4096), 4096)
        if Nb != N:
            reads = np.concatenate(
                [reads, np.zeros((Nb - N, reads.shape[1]), reads.dtype)]
            )
            lens = np.concatenate([lens, np.zeros(Nb - N, lens.dtype)])
        # each emitted seed advances the cursor >= seed_min_length - 1
        # chars, so L/16+2 slots bound the per-walker seed count
        max_seeds = int(min(16, max(4, L // 16 + 2)))
        mmp = mmp or self.params.mmp
        # 3L+64 is the CHARGED walk bound (mode-invariant); two-phase
        # walks need up to ~2x iterations to deliver the same charged
        # steps (stalls charge nothing — an iteration-capped two-phase
        # walk truncated rollback-heavy walkers, audit-measured at
        # 2/40000 read ends), plus sibling-cull pause slack
        charge_limit = 3 * L + 64
        limit = (
            2 * charge_limit + 128 if self._walk_two_phase else charge_limit
        )
        # Straggler segmentation (compact still-active walkers after
        # ~1.4L steps and resume on the smaller batch) is implemented
        # and tested, but off by default: it trades saved loop steps
        # for extra dispatches and host syncs, to be measured on the
        # card (ROADMAP A5).
        segmented = (
            self.seed_segment_threshold is not None
            and Nb > self.seed_segment_threshold
        )
        seg1 = min(int(1.4 * L), limit) if segmented else limit

        # commit inputs to the engine's device (if pinned): jit outputs
        # are committed, so walkers built on the default device would
        # clash with the dfm committed elsewhere
        import jax as _jax

        if self.device is not None:
            reads_d = _jax.device_put(reads, self.device)
            lens_d = _jax.device_put(lens.astype(np.int32), self.device)
        else:
            reads_d = jnp.asarray(reads)
            lens_d = jnp.asarray(lens.astype(np.int32))
        import jax

        if not segmented:
            # ONE fused dispatch for the whole leg (build walkers +
            # staged walk + flatten) and one device_get.
            # The staged walk (on-device straggler compaction) cuts
            # the lockstep width to 1/2 then 1/6 once most walkers
            # retire; its overflow flag (caps >=2x above measured
            # straggler fractions) falls back to the plain walk.
            from megapath.align.seeding_jax import (
                device_seed_pipeline_loc,
            )

            staged = (
                self.seed_compact and 2 * Nb >= self.seed_compact_min
            )
            plan = (
                self._seed_seg_plan(2 * Nb, L, fast=self._plan_fast,
                                    two_phase=self._walk_two_phase)
                if staged else ()
            )
            cap = 2 * Nb  # measured ~1.4 seeds per read end on bench
            lcap = 4 * Nb  # SA positions per batch (~2.8x seeds)
            fl = device_seed_pipeline_loc(
                self.dfm, reads_d, lens_d, mmp, max_seeds, limit,
                plan, cap, lcap, two_phase=self._walk_two_phase,
                charge_limit=charge_limit,
            )
            # stash the walk's device state for the deep-DP stage: its
            # candidate reads gather straight from the [reads; revcomp]
            # walker matrix (keyed by the ORIGINAL array identity —
            # later seeding rounds stash their subsets under their own
            # ids and deep-DP just misses the cache). walkers stay
            # device-resident; only fl[:-1] is pulled.
            self._batch_dev = (orig_reads_id, fl[-1], lens_d, N, Nb)
            res = self._seed_pipeline_finish(fl[:-1], cap, N, Nb)
            if res is OVERFLOW and staged:
                # staged caps exceeded (loud rare fallback): rerun the
                # plain full-width walk through the same pipeline and
                # demote to the robust plan for subsequent batches
                self._plan_fast = False
                fl = device_seed_pipeline_loc(
                    self.dfm, reads_d, lens_d, mmp, max_seeds, limit,
                    (), cap, lcap, two_phase=self._walk_two_phase,
                    charge_limit=charge_limit,
                )
                self._batch_dev = (orig_reads_id, fl[-1], lens_d, N, Nb)
                res = self._seed_pipeline_finish(fl[:-1], cap, N, Nb)
            if res is not None and res is not OVERFLOW:
                self._update_plan_mode(res[0], N)
                return res
            # flatten cap overflow (seeds complete, > cap rows): raw
            # 2-D pull of the full slot buffers
            out, st = device_mmp_seed(
                self.dfm, *build_walkers(reads_d, lens_d), mmp,
                max_seeds=max_seeds, max_steps=limit, finalize=True,
                two_phase=self._walk_two_phase, charge_limit=charge_limit,
            )
        else:
            walkers, wlens = build_walkers(reads_d, lens_d)
            out, st = device_mmp_seed(
                self.dfm, walkers, wlens, mmp, max_seeds=max_seeds,
                max_steps=seg1, finalize=False,
            )

        # one batched device_get instead of five sequential pulls:
        # each pull is a host sync
        n_seeds, off, lng, slo, scnt = jax.device_get(
            (out.n_seeds, out.offset, out.length, out.sa_lo, out.sa_count)
        )
        n_seeds = n_seeds.astype(np.int32)
        off = off.astype(np.int32)
        lng = lng.astype(np.int32)
        slo = np.array(slo)  # writable: segment 2 scatters back
        scnt = scnt.astype(np.int32)

        n_act = int(np.asarray(st.active).sum()) if segmented else 0
        if n_act:
            act = np.asarray(st.active)
            idx = np.flatnonzero(act).astype(np.int32)
            Nc = max(_round_up(n_act, 2048), 2048)
            idx_p = np.concatenate([idx, np.zeros(Nc - n_act, np.int32)])
            cw, cl, cst = compact_walk(
                walkers, wlens, st, jnp.asarray(idx_p), jnp.int32(n_act)
            )
            out2, _ = device_mmp_seed(
                self.dfm, cw, cl, mmp, max_seeds=max_seeds,
                max_steps=limit - seg1, state=cst, finalize=True,
            )
            # segment-2 buffers carry segment-1 seeds for those rows:
            # replace wholesale
            n_seeds[idx] = np.asarray(out2.n_seeds).astype(np.int32)[:n_act]
            off[idx] = np.asarray(out2.offset).astype(np.int32)[:n_act]
            lng[idx] = np.asarray(out2.length).astype(np.int32)[:n_act]
            slo[idx] = np.asarray(out2.sa_lo)[:n_act]
            scnt[idx] = np.asarray(out2.sa_count).astype(np.int32)[:n_act]
        sel = np.r_[np.arange(N), Nb + np.arange(N)]
        n_seeds, off, lng, slo, scnt = (
            n_seeds[sel], off[sel], lng[sel], slo[sel], scnt[sel]
        )
        cols = np.arange(off.shape[1])[None, :]
        mask = cols < n_seeds[:, None]
        ws, js = np.nonzero(mask)
        seeds = Seeds(
            walker=ws.astype(np.int32),
            offset=off[ws, js],
            length=lng[ws, js],
            sa_lo=slo[ws, js].astype(np.int64),
            sa_count=scnt[ws, js],
        )
        self._update_plan_mode(seeds, N)
        return seeds, None

    def _update_plan_mode(self, seeds, n_ends: int) -> None:
        """Adaptive plan promotion: the fraction of walkers that
        stored any seed separates matching-heavy batches (~0.5: every
        end's true-strand walker seeds) from junk-heavy ones (~0.05).
        The NEXT batch of a matching-heavy stream takes the fast
        schedule (_seed_seg_plan fast=True); overflow demotes."""
        if not n_ends:
            return
        frac = len(np.unique(seeds.walker)) / float(2 * n_ends)
        self._plan_fast = frac >= 0.35

    def _device_align(
        self,
        reads: np.ndarray,
        lens: np.ndarray,
        win_starts: np.ndarray,
        width: int,
        win_lens: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fused gather + forward DP + reverse (start-finding) DP on
        device; returns numpy (score, start_ref, end_ref).

        ``win_lens`` bounds each row's usable window (soap4 clips the
        candidate's DNA window length, DV-DPfunctions.cpp:2876-2881,
        2954-2959); defaults to the full ``width``.
        """
        from megapath.align.device import align_with_starts
        from megapath.ops.dp import DPParams

        if self._ref_dev is None:
            import jax.numpy as jnp

            self._ref_dev = jnp.asarray(self.ref.codes)
        n = reads.shape[0]
        if win_lens is None:
            win_lens = np.full(n, width, dtype=np.int32)
        nb = _bucket(n)
        if nb != n:
            reads = np.concatenate(
                [reads, np.zeros((nb - n, reads.shape[1]), reads.dtype)]
            )
            lens = np.concatenate([lens, np.zeros(nb - n, lens.dtype)])
            win_starts = np.concatenate(
                [win_starts, np.zeros(nb - n, win_starts.dtype)]
            )
            win_lens = np.concatenate(
                [win_lens, np.zeros(nb - n, win_lens.dtype)]
            )
        p = self.params
        dp = DPParams(p.match, p.mismatch, p.gap_open, p.gap_extend)
        out = align_with_starts(
            self._ref_dev,
            reads,
            lens.astype(np.int32),
            win_starts.astype(np.int32),
            width,
            params=dp,
            win_lens=np.clip(win_lens, 0, width).astype(np.int32),
        )
        import jax

        score, st_ref, e_ref = jax.device_get(
            (out.score, out.start_ref, out.end_ref)
        )
        return (
            score[:n].astype(np.int64),
            st_ref[:n].astype(np.int64),
            e_ref[:n].astype(np.int64),
        )

    @staticmethod
    def _seed_seg_plan(
        Wn: int, L: int, fast: bool = False, two_phase: bool = True
    ):
        """Static compaction schedule for ``device_mmp_seed_staged``:
        (steps, cap) per level.

        ROBUST (default; holds for junk-heavy production batches):
        measured active-walker curve on the 512 Mbp shard
        (tools/active_curve.py, L=100, two-phase walk, pre-cull):
        1.1L -> 82%, 1.7L -> 69%, 2.0L -> 23%, 2.3L -> 18%,
        2.8L -> 14%, 3.4L -> 2.6% — a cliff at the progress-kill bound
        (~2.0L) and then a FLAT junk tail whose uncharged wide-phase
        stalls stretch loop life ~1.8x past the charged curve. Cut 1
        at 2.0L to 1/2 (margin 2.2x over the measured 23%); cut 2 at
        +0.5L to 1/4 — NOT the old 1/6, whose 1.1x margin over the
        measured tail would make junkier-than-bench production batches
        overflow into the silent full-width rerun.

        FAST (matching-heavy batches, promoted by _update_plan_mode):
        the sibling cull retires wrong-strand walkers of clean-sibling
        pairs by ~2*T0 iterations. Measured cull-on curve (r5, same
        shard/method): 0.8L -> 73.5%, 1.1L -> 55%, 1.4L -> 54%,
        1.7L -> 49%, 2.0L -> 23%, 2.8L -> 14%, 3.4L -> 2.8% — the
        1.1-1.7L plateau is productive walkers re-extending through
        mid-read errors (the cull cannot and must not touch them), so
        the early cut is bounded at ~0.72. Cuts: 1.1L -> 0.72 (1.3x
        margin over 55%), 2.0L -> 0.30, 2.5L -> 0.20. The first
        segment also covers the cull's resolution bound
        (>= 2*sibling_kill_steps + 8)."""

        def r512(x):
            return max(512, ((x + 511) // 512) * 512)

        if fast and not two_phase:
            # CLASSIC-mode fast plan: without wide-phase stall
            # iterations the cull-on curve collapses earlier
            # (measured, toy shard r5: 1.1L 50%, 1.4L 47%, 1.7L 24%,
            # 2.0L 9.5%, 2.8L 0.9%) — cuts carry a ~1.3x margin
            return (
                (max(int(1.1 * L), 2 * 48 + 8), r512(int(0.65 * Wn))),
                (max(32, int(0.6 * L)), r512(int(0.32 * Wn))),
                (max(32, int(0.3 * L)), r512(int(0.13 * Wn))),
                (max(32, int(0.4 * L)), r512(int(0.08 * Wn))),
            )
        if fast:
            # TWO-PHASE: the 1.1-1.7L plateau (~50-55% active:
            # productive walkers re-extending through errors, their
            # iterations stall-stretched) bounds the mid cuts
            return (
                (max(int(1.1 * L), 2 * 48 + 8), r512(int(0.72 * Wn))),
                (max(32, int(0.6 * L)), r512(int(0.61 * Wn))),
                (max(32, int(0.3 * L)), r512(int(0.30 * Wn))),
                (max(32, int(0.5 * L)), r512(Wn // 5)),
            )
        return (
            (int(2.0 * L), r512(Wn // 2)),
            (max(32, L // 2), r512(Wn // 4)),
        )

    @staticmethod
    def _seed_pipeline_finish(fl, cap: int, N: int, Nb: int):
        """Pull + decode the fused seed-pipeline(+locate) output.
        OVERFLOW when the staged walk's compaction caps were exceeded
        (seeds incomplete — caller reruns the plain walk); None when
        the flatten cap overflowed (seeds complete — caller falls back
        to the raw 2-D pull). Otherwise (Seeds, pre_pos) where
        ``pre_pos`` holds the located text position per expanded SA
        row (row order matches decode_seeds' expansion), or None when
        the locate cap overflowed."""
        import jax

        from megapath.align.seeding import Seeds

        pulled = jax.device_get(fl)
        (n_valid, ws_f, off_f, lng_f, slo_f, scnt_f, pos, tot,
         walk_oflow, loc_oflow) = pulled
        if bool(walk_oflow):
            return OVERFLOW
        n_valid = int(n_valid)
        if n_valid > cap:
            return None
        ws_f, off_f, lng_f, slo_f, scnt_f = (
            a[:n_valid] for a in (ws_f, off_f, lng_f, slo_f, scnt_f)
        )
        pre_pos = None
        if not bool(loc_oflow):
            # positions are per expanded SA row of the FLAT order;
            # dropping pad-walker seeds must drop their rows too
            cnt = scnt_f.astype(np.int64)
            keep = (ws_f < N) | ((ws_f >= Nb) & (ws_f < Nb + N))
            row_keep = np.repeat(keep, cnt)
            pre_pos = pos[: int(tot)][row_keep].astype(np.int64)
        keep = (ws_f < N) | ((ws_f >= Nb) & (ws_f < Nb + N))
        ws_f, off_f, lng_f, slo_f, scnt_f = (
            a[keep] for a in (ws_f, off_f, lng_f, slo_f, scnt_f)
        )
        ws_f = np.where(ws_f >= Nb, ws_f - (Nb - N), ws_f)
        seeds = Seeds(
            walker=ws_f.astype(np.int32),
            offset=off_f.astype(np.int32),
            length=lng_f.astype(np.int32),
            sa_lo=slo_f.astype(np.int64),
            sa_count=scnt_f.astype(np.int32),
        )
        return seeds, pre_pos

    @staticmethod
    def _seed_compact_dispatch(out, N: int, Nb: int, oflow=None):
        """Dispatch the on-device seed compaction (async): the (W, S)
        slot buffers shrink to one row per valid seed before the pull,
        so the device-to-host copy carries only real seeds.
        Returns a handle for ``_seed_compact_finish``."""
        from megapath.align.seeding_jax import flatten_seeds

        # measured ~1.4 stored seeds per read end on the bench batch —
        # cap 2*Nb keeps the pull ~8x smaller than the full slot
        # buffers with margin; overflow falls back to the full pull
        # (handled by the caller on None)
        cap = 2 * Nb
        return (flatten_seeds(out, cap), cap, N, Nb, oflow)

    @staticmethod
    def _seed_compact_finish(handle):
        """Pull + decode the compacted seeds; OVERFLOW when the staged
        walk's compaction caps were exceeded (caller must rerun the
        plain walk), None on flatten-cap overflow (caller falls back
        to the raw 2-D pull of the same, complete, seed buffers)."""
        import jax

        from megapath.align.seeding import Seeds

        fl_dev, cap, N, Nb, oflow = handle
        if oflow is not None:
            fl, oflow_v = jax.device_get((fl_dev, oflow))
            if bool(oflow_v):
                return OVERFLOW
        else:
            fl = jax.device_get(fl_dev)
        n_valid = int(fl[0])
        if n_valid > cap:
            return None
        ws_f, off_f, lng_f, slo_f, scnt_f = (a[:n_valid] for a in fl[1:])
        # drop rows belonging to the row padding, keep N-order
        keep = (ws_f < N) | ((ws_f >= Nb) & (ws_f < Nb + N))
        ws_f, off_f, lng_f, slo_f, scnt_f = (
            a[keep] for a in (ws_f, off_f, lng_f, slo_f, scnt_f)
        )
        ws_f = np.where(ws_f >= Nb, ws_f - (Nb - N), ws_f)
        return Seeds(
            walker=ws_f.astype(np.int32),
            offset=off_f.astype(np.int32),
            length=lng_f.astype(np.int32),
            sa_lo=slo_f.astype(np.int64),
            sa_count=scnt_f.astype(np.int32),
        )

    def _seed_walk_dispatch(self, reads: np.ndarray, lens: np.ndarray, mmp):
        """Async phase of ``_device_seeds`` for the pipelined batch
        path: pads, builds walkers, dispatches the walk + compaction,
        returns the finish handle (no host sync). Non-segmented only.
        """
        import jax as _jax
        import jax.numpy as jnp

        from megapath.align.seeding_jax import (
            build_walkers,
            device_mmp_seed,
        )

        N, L = reads.shape
        Nb = max(_round_up(N, 4096), 4096)
        if Nb != N:
            reads = np.concatenate(
                [reads, np.zeros((Nb - N, reads.shape[1]), reads.dtype)]
            )
            lens = np.concatenate([lens, np.zeros(Nb - N, lens.dtype)])
        max_seeds = int(min(16, max(4, L // 16 + 2)))
        if self.device is not None:
            reads_d = _jax.device_put(reads, self.device)
            lens_d = _jax.device_put(lens.astype(np.int32), self.device)
        else:
            reads_d = jnp.asarray(reads)
            lens_d = jnp.asarray(lens.astype(np.int32))
        walkers, wlens = build_walkers(reads_d, lens_d)
        chg = 3 * L + 64
        out, _ = device_mmp_seed(
            self.dfm, walkers, wlens, mmp, max_seeds=max_seeds,
            max_steps=(
                2 * chg + 128 if self._walk_two_phase else chg
            ),
            charge_limit=chg, finalize=True,
            two_phase=self._walk_two_phase,
        )
        return self._seed_compact_dispatch(out, N, Nb)

    def _deep_dp_fused_call(
        self, l_reads, l_lens, l_starts, l_wl,
        r_reads, r_lens, r_starts, r_full_wl, width,
    ):
        """Bucket-pad + run deep_dp_fused + one batched pull."""
        from megapath.align.device import deep_dp_fused
        from megapath.ops.dp import DPParams

        import jax

        if self._ref_dev is None:
            import jax.numpy as jnp

            self._ref_dev = jnp.asarray(self.ref.codes)
        n = l_reads.shape[0]
        nb = _bucket(n)

        def pad2(a):
            if nb == n:
                return a
            return np.concatenate(
                [a, np.zeros((nb - n, a.shape[1]), a.dtype)]
            )

        def pad1(a, dt=np.int32):
            a = a.astype(dt)
            if nb == n:
                return a
            return np.concatenate([a, np.zeros(nb - n, dt)])

        p = self.params
        dp = DPParams(p.match, p.mismatch, p.gap_open, p.gap_extend)
        left, right = deep_dp_fused(
            self._ref_dev,
            pad2(l_reads), pad1(l_lens), pad1(l_starts),
            np.clip(pad1(l_wl), 0, width),
            pad2(r_reads), pad1(r_lens), pad1(r_starts),
            np.clip(pad1(r_full_wl), 0, width),
            width, int(p.insert_high), params=dp,
        )
        s1, st_l, e_l, s2, st_r, e_r = jax.device_get(
            (left.score, left.start_ref, left.end_ref,
             right.score, right.start_ref, right.end_ref)
        )
        return (
            s1[:n].astype(np.int64), st_l[:n].astype(np.int64),
            e_l[:n].astype(np.int64), s2[:n].astype(np.int64),
            st_r[:n].astype(np.int64), e_r[:n].astype(np.int64),
        )

    def _deep_dp_walk_call(
        self, walkers_dev, lens_dev, Nb, l_idx, l_starts, l_wl,
        r_idx, r_starts, r_full_wl, width,
    ):
        """Bucket-pad the int32 index/start arrays + run
        deep_dp_fused_walk + one batched pull."""
        from megapath.align.device import deep_dp_fused_walk

        import jax

        if self._ref_words_dev is None:
            import jax.numpy as jnp

            from megapath.align.device import pack_ref_words

            words = pack_ref_words(self.ref.codes)
            self._ref_words_dev = (
                jax.device_put(words, self.device)
                if self.device is not None else jnp.asarray(words)
            )
        n = l_idx.shape[0]
        nb = _bucket(n)

        def pad1(a, dt=np.int32):
            a = a.astype(dt)
            if nb == n:
                return a
            return np.concatenate([a, np.zeros(nb - n, dt)])

        p = self.params
        dp = DPParams(p.match, p.mismatch, p.gap_open, p.gap_extend)
        left, right = deep_dp_fused_walk(
            self._ref_words_dev, len(self.ref.codes), walkers_dev,
            lens_dev, Nb,
            pad1(l_idx), pad1(l_starts), np.clip(pad1(l_wl), 0, width),
            pad1(r_idx), pad1(r_starts),
            np.clip(pad1(r_full_wl), 0, width),
            width, int(p.insert_high), params=dp,
        )
        s1, st_l, e_l, s2, st_r, e_r = jax.device_get(
            (left.score, left.start_ref, left.end_ref,
             right.score, right.start_ref, right.end_ref)
        )
        return (
            s1[:n].astype(np.int64), st_l[:n].astype(np.int64),
            e_l[:n].astype(np.int64), s2[:n].astype(np.int64),
            st_r[:n].astype(np.int64), e_r[:n].astype(np.int64),
        )

    def _device_align_rows(
        self,
        rows: np.ndarray,  # walker rows (idx + strand*Nb)
        lens: np.ndarray,
        win_starts: np.ndarray,
        width: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """_device_align against the resident walker matrix + packed
        windows (SE / mate-rescue legs); requires a valid _batch_dev
        stash (callers check)."""
        from megapath.align.device import align_rows_walk

        import jax

        if self._ref_words_dev is None:
            import jax.numpy as jnp

            from megapath.align.device import pack_ref_words

            words = pack_ref_words(self.ref.codes)
            self._ref_words_dev = (
                jax.device_put(words, self.device)
                if self.device is not None else jnp.asarray(words)
            )
        n = rows.shape[0]
        nb = _bucket(n)

        def pad1(a, dt=np.int32):
            a = a.astype(dt)
            if nb == n:
                return a
            return np.concatenate([a, np.zeros(nb - n, dt)])

        p = self.params
        dp = DPParams(p.match, p.mismatch, p.gap_open, p.gap_extend)
        out = align_rows_walk(
            self._ref_words_dev, len(self.ref.codes), self._batch_dev[1],
            pad1(rows), pad1(lens), pad1(win_starts),
            np.full(nb, width, np.int32), width, params=dp,
        )
        score, st_ref, e_ref = jax.device_get(
            (out.score, out.start_ref, out.end_ref)
        )
        return (
            score[:n].astype(np.int64), st_ref[:n].astype(np.int64),
            e_ref[:n].astype(np.int64),
        )

    def _device_locate(self, rows: np.ndarray) -> np.ndarray:
        from megapath.align.seeding_jax import device_locate

        n = len(rows)
        nb = _bucket(n)
        if nb != n:
            rows = np.concatenate([rows, np.ones(nb - n, rows.dtype)])
        out = device_locate(self.dfm, rows.astype(np.int32), self.dfm.sa_interval)
        return np.asarray(out)[:n].astype(np.int64)

    # ------------------------------------------------------------------
    def align_pairs(
        self,
        reads1: np.ndarray,
        lens1: np.ndarray,
        reads2: np.ndarray,
        lens2: np.ndarray,
    ) -> BatchHits:
        """Full batch alignment; large single-round batches go through
        the software-pipelined chunk path (seed walk of chunk i+1
        dispatched before chunk i's host decode, hiding host time
        behind the device — the aio_thread.cpp overlap, applied to the
        compute stages instead of file IO)."""
        n = len(reads1)
        if self.exact_rescue and self._exact_direct:
            # junk-heavy stream (measured on previous batches): the
            # dialed pass + near-full rescue would cost ~1.4x running
            # the exact walk outright — run exact directly, and demote
            # back when the stream turns matching-heavy again
            hits = self._run_exact(reads1, lens1, reads2, lens2)
            if len(lens1):
                have = np.zeros((2, n), bool)
                if len(hits):
                    have[hits.end, hits.read] = True
                nohit = float((~(have[0] & have[1])).sum()) / n
                if nohit < 0.3:
                    self._exact_direct = False
            return hits
        if (
            self.dfm is not None
            and self.chunk_pairs
            and n >= 2 * self.chunk_pairs
            and len(self.params.seeding_rounds) == 1
        ):
            hits = self._align_pairs_pipelined(reads1, lens1, reads2, lens2)
        else:
            hits = self._align_pairs_impl(reads1, lens1, reads2, lens2)
        if self.exact_rescue:
            hits = self._exact_rescue(hits, reads1, lens1, reads2, lens2)
        return hits

    def _exact_params(self) -> AlignParams:
        """self.params with every walk-truncation dial disabled."""
        from dataclasses import replace as _rep

        p = self.params
        ex = lambda m: _rep(m, kill_ratio=0.0, sibling_kill_steps=0)
        return p.with_(
            mmp=ex(p.mmp),
            extra_rounds=tuple(ex(m) for m in p.extra_rounds),
        )

    def _run_exact(self, reads1, lens1, reads2, lens2) -> BatchHits:
        old = self.params
        self.params = self._exact_params()
        try:
            return self._align_pairs_impl(reads1, lens1, reads2, lens2)
        finally:
            self.params = old

    def _exact_rescue(
        self, hits: BatchHits, reads1, lens1, reads2, lens2
    ) -> BatchHits:
        """Reference-exact results at dialed-walk speed (round 5).

        The progress-kill/sibling dials only ever LOSE hits, and the
        production audit shows every lost hit surfaces as a zero-hit
        read end (76/76 at the default dial, tools/parity_audit.py).
        So: re-run just the pairs that ended with a zero-hit end
        through the undialed walk and splice the results in — on
        matching-heavy batches that is a handful of pairs (0.2% on the
        512 Mbp audit: byte-identical reports at ~full dialed speed).
        When the rescue set exceeds half the batch (junk-heavy shard),
        subsequent batches switch to the direct exact walk instead of
        paying the double pass (see align_pairs)."""
        p = self.params
        dialed = any(
            m.kill_ratio > 0 or getattr(m, "sibling_kill_steps", 0) > 0
            for m in p.seeding_rounds
        )
        n = len(reads1)
        if not dialed or not n:
            return hits
        have = np.zeros((2, n), bool)
        if len(hits):
            have[hits.end, hits.read] = True
        needy = np.flatnonzero(~(have[0] & have[1]))
        if len(needy) == 0:
            return hits
        if len(needy) > n // 2:
            self._exact_direct = True
        sub = self._run_exact(
            reads1[needy], lens1[needy], reads2[needy], lens2[needy]
        )
        keep = (
            ~np.isin(hits.read, needy) if len(hits) else
            np.zeros(0, bool)
        )
        import dataclasses as _dc

        old = BatchHits(
            *[getattr(hits, f.name)[keep] for f in _dc.fields(BatchHits)]
        )
        if len(sub):
            sub.read[:] = needy[sub.read]
        return BatchHits.concat([old, sub])

    def _align_pairs_pipelined(
        self, reads1, lens1, reads2, lens2
    ) -> BatchHits:
        # stale stash + CPython id() reuse on a dead array could alias
        # a NEW batch's allr to the previous batch's device matrix —
        # clear it so only THIS call's seeding upload can match
        self._batch_dev = None
        n = len(reads1)
        cs = self.chunk_pairs
        bases = list(range(0, n, cs))
        mmp = self.params.mmp

        def chunk_reads(b):
            e = min(b + cs, n)
            cn = e - b
            L = max(reads1.shape[1], reads2.shape[1])
            allr = np.zeros((2 * cn, L), dtype=np.uint8)
            allr[:cn, : reads1.shape[1]] = reads1[b:e]
            allr[cn:, : reads2.shape[1]] = reads2[b:e]
            all_lens = np.concatenate([lens1[b:e], lens2[b:e]]).astype(
                np.int32
            )
            return allr, all_lens, cn

        parts: List[BatchHits] = []
        pending = None  # (base, allr, all_lens, cn, handle)
        for i, b in enumerate(bases + [None]):
            nxt = None
            if b is not None:
                allr, all_lens, cn = chunk_reads(b)
                handle = self._seed_walk_dispatch(allr, all_lens, mmp)
                nxt = (b, allr, all_lens, cn, handle)
            if pending is not None:
                pb, pallr, plens, pcn, ph = pending
                seeds = self._seed_compact_finish(ph)
                if seeds is None:  # cap overflow: redo via the full pull
                    seeds = self._device_seeds(pallr, plens, mmp)
                hits = self._chunk_round(
                    seeds, pallr, plens, pcn,
                    lens1[pb : pb + pcn], lens2[pb : pb + pcn], mmp,
                )
                # the overflow fallback above stashes _batch_dev keyed
                # by id(pallr); once pallr dies, a later chunk's array
                # can reuse the same address and silently alias the
                # stale device walker matrix — drop the stash with the
                # chunk it belongs to
                self._batch_dev = None
                if len(hits):
                    hits.read += np.int32(pb)
                parts.append(hits)
            pending = nxt
        return BatchHits.concat(parts)

    def _chunk_round(
        self, seeds, allr, all_lens, cn, clens1, clens2, mmp
    ) -> BatchHits:
        """One chunk's decode -> pair -> deep DP -> SE/rescue."""
        sp = decode_seeds(
            seeds, self.fm, all_lens, 2 * cn, mmp,
            locate_fn=self._device_locate if self.dfm is not None else None,
        )
        m1 = sp.read < cn
        sp1 = SeedPositions(
            sp.read[m1].astype(np.int32), sp.strand[m1], sp.pos[m1],
            sp.coverage[m1],
        )
        m2 = ~m1
        sp2 = SeedPositions(
            (sp.read[m2] - cn).astype(np.int32), sp.strand[m2], sp.pos[m2],
            sp.coverage[m2],
        )
        cands = pair_candidates(sp1, sp2, clens1, clens2, self.params)
        paired_hits, aligned = self._deep_dp(cands, allr, all_lens, cn)
        todo = np.setdiff1d(np.arange(cn), aligned)
        parts = [paired_hits]
        if len(todo):
            parts.append(
                self._single_and_rescue(todo, sp1, sp2, allr, all_lens, cn)
            )
        return BatchHits.concat(parts)

    def _align_pairs_impl(
        self,
        reads1: np.ndarray,
        lens1: np.ndarray,
        reads2: np.ndarray,
        lens2: np.ndarray,
    ) -> BatchHits:
        # see _align_pairs_pipelined: never let a previous batch's
        # stashed device matrix alias this batch via id() reuse
        self._batch_dev = None
        params = self.params
        n = len(reads1)
        L = max(reads1.shape[1], reads2.shape[1])
        allr = np.zeros((2 * n, L), dtype=np.uint8)
        allr[:n, : reads1.shape[1]] = reads1
        allr[n:, : reads2.shape[1]] = reads2
        all_lens = np.concatenate([lens1, lens2]).astype(np.int32)

        # deep-DP rounds (alignment.cpp:91-137): round r re-seeds only
        # the still-unaligned pairs with that round's MmpParams. Seeds
        # accumulate across rounds for the single-end stage, mirroring
        # the reference SeedPool reuse (SeedPool.h:80-127).
        hits_parts: List[BatchHits] = []
        sp1_parts: List[SeedPositions] = []
        sp2_parts: List[SeedPositions] = []
        todo = np.arange(n)
        for mmp in params.seeding_rounds:
            if len(todo) == 0:
                break
            t = len(todo)
            if t == n:
                sub_reads, sub_lens = allr, all_lens
            else:
                sel = np.concatenate([todo, todo + n])
                sub_reads, sub_lens = allr[sel], all_lens[sel]
            sp = self.seed_positions(sub_reads, sub_lens, mmp)
            m1 = sp.read < t
            sp1 = SeedPositions(
                todo[sp.read[m1]].astype(np.int32),
                sp.strand[m1], sp.pos[m1], sp.coverage[m1],
            )
            m2 = ~m1
            sp2 = SeedPositions(
                todo[sp.read[m2] - t].astype(np.int32),
                sp.strand[m2], sp.pos[m2], sp.coverage[m2],
            )
            sp1_parts.append(sp1)
            sp2_parts.append(sp2)

            cands = pair_candidates(sp1, sp2, lens1, lens2, params)
            paired_hits, aligned_pairs = self._deep_dp(
                cands, allr, all_lens, n
            )
            hits_parts.append(paired_hits)
            todo = np.setdiff1d(todo, aligned_pairs)

        # leftover pairs -> single-end DP + mate rescue + unpaired
        if len(todo):
            hits_parts.append(
                self._single_and_rescue(
                    todo, _concat_sp(sp1_parts), _concat_sp(sp2_parts),
                    allr, all_lens, n,
                )
            )
        return BatchHits.concat(hits_parts)

    # ------------------------------------------------------------------
    def _deep_dp(
        self,
        cands: Candidates,
        allr: np.ndarray,
        all_lens: np.ndarray,
        n: int,
    ) -> Tuple[BatchHits, np.ndarray]:
        params = self.params
        C = len(cands)
        if C == 0:
            return BatchHits.empty(), np.zeros(0, dtype=np.int64)

        # left leg: + strand; right leg: - strand (revcomp'd read)
        left_read_idx = np.where(cands.left_is_read2, cands.pair + n, cands.pair)
        right_read_idx = np.where(cands.left_is_read2, cands.pair, cands.pair + n)
        lL = all_lens[left_read_idx]
        lR = all_lens[right_read_idx]
        margin_l = np.where(lL > 100, 30, 25)
        margin_r = np.where(lR > 100, 30, 25)

        Lmax = int(all_lens.max(initial=1))
        Wwin = dp_window_width(Lmax)

        # BOTH legs in one fused device program: the left-hit position
        # clips the right window on device (leftHit + insert_high,
        # DV-DPfunctions.cpp:2933-2959) so no host round trip sits
        # between the legs. The left threshold gates the OUTPUT below —
        # kept hits are identical to the reference's two-phase flow.
        # (The insert_low anchor the reference also computes
        # (:2985-2988) is dead: the CPU kernel never reads it.)
        starts_l = cands.left_pos - margin_l
        starts_r_all = cands.right_pos - margin_r
        bd = self._batch_dev
        if bd is not None and bd[0] == id(allr) and bd[3] >= 2 * n:
            # candidate reads gather ON DEVICE from the seeding walk's
            # resident [reads; revcomp] matrix (row i / row Nb+i) and
            # the ref windows gather at packed-word granularity — the
            # host ships only int32 index arrays (deep_dp_fused_walk)
            s1, st_l, e_l, s2a, st_ra, e_ra = self._deep_dp_walk_call(
                bd[1], bd[2], bd[4], left_read_idx, starts_l,
                (lL + 2 * margin_l), right_read_idx, starts_r_all,
                (lR + 2 * margin_r), Wwin,
            )
        else:
            s1, st_l, e_l, s2a, st_ra, e_ra = self._deep_dp_fused_call(
                allr[left_read_idx], lL, starts_l,
                (lL + 2 * margin_l),
                _revcomp_rows(allr[right_read_idx], lR), lR, starts_r_all,
                (lR + 2 * margin_r), Wwin,
            )
        thr_l = np.maximum((params.cutoff_ratio * lL).astype(np.int64),
                           params.cutoff_lower_bound)
        kidx0 = np.flatnonzero(s1 >= thr_l)
        if len(kidx0) == 0:
            return BatchHits.empty(), np.zeros(0, dtype=np.int64)

        starts_r = starts_r_all[kidx0]
        lRk = lR[kidx0]
        s2, st_r, e_r = s2a[kidx0], st_ra[kidx0], e_ra[kidx0]
        thr_r = np.maximum((params.cutoff_ratio * lRk).astype(np.int64),
                           params.cutoff_lower_bound)
        sub = np.flatnonzero(s2 >= thr_r)
        if len(sub) == 0:
            return BatchHits.empty(), np.zeros(0, dtype=np.int64)
        kidx = kidx0[sub]
        K = len(kidx)

        sr = np.concatenate([s1[kidx], s2[sub]])
        g_start = np.concatenate(
            [starts_l[kidx] + st_l[kidx], starts_r[sub] + st_r[sub]]
        )
        g_stop = np.concatenate(
            [starts_l[kidx] + e_l[kidx], starts_r[sub] + e_r[sub]]
        )
        seq_s = self.ref.seq_of_pos(g_start)
        seq_e = self.ref.seq_of_pos(np.maximum(g_stop - 1, g_start))
        ok_bound = (seq_s == seq_e) & (g_start >= 0)
        seq_idx = seq_s.astype(np.int32)

        # layout: first K rows = left legs of kept cands, next K = right
        pair_idx = cands.pair[kidx]
        flip = cands.left_is_read2[kidx]
        end_of = np.concatenate([np.where(flip, 1, 0), np.where(flip, 0, 1)]).astype(np.int8)
        strand = np.concatenate([np.zeros(K, np.int8), np.ones(K, np.int8)])
        read_col = np.concatenate([pair_idx, pair_idx]).astype(np.int32)
        raw = sr.astype(np.int32)

        # normalizeScore (BGS-IO.cpp:1949-1963): same-seq both-valid
        # pairs get the summed score on both ends
        same = ok_bound[:K] & ok_bound[K:] & (seq_idx[:K] == seq_idx[K:])
        summed = raw[:K] + raw[K:]
        norm = raw.copy()
        norm[:K] = np.where(same, summed, raw[:K])
        norm[K:] = np.where(same, summed, raw[K:])
        paired = np.concatenate([same, same])

        keep_rows = ok_bound
        hits = BatchHits(
            read=read_col[keep_rows],
            end=end_of[keep_rows],
            seq=seq_idx[keep_rows],
            score=norm[keep_rows],
            raw_score=raw[keep_rows],
            start=g_start[keep_rows],
            stop=g_stop[keep_rows],
            strand=strand[keep_rows],
            paired=paired[keep_rows],
        )
        aligned = np.unique(pair_idx)
        return hits, aligned

    # ------------------------------------------------------------------
    def _single_and_rescue(
        self,
        todo: np.ndarray,
        sp1: SeedPositions,
        sp2: SeedPositions,
        allr: np.ndarray,
        all_lens: np.ndarray,
        n: int,
    ) -> BatchHits:
        """Single-end DP on leftover reads' seed positions, then mate
        rescue within the insert window (alignment.cpp:141-296 flow)."""
        params = self.params
        todo_set = np.zeros(n, dtype=bool)
        todo_set[todo] = True

        recs: List[BatchHits] = []
        singles: List[Tuple[int, int, int, int, int, int]] = []
        # (pair, end, strand, g_start, g_stop, score)

        # batch BOTH ends into one device call (each call pays a
        # dispatch and a host sync, which dominate small DPs)
        m1 = todo_set[sp1.read]
        m2 = todo_set[sp2.read]
        pair_b = np.concatenate([sp1.read[m1], sp2.read[m2]])
        end_b = np.concatenate(
            [np.zeros(int(m1.sum()), np.int8), np.ones(int(m2.sum()), np.int8)]
        )
        strand_b = np.concatenate([sp1.strand[m1], sp2.strand[m2]])
        pos_b = np.concatenate([sp1.pos[m1], sp2.pos[m2]])
        if len(pair_b):
            # cap at max_se_candidates per read end: the reference keeps
            # the first 200 clustered candidates per readID after the
            # (readID, pos) sort (DV-DPForSingleReads.cpp:191-205)
            order = np.lexsort((pos_b, strand_b, end_b, pair_b))
            pair_b, end_b, strand_b, pos_b = (
                pair_b[order], end_b[order], strand_b[order], pos_b[order]
            )
            new_grp = np.r_[
                True, (pair_b[1:] != pair_b[:-1]) | (end_b[1:] != end_b[:-1])
            ]
            first_of = np.flatnonzero(new_grp)
            gid = np.cumsum(new_grp) - 1
            rank = np.arange(len(gid)) - first_of[gid]
            keep = rank < params.max_se_candidates
            pair_b, end_b, strand_b, pos_b = (
                pair_b[keep], end_b[keep], strand_b[keep], pos_b[keep]
            )
        if len(pair_b):
            reads_idx = pair_b.astype(np.int64) + end_b.astype(np.int64) * n
            rl = all_lens[reads_idx]
            margin = np.where(rl > 100, 30, 25)
            Wwin = dp_window_width(int(rl.max(initial=1)))
            wstart = pos_b - margin
            bd = self._batch_dev
            if bd is not None and bd[0] == id(allr) and bd[3] >= 2 * n:
                # oriented read = walker row (fwd at idx, rc at Nb+idx)
                rows = (reads_idx + strand_b.astype(np.int64) * bd[4])
                score, st_ref, e_ref = self._device_align_rows(
                    rows.astype(np.int32), rl.astype(np.int32), wstart,
                    Wwin,
                )
            else:
                # + strand: forward read; - strand: revcomp
                fwd = allr[reads_idx]
                seqs = np.where(
                    (strand_b == 0)[:, None], fwd, _revcomp_rows(fwd, rl)
                ).astype(np.uint8)
                score, st_ref, e_ref = self._device_align(
                    seqs, rl.astype(np.int32), wstart, Wwin
                )
            thr = np.maximum((params.cutoff_ratio * rl).astype(np.int64),
                             params.cutoff_lower_bound)
            kidx = np.flatnonzero(score >= thr)
            if len(kidx):
                g_start = wstart[kidx] + st_ref[kidx]
                g_stop = wstart[kidx] + e_ref[kidx]
                seq_s = self.ref.seq_of_pos(g_start)
                seq_e = self.ref.seq_of_pos(np.maximum(g_stop - 1, g_start))
                ok = (seq_s == seq_e) & (g_start >= 0)
                tt = np.flatnonzero(ok)
                sel = kidx[tt]
                singles.append(np.stack(
                    [pair_b[sel], end_b[sel], strand_b[sel],
                     g_start[tt], g_stop[tt], score[sel], seq_s[tt]],
                    axis=1,
                ).astype(np.int64))

        singles = (
            np.concatenate(singles) if singles else np.zeros((0, 7), np.int64)
        )
        if not len(singles):
            return BatchHits.empty()

        # mate rescue: DP the other end inside the insert window
        mate_hits, rescued_rows, rescued_sums = self._mate_rescue(
            singles, allr, all_lens, n
        )

        # anchor records; rescued anchors get the summed pair score
        # (normalizeScore applies to both ends, BGS-IO.cpp:1949-1963)
        arr = singles
        a_score = arr[:, 5].astype(np.int32)
        a_paired = np.zeros(len(arr), dtype=bool)
        norm = a_score.copy()
        if len(rescued_rows):
            np.maximum.at(
                norm, np.asarray(rescued_rows), np.asarray(rescued_sums)
            )
            a_paired[np.asarray(rescued_rows)] = True
        unpaired = BatchHits(
            read=arr[:, 0].astype(np.int32),
            end=arr[:, 1].astype(np.int8),
            seq=arr[:, 6].astype(np.int32),
            score=norm,
            raw_score=a_score,
            start=arr[:, 3],
            stop=arr[:, 4],
            strand=arr[:, 2].astype(np.int8),
            paired=a_paired,
        )
        recs.append(unpaired)
        recs.append(mate_hits)
        return BatchHits.concat(recs)

    def _mate_rescue(
        self,
        anchors: List[Tuple[int, int, int, int, int, int, int]],
        allr: np.ndarray,
        all_lens: np.ndarray,
        n: int,
    ) -> BatchHits:
        """DP the mate of each passing single-end hit within the insert
        window (DV-SemiDP.cpp semantics: anchor one end, scan the other).

        Returns (mate hits, rescued anchor rows, summed scores)."""
        params = self.params
        if not len(anchors):
            return BatchHits.empty(), [], []
        arr = np.asarray(anchors, dtype=np.int64)
        pair, end, strand = arr[:, 0], arr[:, 1], arr[:, 2]
        g_start, g_stop, a_score = arr[:, 3], arr[:, 4], arr[:, 5]

        mate_idx = (pair + (1 - end) * n).astype(np.int64)
        ml = all_lens[mate_idx]
        margin = np.where(ml > 100, 30, 25)
        # anchor +: mate is - downstream; anchor -: mate is + upstream
        W = _round_up(int(params.insert_high + ml.max(initial=1) + 62), 128)
        win_start = np.where(
            strand == 0, g_start - margin, g_stop - params.insert_high - margin
        )
        mate_strand = 1 - strand
        bd = self._batch_dev
        if bd is not None and bd[0] == id(allr) and bd[3] >= 2 * n:
            rows = mate_idx + mate_strand * bd[4]
            score, st_ref, e_ref = self._device_align_rows(
                rows.astype(np.int32), ml.astype(np.int32), win_start, W
            )
        else:
            fwd = allr[mate_idx]
            seqs = np.where(
                (mate_strand == 0)[:, None], fwd, _revcomp_rows(fwd, ml)
            ).astype(np.uint8)
            score, st_ref, e_ref = self._device_align(
                seqs, ml.astype(np.int32), win_start, W
            )
        thr = np.maximum((params.cutoff_ratio * ml).astype(np.int64),
                         params.cutoff_lower_bound)
        kidx = np.flatnonzero(score >= thr)
        if len(kidx) == 0:
            return BatchHits.empty(), [], []
        m_start = win_start[kidx] + st_ref[kidx]
        m_stop = win_start[kidx] + e_ref[kidx]
        seq_s = self.ref.seq_of_pos(m_start)
        seq_e = self.ref.seq_of_pos(np.maximum(m_stop - 1, m_start))
        ok = (seq_s == seq_e) & (m_start >= 0)
        t = kidx[np.flatnonzero(ok)]
        tt = np.flatnonzero(ok)

        anchor_seq = self.ref.seq_of_pos(g_start[t])
        same = anchor_seq == seq_s[tt]
        mate_score = score[t]
        summed = np.where(same, mate_score + a_score[t], mate_score)
        hits = BatchHits(
            read=pair[t].astype(np.int32),
            end=(1 - end[t]).astype(np.int8),
            seq=seq_s[tt].astype(np.int32),
            score=summed.astype(np.int32),
            raw_score=mate_score.astype(np.int32),
            start=m_start[tt],
            stop=m_stop[tt],
            strand=mate_strand[t].astype(np.int8),
            paired=same,
        )
        return hits, t[same], summed[same].astype(np.int32)
