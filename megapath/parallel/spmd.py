"""The real alignment engine as ONE SPMD program over a (data x shard) mesh.

Unlike ``parallel.dist`` (which takes precomputed candidate positions),
this module runs the actual compute path inside ``shard_map``: FM-index
MMP seeding (``seeding_jax.device_mmp_seed``) against the shard-resident
index, SA locate, insert-window PE candidate pairing, window gather +
batched affine DP for both legs, per-shard thresholding — then the
cross-shard all_gather hit merge and a psum species histogram over the
data axis. This is the distributed deep-DP stage of the reference
cascade (/root/reference/runMegaPath.sh:191-227 runs the shards
sequentially, chaining hits through cfq comments; here every shard is a
mesh column and the merge is the associative max the chain computes).

Design constraints baked in:
  * All shards share one XLA program, so shard index texts are padded
    to a common length (``pad_and_index_shards``); candidates landing
    in the pad region are masked out against the per-shard true length.
  * ``DeviceFM.primary`` is static jit metadata on the single-shard
    path; here each shard's primary differs, so it rides as a traced
    per-shard scalar and the seeding/locate internals are entered via
    their unjitted ``__wrapped__`` forms (the arithmetic is identical).
  * Fixed candidate caps (``max_seeds`` per walker, one SA entry per
    seed, best pair per orientation) keep shapes static; the
    host-orchestrated engine (``align.engine`` placed per-device via
    ``MegaPathPipeline(devices=...)``) remains the parity-exact path,
    while this program is the scale-out shape for device meshes.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from megapath.align.params import AlignParams
from megapath.align.seeding_jax import (
    DeviceFM,
    build_walkers,
    device_locate,
    device_mmp_seed,
)
from megapath.index.fm import FMIndex, build_fm_index
from megapath.ops.dp import DPParams, sw_align

# unjitted entry points: the SPMD program traces them with a per-shard
# traced ``primary`` (jit would demand it be hashable static aux)
_seed_fn = device_mmp_seed.__wrapped__
_locate_fn = device_locate.__wrapped__

OFF_TEXT_CODE = 4


class StackedFM(NamedTuple):
    """Per-shard FM-index leaves stacked on a leading shard axis."""

    bwt_words: jnp.ndarray  # [S, n_words] uint32
    fused_rows: jnp.ndarray  # [S, R, C] uint32
    counts: jnp.ndarray  # [S, 5] int32
    mark_rows: jnp.ndarray  # [S, ceil((n+1)/32), 2] uint32 word+rank
    sa_sampled: jnp.ndarray  # [S, n_marked_max] int32
    primary: jnp.ndarray  # [S] int32 (traced inside the program)


class FMMeta(NamedTuple):
    """Static (shard-invariant) FM metadata."""

    n: int
    lut_k: int
    sa_interval: int
    # fused-row occ block granularity — MUST mirror DeviceFM.blk (the
    # layout is auto-selected per table size in DeviceFM.from_host, so
    # there is no safe default: a mismatched blk mis-slices paired rows).
    blk: int


def stack_fms(fms: Sequence[FMIndex]) -> Tuple[StackedFM, FMMeta]:
    """Stack equal-length shard FM-indexes for the SPMD program."""
    ns = {fm.n for fm in fms}
    if len(ns) != 1:
        raise ValueError(
            f"SPMD shards must share a text length (got {sorted(ns)}); "
            "use pad_and_index_shards"
        )
    dfms = [DeviceFM.from_host(fm) for fm in fms]
    meta = FMMeta(
        n=dfms[0].n,
        lut_k=dfms[0].lut_k,
        sa_interval=dfms[0].sa_interval,
        blk=dfms[0].blk,
    )
    for d in dfms[1:]:
        if (d.lut_k, d.sa_interval) != (meta.lut_k, meta.sa_interval):
            raise ValueError("shard FM build parameters differ")
    nm = max(int(d.sa_sampled.shape[0]) for d in dfms)

    def pad_sa(d):
        a = np.asarray(d.sa_sampled)
        return np.pad(a, (0, nm - a.shape[0]))

    stacked = StackedFM(
        bwt_words=jnp.asarray(np.stack([np.asarray(d.bwt_words) for d in dfms])),
        fused_rows=jnp.asarray(np.stack([np.asarray(d.fused_rows) for d in dfms])),
        counts=jnp.asarray(np.stack([np.asarray(d.counts) for d in dfms])),
        mark_rows=jnp.asarray(
            np.stack([np.asarray(d.mark_rows) for d in dfms])
        ),
        sa_sampled=jnp.asarray(np.stack([pad_sa(d) for d in dfms])),
        primary=jnp.asarray([d.primary for d in dfms], dtype=jnp.int32),
    )
    return stacked, meta


def pad_and_index_shards(
    shard_codes: Sequence[np.ndarray],
    sa_interval: int = 16,
    lut_k: int = 8,
    seed: int = 7,
) -> Tuple[List[FMIndex], np.ndarray, np.ndarray]:
    """Pad shard texts to a common length with random junk (a spurious
    exact >=17-mer match into the pad has probability ~4^-17; matched
    candidates in the pad are masked against ``true_n`` regardless) and
    build each shard's FM-index. Returns (fms, padded_codes [S, N],
    true_n [S])."""
    rng = np.random.default_rng(seed)
    n = max(len(c) for c in shard_codes)
    padded, fms, true_n = [], [], []
    for c in shard_codes:
        pad = rng.integers(0, 4, n - len(c)).astype(np.uint8)
        full = np.concatenate([np.asarray(c, np.uint8), pad])
        padded.append(full)
        fms.append(build_fm_index(full, sa_interval=sa_interval, lut_k=lut_k))
        true_n.append(len(c))
    return fms, np.stack(padded), np.asarray(true_n, np.int32)


def make_mesh_for(devices, n_shards: int = 2) -> Mesh:
    """(data x shard) mesh with the shard axis sized to the index
    shards; leftover devices fold into the data axis."""
    n = (len(devices) // n_shards) * n_shards
    if n == 0:
        raise ValueError(
            f"need at least {n_shards} devices for {n_shards} shards"
        )
    arr = np.array(devices[:n]).reshape(n // n_shards, n_shards)
    return Mesh(arr, axis_names=("data", "shard"))


class SpmdAlignOut(NamedTuple):
    best_score: jnp.ndarray  # int32 [B] best paired score over shards
    best_shard: jnp.ndarray  # int32 [B]
    best_pos: jnp.ndarray  # int32 [B] left-leg text position of the best
    all_scores: jnp.ndarray  # int32 [B, S] per-shard best paired score
    all_species: jnp.ndarray  # int32 [B, S] species of that hit (-1 none)
    kept: jnp.ndarray  # bool [B, S] -top retention vs the global best
    species_counts: jnp.ndarray  # int32 [T] winner-species histogram


def build_spmd_engine_step(
    mesh: Mesh,
    meta: FMMeta,
    read_len: int,
    n_species: int,
    params: AlignParams = AlignParams(),
    max_seeds: int = 6,
):
    """Compile the full seed->pair->DP->merge step over the mesh.

    Global input shapes (S = mesh['shard'], B = global pairs):
      fm leaves        [S, ...]  sharded P('shard', ...)
      ref_codes        [S, N]    padded shard texts, P('shard', None)
      true_n           [S]       unpadded lengths, P('shard')
      seq_offsets      [S, M+1]  per-shard sequence starts, P('shard', None)
      seq_species      [S, M]    species ids, P('shard', None)
      reads1/reads2    [B, L]    P('data', None) (replicated over shard)
      lens1/lens2      [B]       P('data')
    """
    S = mesh.shape["shard"]
    L = read_len
    mmp = params.mmp
    margin = params.margin(L)
    width = L + 2 * margin
    dp = DPParams(params.match, params.mismatch, params.gap_open,
                  params.gap_extend)

    def local_step(fm_leaves, primary, ref_local, true_n_local,
                   seq_off, seq_sp, reads1, reads2, lens1, lens2):
        dfm = DeviceFM(
            n=meta.n,
            primary=primary[0],
            bwt_words=fm_leaves[0][0],
            fused_rows=fm_leaves[1][0],
            counts=fm_leaves[2][0],
            lut_k=meta.lut_k,
            mark_rows=fm_leaves[3][0],
            sa_sampled=fm_leaves[4][0],
            sa_interval=meta.sa_interval,
            blk=meta.blk,
        )
        ref = ref_local[0]
        true_n = true_n_local[0]
        Bl = reads1.shape[0]

        # ---- 1. MMP seeding over [r1; r2; rc(r1); rc(r2)] ------------
        allr = jnp.concatenate([reads1, reads2], axis=0)
        all_lens = jnp.concatenate([lens1, lens2]).astype(jnp.int32)
        walkers, wlens = build_walkers(allr, all_lens)  # [4Bl, L]
        chg = 3 * walkers.shape[1] + 64
        seeds, _ = _seed_fn(
            dfm, walkers, wlens, mmp, max_seeds=max_seeds,
            max_steps=(2 * chg + 128 if meta.blk < 128 else chg),
            two_phase=(meta.blk < 128), charge_limit=chg,
        )

        # ---- 2. SA locate (one entry per seed slot) ------------------
        slots = jnp.arange(max_seeds, dtype=jnp.int32)[None, :]
        svalid = (
            (slots < seeds.n_seeds[:, None].astype(jnp.int32))
            & (seeds.sa_count.astype(jnp.int32) >= 1)
            & (seeds.sa_count.astype(jnp.int32) <= mmp.sa_size_threshold)
        )
        rows = jnp.where(svalid, seeds.sa_lo, 0)
        pos = _locate_fn(
            dfm, rows.reshape(-1).astype(jnp.int32), meta.sa_interval
        ).reshape(rows.shape)
        # candidate read-start position in shard text; pad-region and
        # off-text candidates are dropped
        cand = pos - seeds.offset.astype(jnp.int32)
        ok = svalid & (pos >= 0) & (cand >= -margin) & (cand < true_n)
        NEG = jnp.int32(-(1 << 30))
        cand = jnp.where(ok, cand, NEG)
        seed_len = jnp.where(ok, seeds.length.astype(jnp.int32), 0)

        # walker rows: [0,Bl)=r1 fwd, [Bl,2Bl)=r2 fwd, [2Bl,3Bl)=rc r1,
        # [3Bl,4Bl)=rc r2 (build_walkers appends revcomp of the stack)
        c_r1f, c_r2f = cand[:Bl], cand[Bl : 2 * Bl]
        c_r1r, c_r2r = cand[2 * Bl : 3 * Bl], cand[3 * Bl :]
        l_r1f, l_r2f = seed_len[:Bl], seed_len[Bl : 2 * Bl]
        l_r1r, l_r2r = seed_len[2 * Bl : 3 * Bl], seed_len[3 * Bl :]

        # ---- 3. PE pairing: insert-window join, best pair per orient -
        def best_pair(cl, ll, cr, lr, len_l, len_r):
            """left leg fwd at cl, right leg rc at cr downstream:
            fragment = (cr + len_r) - cl in [insert_low, insert_high]
            (DV-DPfunctions.cpp insert-window semantics)."""
            frag = (cr[:, None, :] + len_r[:, None, None]) - cl[:, :, None]
            okp = (
                (cl[:, :, None] > NEG // 2)
                & (cr[:, None, :] > NEG // 2)
                & (frag >= params.insert_low)
                & (frag <= params.insert_high)
            )
            qual = jnp.where(okp, ll[:, :, None] + lr[:, None, :], -1)
            flat = qual.reshape(Bl, -1)
            bi = jnp.argmax(flat, axis=1).astype(jnp.int32)
            has = jnp.take_along_axis(flat, bi[:, None], axis=1)[:, 0] > -1
            i, j = bi // max_seeds, bi % max_seeds
            pl = jnp.take_along_axis(cl, i[:, None], axis=1)[:, 0]
            pr = jnp.take_along_axis(cr, j[:, None], axis=1)[:, 0]
            return has, pl, pr

        # orientation 0: r1 fwd + r2 rc;  orientation 1: r2 fwd + r1 rc
        has0, p0l, p0r = best_pair(c_r1f, l_r1f, c_r2r, l_r2r,
                                   lens1.astype(jnp.int32),
                                   lens2.astype(jnp.int32))
        has1, p1l, p1r = best_pair(c_r2f, l_r2f, c_r1r, l_r1r,
                                   lens2.astype(jnp.int32),
                                   lens1.astype(jnp.int32))

        # ---- 4. window gather + batched DP (4 legs per read) ---------
        def win(starts):
            idx = (starts - margin)[:, None] + jnp.arange(
                width, dtype=jnp.int32
            )[None, :]
            valid = (idx >= 0) & (idx < true_n)
            w = jnp.take(ref, jnp.clip(idx, 0, meta.n - 1), axis=0)
            return jnp.where(valid, w, OFF_TEXT_CODE).astype(jnp.uint8)

        dp_reads = jnp.concatenate([
            walkers[:Bl],              # o0 left: r1 fwd
            walkers[3 * Bl :],         # o0 right: rc r2
            walkers[Bl : 2 * Bl],      # o1 left: r2 fwd
            walkers[2 * Bl : 3 * Bl],  # o1 right: rc r1
        ])
        dp_lens = jnp.concatenate([lens1, lens2, lens2, lens1]).astype(
            jnp.int32
        )
        dp_wins = jnp.concatenate(
            [win(jnp.maximum(p, 0)) for p in (p0l, p0r, p1l, p1r)]
        )
        res = sw_align(
            dp_reads, dp_wins, dp_lens,
            jnp.full(4 * Bl, width, jnp.int32), params=dp,
        )
        thr = jnp.maximum(
            (params.cutoff_ratio * dp_lens).astype(jnp.int32),
            jnp.int32(params.cutoff_lower_bound),
        )
        leg = jnp.where(res.score >= thr, res.score, 0).reshape(4, Bl)
        pair0 = jnp.where(has0 & (leg[0] > 0) & (leg[1] > 0),
                          leg[0] + leg[1], 0)
        pair1 = jnp.where(has1 & (leg[2] > 0) & (leg[3] > 0),
                          leg[2] + leg[3], 0)
        score = jnp.maximum(pair0, pair1)
        left_pos = jnp.where(pair0 >= pair1, p0l, p1l)
        left_pos = jnp.where(score > 0, left_pos, -1)

        # ---- 5. species annotation on this shard ---------------------
        seq_idx = (
            jnp.searchsorted(
                seq_off[0], jnp.maximum(left_pos, 0), side="right"
            ) - 1
        ).astype(jnp.int32)
        seq_idx = jnp.clip(seq_idx, 0, seq_sp.shape[1] - 1)
        species = jnp.where(score > 0, seq_sp[0][seq_idx], -1)

        # ---- 6. cross-shard merge (the cfq-comment-chain equivalent) -
        scores_t = jax.lax.all_gather(score, "shard", axis=0).T  # [Bl, S]
        species_t = jax.lax.all_gather(species, "shard", axis=0).T
        pos_t = jax.lax.all_gather(left_pos, "shard", axis=0).T
        best_score = jnp.max(scores_t, axis=1)
        sh_ids = jnp.arange(S, dtype=jnp.int32)[None, :]
        is_best = (scores_t == best_score[:, None]) & (scores_t > 0)
        # ties resolve to the LOWEST shard id — the reference's chain
        # keeps the first-seen max (BGS-IO.cpp comment merge)
        best_shard = jnp.min(jnp.where(is_best, sh_ids, S), axis=1)
        best_shard = jnp.where(best_score > 0, best_shard, -1)
        best_pos = jnp.take_along_axis(
            pos_t, jnp.maximum(best_shard, 0)[:, None], axis=1
        )[:, 0]
        best_pos = jnp.where(best_score > 0, best_pos, -1)
        kept = (scores_t > 0) & (
            scores_t
            >= (params.top_percentage * best_score[:, None]).astype(jnp.int32)
        )
        win_sp = jnp.take_along_axis(
            species_t, jnp.maximum(best_shard, 0)[:, None], axis=1
        )[:, 0]
        win_sp = jnp.where(best_score > 0, win_sp, n_species)
        onehot = (
            win_sp[:, None]
            == jnp.arange(n_species + 1, dtype=jnp.int32)[None, :]
        ).astype(jnp.int32)
        hist = jax.lax.psum(onehot.sum(axis=0), "data")[:n_species]

        return (best_score, best_shard, best_pos, scores_t, species_t,
                kept, hist)

    shmapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            (P("shard"),) * 5,  # fm leaves (trailing dims replicated)
            P("shard"),  # primary
            P("shard"),  # ref_codes
            P("shard"),  # true_n
            P("shard"),  # seq_offsets
            P("shard"),  # seq_species
            P("data"), P("data"),  # reads
            P("data"), P("data"),  # lens
        ),
        out_specs=(
            P("data"), P("data"), P("data"),
            P("data", None), P("data", None), P("data", None),
            P(None),
        ),
        check_vma=False,
    )

    def step(sfm: StackedFM, ref_codes, true_n, seq_offsets, seq_species,
             reads1, reads2, lens1, lens2):
        leaves = (sfm.bwt_words, sfm.fused_rows,
                  sfm.counts, sfm.mark_rows,
                  sfm.sa_sampled)
        return SpmdAlignOut(*shmapped(
            leaves, sfm.primary, ref_codes, true_n, seq_offsets,
            seq_species, reads1, reads2, lens1, lens2,
        ))

    return jax.jit(step)


def place_spmd_inputs(mesh: Mesh, sfm: StackedFM, **arrays):
    """device_put the step inputs with their canonical shardings."""
    shard2 = NamedSharding(mesh, P("shard", None))
    shard1 = NamedSharding(mesh, P("shard"))
    data2 = NamedSharding(mesh, P("data", None))
    data1 = NamedSharding(mesh, P("data"))
    spec = {
        "ref_codes": shard2, "true_n": shard1,
        "seq_offsets": shard2, "seq_species": shard2,
        "reads1": data2, "reads2": data2,
        "lens1": data1, "lens2": data1,
    }
    placed = {k: jax.device_put(v, spec[k]) for k, v in arrays.items()}
    sfm_placed = StackedFM(
        bwt_words=jax.device_put(sfm.bwt_words, shard2),
        fused_rows=jax.device_put(
            sfm.fused_rows, NamedSharding(mesh, P("shard", None, None))
        ),
        counts=jax.device_put(sfm.counts, shard2),
        mark_rows=jax.device_put(
            sfm.mark_rows, NamedSharding(mesh, P("shard", None, None))
        ),
        sa_sampled=jax.device_put(sfm.sa_sampled, shard2),
        primary=jax.device_put(sfm.primary, shard1),
    )
    return sfm_placed, placed


def spmd_report(
    out: SpmdAlignOut,
    species_tids: Sequence[int],
    taxdb,
    lens1: np.ndarray,
    lens2: np.ndarray,
    cutoff: int = 40,
) -> str:
    """The report tail over the SPMD step's merged hit arrays.

    Equivalent of fastq2lsam | taxLookupAcc | genKrakenReport on the
    distributed output: each pair contributes one classified line per
    end (the SPMD deep-DP stage reports proper pairs; both ends carry
    the summed pair score and the -top-retained species set's LCA,
    genKrakenReport.cpp:148-156 thresholding).
    """
    from megapath.taxonomy.report import KrakenReport

    kept = np.asarray(out.kept)
    species = np.asarray(out.all_species)
    best = np.asarray(out.best_score).astype(np.int64)
    tid_of = np.asarray(list(species_tids) + [0], dtype=np.int64)
    B = kept.shape[0]

    # vectorized grouped LCA over the kept (read, species) rows — no
    # per-read Python loop (taxdb.lca_grouped shift-doubling fold)
    lcas = np.zeros(B, np.int64)
    rows, cols = np.nonzero(kept & (species >= 0))
    if len(rows):
        key = rows.astype(np.int64) * (species.max() + 2) + species[
            rows, cols
        ]
        order = np.argsort(key)
        rs, ss = rows[order], species[rows, cols][order]
        uniq = np.r_[True, (rs[1:] != rs[:-1]) | (ss[1:] != ss[:-1])]
        rs, ss = rs[uniq], ss[uniq]
        pres = np.unique(rs)
        lcas[pres] = taxdb.lca_grouped(tid_of[ss], rs)

    # per-end lines: score is the pair-normalized sum (both ends carry
    # it), LCA shared; unaligned pairs are unclassified
    line_scores = np.repeat(best, 2)
    line_lcas = np.repeat(lcas, 2)
    eff = np.where(line_lcas > 0, line_scores, -1)
    rpt = KrakenReport(taxdb)
    rpt.add_lsam_batch(eff, line_lcas, cutoff)
    return rpt.format()
