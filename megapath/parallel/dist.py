"""Multi-chip sharding: index shards x read batches over a device mesh.

The reference processes NT index shards *sequentially*, carrying hits
in FASTQ comments (runMegaPath.sh:191-227, SURVEY.md §2.7 item 6). The
design here runs all shards *concurrently*: the packed reference text is
sharded over the mesh's 'shard' axis, read batches are data-parallel
over 'data', per-read per-shard best hits merge with an all_gather
over 'shard' (the associative merge the comment chain implements
sequentially), the ``-top N%`` retention applies against the global
best, and per-species read counts reduce with a psum over 'data'.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from megapath.align.device import gather_windows
from megapath.ops.dp import DPParams, sw_align


def make_mesh(
    n_devices: int | None = None, shard_axis: int | None = None
) -> Mesh:
    """(data, shard) mesh. shard_axis defaults to min(2, n) so small
    device counts still exercise both axes."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if shard_axis is None:
        shard_axis = 2 if n % 2 == 0 and n >= 2 else 1
    data_axis = n // shard_axis
    arr = np.array(devs).reshape(data_axis, shard_axis)
    return Mesh(arr, axis_names=("data", "shard"))


class DistAlignOut(NamedTuple):
    best_score: jnp.ndarray  # int32 [B] best over all shards
    best_shard: jnp.ndarray  # int32 [B] shard of the best hit
    best_pos: jnp.ndarray  # int32 [B] window start of the best hit
    all_scores: jnp.ndarray  # int32 [B, S] per-shard best score (0 = none)
    all_species: jnp.ndarray  # int32 [B, S] species of that hit (-1 = none)
    kept: jnp.ndarray  # bool [B, S] hit >= top_percentage * global best
    species_counts: jnp.ndarray  # int32 [T] winner-species read counts


def build_dist_align_step(
    mesh: Mesh,
    width: int,
    n_species: int,
    params: DPParams = DPParams(),
    cutoff_lb: int = 30,
    cutoff_ratio: float = 0.2,
    top_percentage: float = 0.95,
):
    """The full multi-chip alignment step, jitted over the mesh.

    Inputs (global shapes; S = mesh 'shard' size, B = global reads):
      ref_shards   [S, N]    uint8 packed text, sharded over 'shard'
      seq_offsets  [S, M+1]  int32 per-shard sequence start offsets
                   (monotone, padded with the shard text length),
                   sharded over 'shard'
      seq_species  [S, M]    int32 per-sequence species index in
                   [0, n_species), sharded over 'shard'
      reads        [B, L]    uint8, sharded over 'data'
      read_lens    [B]       int32, sharded over 'data'
      cand_pos     [B, S]    int32 per-shard candidate window start,
                   sharded over 'data' (replicated over 'shard')

    The per-shard (score, species) pairs all_gather over 'shard' so
    every read ends with its full cross-shard hit list — the array
    equivalent of taxLookupAcc keeping the max score per species and
    the driver's ``-top 95`` retention (BGS-IO.cpp:2034-2040).
    """
    n_shards = mesh.shape["shard"]

    def local_step(ref_local, seq_off_local, seq_sp_local, reads, read_lens,
                   cand_pos):
        # ref_local: [1, N]; seq_off_local: [1, M+1]; cand_pos: [Bl, S]
        shard_id = jax.lax.axis_index("shard")
        ref = ref_local[0]
        pos = jnp.take_along_axis(
            cand_pos,
            jnp.full((cand_pos.shape[0], 1), shard_id, dtype=jnp.int32),
            axis=1,
        )[:, 0]
        wins = gather_windows(ref, pos, width)
        wlens = jnp.full(reads.shape[0], width, dtype=jnp.int32)
        res = sw_align(reads, wins, read_lens, wlens, params=params)
        thr = jnp.maximum(
            (cutoff_ratio * read_lens).astype(jnp.int32), jnp.int32(cutoff_lb)
        )
        score = jnp.where(res.score >= thr, res.score, 0)

        # hit position -> sequence -> species (this shard's annotation)
        hit_pos = (pos + res.end_ref - 1).astype(jnp.int32)
        seq_idx = (
            jnp.searchsorted(seq_off_local[0], hit_pos, side="right") - 1
        ).astype(jnp.int32)
        seq_idx = jnp.clip(seq_idx, 0, seq_sp_local.shape[1] - 1)
        species = jnp.where(score > 0, seq_sp_local[0][seq_idx], -1)

        # cross-shard merge: every read's full per-shard hit list
        scores_all = jax.lax.all_gather(score, "shard", axis=0)  # [S, Bl]
        species_all = jax.lax.all_gather(species, "shard", axis=0)
        pos_all = jax.lax.all_gather(pos.astype(jnp.int32), "shard", axis=0)
        scores_t = scores_all.T  # [Bl, S]
        species_t = species_all.T

        best_score = jnp.max(scores_t, axis=1)
        # ties resolve to the highest shard id, matching the toy pmax
        sh_ids = jnp.arange(n_shards, dtype=jnp.int32)[None, :]
        is_best = scores_t == best_score[:, None]
        best_shard = jnp.max(jnp.where(is_best, sh_ids, -1), axis=1)
        best_pos = jnp.take_along_axis(
            pos_all.T, jnp.maximum(best_shard, 0)[:, None], axis=1
        )[:, 0]
        best_pos = jnp.where(best_score > 0, best_pos, -1)

        # -top N% retention against the global best (BGS-IO.cpp:1966+)
        kept = (scores_t > 0) & (
            scores_t >= (top_percentage * best_score[:, None]).astype(jnp.int32)
        )

        # winner-species histogram, reduced over the data axis (the
        # gathered arrays are replicated over 'shard')
        win_sp = jnp.take_along_axis(
            species_t, jnp.maximum(best_shard, 0)[:, None], axis=1
        )[:, 0]
        win_sp = jnp.where(best_score > 0, win_sp, n_species)
        onehot = (
            win_sp[:, None] == jnp.arange(n_species + 1, dtype=jnp.int32)[None, :]
        ).astype(jnp.int32)
        hist = jax.lax.psum(onehot.sum(axis=0), "data")[:n_species]

        return (
            best_score,
            best_shard,
            best_pos,
            scores_t,
            species_t,
            kept,
            hist,
        )

    shmapped = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("shard", None),
            P("shard", None),
            P("shard", None),
            P("data", None),
            P("data"),
            P("data", None),
        ),
        out_specs=(
            P("data"),
            P("data"),
            P("data"),
            P("data", None),
            P("data", None),
            P("data", None),
            P(None),
        ),
        check_vma=False,  # scan carries start unvarying inside the map
    )

    def step(*args):
        return DistAlignOut(*shmapped(*args))

    return jax.jit(step)


def shard_arrays(mesh: Mesh, **arrays):
    """Place arrays with their canonical shardings."""
    spec = {
        "ref_shards": P("shard", None),
        "seq_offsets": P("shard", None),
        "seq_species": P("shard", None),
        "reads": P("data", None),
        "read_lens": P("data"),
        "cand_pos": P("data", None),
    }
    out = {}
    for k, v in arrays.items():
        out[k] = jax.device_put(v, NamedSharding(mesh, spec[k]))
    return out
