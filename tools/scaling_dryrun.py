"""Record weak-scaling of the SPMD engine step over virtual devices.

Runs the full in-program engine (seed -> locate -> pair -> DP -> merge)
at data-axis sizes 1/2/4 with a FIXED per-device batch and reports
throughput per device-row. On the virtual CPU mesh all devices share
the host's cores, so these numbers measure program overhead (dispatch,
collective layout), not cross-card scaling, which needs real cards.
Prints the table (update SCALING.md manually — the file also carries the memory-budget and merge-payload sections).

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/scaling_dryrun.py
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from megapath.align.params import AlignParams  # noqa: E402
from megapath.index.pack import COMPLEMENT  # noqa: E402
from megapath.parallel.spmd import (  # noqa: E402
    build_spmd_engine_step,
    pad_and_index_shards,
    place_spmd_inputs,
    stack_fms,
)


def main():
    rng = np.random.default_rng(1)
    S, M, seq_len = 2, 3, 5000
    shard_codes, seq_offsets, seq_species = [], [], []
    t = 0
    for s in range(S):
        shard_codes.append(
            rng.integers(0, 4, M * seq_len).astype(np.uint8)
        )
        seq_offsets.append(np.arange(M + 1, dtype=np.int32) * seq_len)
        seq_species.append(np.arange(t, t + M, dtype=np.int32))
        t += M
    fms, padded, true_n = pad_and_index_shards(
        shard_codes, sa_interval=8, lut_k=8
    )
    sfm, meta = stack_fms(fms)

    L, insert, per_row = 100, 250, 512
    devs = jax.devices()
    rows = []
    for D in (1, 2, 4):
        if D * S > len(devs):
            break
        mesh = Mesh(np.array(devs[: D * S]).reshape(D, S),
                    ("data", "shard"))
        B = per_row * D
        reads1 = np.zeros((B, L), np.uint8)
        reads2 = np.zeros((B, L), np.uint8)
        for b in range(B):
            s = b % S
            p = int(rng.integers(0, seq_len - insert)) + (b % M) * seq_len
            reads1[b] = shard_codes[s][p : p + L]
            reads2[b] = COMPLEMENT[
                shard_codes[s][p + insert - L : p + insert][::-1]
            ]
        lens = np.full(B, L, np.int32)
        step = build_spmd_engine_step(
            mesh, meta, read_len=L, n_species=t,
            params=AlignParams(insert_high=400, insert_low=50),
        )
        sfm_p, placed = place_spmd_inputs(
            mesh, sfm, ref_codes=padded, true_n=true_n,
            seq_offsets=np.stack(seq_offsets),
            seq_species=np.stack(seq_species),
            reads1=reads1, reads2=reads2, lens1=lens, lens2=lens,
        )
        args = (sfm_p, placed["ref_codes"], placed["true_n"],
                placed["seq_offsets"], placed["seq_species"],
                placed["reads1"], placed["reads2"],
                placed["lens1"], placed["lens2"])
        step(*args).best_score.block_until_ready()  # compile
        n_it = 3
        t0 = time.perf_counter()
        for _ in range(n_it):
            step(*args).best_score.block_until_ready()
        dt = (time.perf_counter() - t0) / n_it
        rows.append((D, S, B, dt, B / dt))
        print(f"D={D} S={S} B={B}: {dt*1e3:.1f} ms -> {B/dt:,.0f} pairs/s",
              file=sys.stderr)

    base = rows[0][4]
    lines = [
        "# SPMD engine weak scaling (virtual CPU mesh)",
        "",
        "Full in-program engine step (FM seeding, SA locate, PE pairing,",
        "window DP, all_gather merge), fixed 512 pairs per data row.",
        "Virtual devices SHARE the host cores, so ideal weak scaling here",
        "is flat total time / linear aggregate throughput only insofar as",
        "the host has spare cores; the number recorded is program-level",
        "overhead evidence, not cross-card scaling (virtual devices",
        "share the host — see __graft_entry__.dryrun_multichip).",
        "",
        "| data axis | shards | pairs | step (ms) | pairs/s | efficiency vs 1-row |",
        "|---|---|---|---|---|---|",
    ]
    for D, S_, B, dt, thr in rows:
        eff = thr / (base * D)
        lines.append(
            f"| {D} | {S_} | {B} | {dt*1e3:.1f} | {thr:,.0f} | {eff:.2f} |"
        )
    # print only: SCALING.md also carries the memory-budget and
    # merge-payload sections, which a blind overwrite would destroy
    print("\n".join(lines))


if __name__ == "__main__":
    main()
