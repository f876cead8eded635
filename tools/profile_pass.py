#!/usr/bin/env python
"""Per-stage wall-clock profile of one warm engine pass on the bench
workload. Wraps the engine's stage entry points with timers (each stage
already ends in a host sync via device_get, so wall time is honest).

Usage: python tools/profile_pass.py [n_passes]
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    import jax

    from megapath.utils.compile_cache import use_compile_cache

    use_compile_cache()

    import bench
    from megapath.align import AlignEngine, AlignParams

    if os.environ.get("PROFILE_LARGE"):
        from tools.build_bench_shard import build as _build_big

        ref, fm, reads1, lens1, reads2, lens2 = _build_big()
    else:
        ref, fm, reads1, lens1, reads2, lens2 = bench.build_workload()
    engine = AlignEngine(ref, fm, AlignParams(), device_seeding=True)

    times = defaultdict(float)
    counts = defaultdict(int)

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t = time.time()
            out = fn(*a, **k)
            times[label] += time.time() - t
            counts[label] += 1
            return out

        setattr(obj, name, timed)

    shapes = []

    def wrap_shapes(obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t = time.time()
            out = fn(*a, **k)
            times[label] += time.time() - t
            counts[label] += 1
            shapes.append(
                (label,)
                + tuple(
                    getattr(x, "shape", None)
                    for x in a
                    if hasattr(x, "shape")
                )
            )
            return out

        setattr(obj, name, timed)

    wrap(engine, "_device_seeds", "seed_walk+pull")
    wrap(engine, "_device_locate", "locate")
    wrap_shapes(engine, "_deep_dp_fused_call", "deep_dp_device")
    wrap_shapes(engine, "_device_align", "se_rescue_device")
    wrap(engine, "_deep_dp", "deep_dp_total")
    wrap(engine, "_single_and_rescue", "se_rescue_total")
    wrap(engine, "seed_positions", "seeding_total")

    import megapath.align.engine as eng_mod
    from megapath.align import pairing as pairing_mod

    orig_pair = pairing_mod.pair_candidates

    def timed_pair(*a, **k):
        t = time.time()
        out = orig_pair(*a, **k)
        times["pairing_host"] += time.time() - t
        counts["pairing_host"] += 1
        return out

    eng_mod.pair_candidates = timed_pair

    print("[profile] warmup", file=sys.stderr, flush=True)
    t = time.time()
    engine.align_pairs(reads1, lens1, reads2, lens2)
    print(f"[profile] warmup {time.time()-t:.1f}s", file=sys.stderr, flush=True)

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    tot = []
    for i in range(n):
        times.clear()
        counts.clear()
        t = time.time()
        hits = engine.align_pairs(reads1, lens1, reads2, lens2)
        dt = time.time() - t
        tot.append(dt)
        print(f"[profile] pass {i}: {dt:.3f}s hits={len(hits.read)}")
        for k in sorted(times, key=lambda k: -times[k]):
            print(f"    {k:24s} {times[k]:7.3f}s  x{counts[k]}")
    print(f"best pass {min(tot):.3f}s "
          f"({2 * bench.N_PAIRS / min(tot):.0f} reads/s)")
    for s in shapes[: len(shapes) // max(1, len(tot))]:
        print("   shapes:", s)

    if "--spmd" in sys.argv:
        # ONE-program path on a 1x1 mesh: the whole align pass as a
        # single device call (sync count 1); caps tuned to the bench
        import jax
        import numpy as np
        from jax.sharding import Mesh

        from megapath.parallel.spmd_full import (
            SpmdCaps,
            build_spmd_full_engine,
            pad_ref_codes,
            pad_seq_offsets,
            spmd_hits_to_batch,
            stack_fms_exact,
        )

        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    axis_names=("data", "shard"))
        sfm, meta = stack_fms_exact([fm])
        step = build_spmd_full_engine(
            mesh, meta, bench.READ_LEN,
            caps=SpmdCaps(pos_factor=6, cand_factor=3, se_factor=1),
        )
        rc = pad_ref_codes([ref.codes])
        so = pad_seq_offsets([ref.offsets])
        print("[profile] spmd_full warmup (compile)", flush=True)
        t = time.time()
        out = step(sfm, rc, so, reads1, reads2, lens1, lens2)
        jax.block_until_ready(out)
        print(f"[profile] spmd_full warmup {time.time()-t:.1f}s")
        for i in range(3):
            t = time.time()
            out = step(sfm, rc, so, reads1, reads2, lens1, lens2)
            jax.block_until_ready(out)
            dt = time.time() - t
            print(f"[profile] spmd_full pass {i}: {dt:.3f}s "
                  f"({2*bench.N_PAIRS/dt:.0f} reads/s) "
                  f"overflow={int(np.asarray(out.overflow).max())}")
        hits2 = spmd_hits_to_batch(out, bench.N_PAIRS)
        print(f"[profile] spmd_full hits={len(hits2[0].read)}")


if __name__ == "__main__":
    main()
