#!/usr/bin/env python
"""Probe: cost of the post-walk pieces — flatten_seeds (nonzero-based
device compaction), the d2h pull, build_walkers + h2d upload — to
locate any gap between the device walk and the engine's
seed_walk+pull stage."""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from megapath.utils.compile_cache import use_compile_cache

    use_compile_cache()
    print(jax.devices())

    import bench
    from megapath.align.params import MmpParams
    from megapath.align import seeding_jax as sj

    ref, fm, reads1, lens1, reads2, lens2 = bench.build_workload()
    dfm = sj.DeviceFM.from_host(fm)
    allr = np.concatenate([reads1, reads2])
    all_lens = np.concatenate([lens1, lens2]).astype(np.int32)

    def timed(fn, reps=5):
        fn()
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            fn()
            best = min(best, time.time() - t0)
        return best

    mmp = MmpParams()
    Nb = 40960
    L = allr.shape[1]
    max_seeds = int(min(16, max(4, L // 16 + 2)))

    # full seed output once, reused below
    w, wl = sj.build_walkers(jnp.asarray(allr), jnp.asarray(all_lens))
    out, _ = sj.device_mmp_seed(
        dfm, w, wl, mmp, max_seeds=max_seeds, max_steps=3 * L + 64
    )
    jax.device_get(out.n_seeds.sum())

    def walk_only():
        o, _ = sj.device_mmp_seed(
            dfm, w, wl, mmp, max_seeds=max_seeds, max_steps=3 * L + 64
        )
        jax.device_get(o.n_seeds.sum())
        return o

    print(f"walk+scalar sync      : {timed(walk_only):.3f}s")

    def h2d_build():
        wx, _ = sj.build_walkers(jnp.asarray(allr), jnp.asarray(all_lens))
        jax.device_get(wx[0, 0])

    print(f"h2d + build_walkers   : {timed(h2d_build):.3f}s")

    def flatten_only():
        fl = sj.flatten_seeds(out, Nb)
        jax.device_get(fl[0])

    print(f"flatten (nonzero) disp: {timed(flatten_only):.3f}s")

    def flatten_pull():
        fl = sj.flatten_seeds(out, Nb)
        jax.device_get(fl)

    print(f"flatten + full pull   : {timed(flatten_pull):.3f}s")

    def raw_pull():
        jax.device_get(
            (out.n_seeds, out.offset, out.length, out.sa_lo, out.sa_count)
        )

    print(f"raw 2-D pull          : {timed(raw_pull):.3f}s")

    def walk_flatten_pull():
        o, _ = sj.device_mmp_seed(
            dfm, w, wl, mmp, max_seeds=max_seeds, max_steps=3 * L + 64
        )
        fl = sj.flatten_seeds(o, Nb)
        jax.device_get(fl)

    print(f"walk+flatten+pull     : {timed(walk_flatten_pull):.3f}s")


if __name__ == "__main__":
    main()
