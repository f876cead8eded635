#!/usr/bin/env python
"""Probe: where does a seeding-walk step's time go?

Measures device_mmp_seed under (a) the stock while_loop cond
(any(active) & step<limit), (b) a step-only cond, (c) a fori_loop body
with no cond at all, across step limits and walker widths. If (c) is
much cheaper per step, the while_loop cond forces a host/device sync
per iteration on this backend and the walk should switch to segmented
fixed-trip loops.
"""

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
    w_full, wl_full = sj.build_walkers(
        jnp.asarray(allr), jnp.asarray(all_lens)
    )
    w_full = jax.block_until_ready(w_full)
    mmp = MmpParams()

    def timed(fn, reps=5):
        fn()  # warm
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            fn()
            best = min(best, time.time() - t0)
        return best

    def run_while(w, wl, ms):
        out, st = sj.device_mmp_seed(
            dfm, w, wl, mmp, max_seeds=8, max_steps=ms
        )
        # a device_get of a scalar waits for the whole walk
        jax.device_get(out.n_seeds.sum())
        return out, st

    print("[walk] stock while_loop, full width")
    for ms in (128, 192, 256, 364, 517):
        dt = timed(lambda: run_while(w_full, wl_full, ms))
        print(f"  ms={ms:4d}: {dt:.3f}s")

    for wn in (20480, 40960):
        w = w_full[:wn]
        wl = wl_full[:wn]
        print(f"[walk] stock while_loop, Wn={wn}")
        for ms in (192, 364):
            dt = timed(lambda: run_while(w, wl, ms))
            print(f"  ms={ms:4d}: {dt:.3f}s")

    # fixed-trip variant: monkeypatch lax.while_loop -> fori_loop (the
    # body masks dead rows, so extra steps are semantically no-ops).
    # Fresh max_steps values force a retrace under the patch.
    import jax.lax as lax

    orig_while = lax.while_loop
    box = {"n": 0}

    def fori_while(cond, body, init):
        return lax.fori_loop(0, box["n"], lambda i, s: body(s), init)

    lax.while_loop = fori_while
    try:
        print("[walk] fori_loop (fixed trip), full width")
        for ms in (130, 194, 258, 366):
            box["n"] = ms
            dt = timed(lambda: run_while(w_full, wl_full, ms))
            print(f"  ms={ms:4d}: {dt:.3f}s")
    finally:
        lax.while_loop = orig_while


if __name__ == "__main__":
    main()
