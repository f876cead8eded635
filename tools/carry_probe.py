#!/usr/bin/env python
"""Probe: fori_loop per-step cost vs carried-buffer count and size.
If cost scales with the NUMBER of carried buffers (not bytes), the
walk state should be packed into fewer, wider arrays."""

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

    rng = np.random.default_rng(0)
    STEPS = 128

    def timed(fn, reps=3):
        fn()
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            fn()
            best = min(best, time.time() - t0)
        return best

    def probe(k_bufs, n, touch_all):
        st0 = tuple(
            jnp.asarray(rng.integers(0, 1000, n).astype(np.int32))
            for _ in range(k_bufs)
        )

        @jax.jit
        def go(st):
            def body(i, st):
                if touch_all:
                    return tuple(s + i for s in st)
                a = st[0] + i
                return (a,) + st[1:]

            return jax.lax.fori_loop(0, STEPS, body, st)

        def run():
            out = go(st0)
            jax.device_get(out[0].reshape(-1)[0])

        dt = timed(run) / STEPS * 1e3
        print(
            f"  k={k_bufs:2d} n={n:7d} touch_all={touch_all}: "
            f"{dt:.4f} ms/step"
        )

    print("[carry] vary buffer count (n=80000, touch one)")
    for k in (1, 2, 4, 8, 12, 16):
        probe(k, 80000, False)
    print("[carry] vary buffer count (n=80000, touch all)")
    for k in (1, 4, 12):
        probe(k, 80000, True)
    print("[carry] vary size (k=12, touch one)")
    for n in (8192, 20480, 320000):
        probe(12, n, False)
    print("[carry] 2-D carried buffer (k=2 incl (80000,8), touch both)")
    big = jnp.zeros((80000, 8), jnp.int32)
    v = jnp.asarray(rng.integers(0, 1000, 80000).astype(np.int32))

    @jax.jit
    def go2(st):
        def body(i, st):
            buf, x = st
            sel = (jnp.arange(8)[None, :] == (x % 8)[:, None])
            return (jnp.where(sel, i, buf), x + 1)

        return jax.lax.fori_loop(0, STEPS, body, st)

    def run2():
        out = go2((big, v))
        jax.device_get(out[1].reshape(-1)[0])

    print(f"  2d-buf: {timed(run2)/STEPS*1e3:.4f} ms/step")


if __name__ == "__main__":
    main()
