#!/usr/bin/env python
"""Measure the seeding walk's gather cost model on real hardware.

Questions the paired-row experiment raised (r4): is the per-step occ
gather cost per ROW or per BYTE, and does redirecting duplicate
indices to one hot row make those fetches cheap? Variants, all over an
HBM-resident table shaped like the 512 Mbp shard's:

  A  2 random row gathers/walker, 12-col rows (the r3 layout)
  B  1 random + 1 constant(row 0) gather/walker, 12-col rows
  C  1 random gather/walker only, 12-col rows (lower bound)
  D  2 random row gathers/walker, 20-col rows (the paired layout)
  E  2 random gathers but the second = first index (dup, same row)

Sync: device_get of a scalar."""

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
    Wn = 80_000
    STEPS = 128
    n_rows = 4_000_000  # 512 Mbp / 128 = 4M occ rows

    def mktable(cols):
        return jnp.asarray(
            rng.integers(0, 2**31, (n_rows, cols)).astype(np.uint32)
        )

    t12 = mktable(12)
    t20 = mktable(20)
    st0 = tuple(
        jnp.asarray(rng.integers(0, 1000, Wn).astype(np.int32))
        for _ in range(4)
    )

    def timed(fn, reps=3):
        fn()
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            fn()
            best = min(best, time.time() - t0)
        return best

    def loop(body, table):
        # table rides as a jit ARGUMENT (a closure constant would be
        # inlined into the HLO and blow the remote-compile payload)
        @jax.jit
        def go(table, init):
            def wrapped(i, st):
                return body(i, st, table)

            return jax.lax.fori_loop(0, STEPS, wrapped, init)

        def run():
            out = go(table, st0)
            jax.device_get(jax.tree_util.tree_leaves(out)[0][0])

        return timed(run)

    def var(tag, table, second):
        def body(i, st, table):
            idx = (st[0] * 7919 + i) % n_rows
            if second == "random":
                idx2 = (st[1] * 104729 + i) % n_rows
            elif second == "zero":
                idx2 = jnp.zeros_like(idx)
            elif second == "dup":
                idx2 = idx
            else:
                idx2 = None
            if idx2 is None:
                rows = jnp.take(table, idx, axis=0)
                s = rows.astype(jnp.int32).sum(axis=1)
                return (st[0] + s % 3,) + st[1:]
            rows = jnp.take(
                table, jnp.concatenate([idx, idx2]), axis=0
            )
            s = rows.astype(jnp.int32).sum(axis=1)
            return (st[0] + s[:Wn] % 3, st[1] + s[Wn:] % 3) + st[2:]

        dt = loop(body, table)
        per = dt / STEPS / Wn * 1e9
        print(f"{tag:40s}: {dt/STEPS*1e3:7.3f} ms/step  {per:6.2f} ns/walker/step")

    var("A 2 random, 12-col", t12, "random")
    var("B 1 random + 1 const0, 12-col", t12, "zero")
    var("C 1 random only, 12-col", t12, "none")
    var("D 2 random, 20-col", t20, "random")
    var("E 2 dup-index, 12-col", t12, "dup")


if __name__ == "__main__":
    main()
