#!/usr/bin/env python
"""Ablate the seeding-walk body: synthetic loop bodies with the same
shapes as device_mmp_seed's hot loop, adding one component at a time.
Identifies where a walk step's time (80k walkers) goes:
occ-row gather, LUT gather, packed-word one-hot fetch, SWAR popcount,
emit-buffer writes, or scalar state updates."""

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
    Wn = 80000
    L = 100
    W16 = (L + 15) // 16 + 1
    S = 8
    # bench-like fused table: n/256 rows of (4 + 16) uint32
    n_blocks = 1_500_000  # ~120 MB: HBM-resident like the real index
    fused = jnp.asarray(
        rng.integers(0, 2**31, (n_blocks, 20)).astype(np.uint32)
    )
    lut = jnp.asarray(
        rng.integers(0, 2**31, (65536, 2)).astype(np.uint32)
    )
    packed = jnp.asarray(
        rng.integers(0, 2**31, (Wn, W16)).astype(np.uint32)
    )
    cols16 = jnp.arange(W16, dtype=jnp.int32)[None, :]

    STEPS = 128

    def timed(fn, reps=3):
        fn()
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            fn()
            best = min(best, time.time() - t0)
        return best

    def loop(body, init):
        @jax.jit
        def go(init):
            return jax.lax.fori_loop(0, STEPS, body, init)

        def run():
            out = go(init)
            leaf = jax.tree_util.tree_leaves(out)[0]
            jax.device_get(leaf.reshape(-1)[0])

        return timed(run)

    # A: state-only elementwise churn (12 int32 vectors)
    st0 = tuple(
        jnp.asarray(rng.integers(0, 1000, Wn).astype(np.int32))
        for _ in range(12)
    )

    def body_state(i, st):
        a = st[0] + st[1]
        b = jnp.where(a > st[2], st[3], st[4] + 1)
        return (b,) + st[1:]

    print(f"A state-only        : {loop(body_state, st0)/STEPS*1e3:.3f} ms/step")

    # B: + occ-row gather (2*Wn rows from the HBM fused table)
    def body_occ(i, st):
        idx = (st[0] * 7919 + i) % n_blocks
        idx2 = (st[1] * 104729 + i) % n_blocks
        rows = jnp.take(fused, jnp.concatenate([idx, idx2]), axis=0)
        s = rows.astype(jnp.int32).sum(axis=1)
        return (st[0] + s[:Wn] % 3, st[1] + s[Wn:] % 3) + st[2:]

    print(f"B +occ gather       : {loop(body_occ, st0)/STEPS*1e3:.3f} ms/step")

    # C: + SWAR popcount over the 16 packed words of each row
    def body_swar(i, st):
        idx = (st[0] * 7919 + i) % n_blocks
        idx2 = (st[1] * 104729 + i) % n_blocks
        rows = jnp.take(fused, jnp.concatenate([idx, idx2]), axis=0)
        w = rows[:, 4:]
        c = (st[2] % 4).astype(jnp.uint32)
        pat = jnp.concatenate([c, c])[:, None] * jnp.uint32(0x55555555)
        x = ~(w ^ pat)
        m = x & (x >> jnp.uint32(1)) & jnp.uint32(0x55555555)
        cnt = jax.lax.population_count(m).astype(jnp.int32).sum(axis=1)
        return (st[0] + cnt[:Wn] % 3, st[1] + cnt[Wn:] % 3) + st[2:]

    print(f"C +swar popcount    : {loop(body_swar, st0)/STEPS*1e3:.3f} ms/step")

    # D: + packed-word one-hot fetch (3 words per walker)
    def body_words(i, st):
        idx = (st[0] * 7919 + i) % n_blocks
        idx2 = (st[1] * 104729 + i) % n_blocks
        rows = jnp.take(fused, jnp.concatenate([idx, idx2]), axis=0)
        w = rows[:, 4:]
        c = (st[2] % 4).astype(jnp.uint32)
        pat = jnp.concatenate([c, c])[:, None] * jnp.uint32(0x55555555)
        x = ~(w ^ pat)
        m = x & (x >> jnp.uint32(1)) & jnp.uint32(0x55555555)
        cnt = jax.lax.population_count(m).astype(jnp.int32).sum(axis=1)
        j = jnp.clip((st[3] + i) % L, 0, L - 1)
        tri = jnp.stack([j >> 4, j >> 4, (j >> 4) + 1], axis=1)
        hit = cols16[:, None, :] == tri[:, :, None]
        w3 = jnp.sum(
            jnp.where(hit, packed[:, None, :], jnp.uint32(0)), axis=2
        ).astype(jnp.int32)
        return (
            st[0] + cnt[:Wn] % 3 + w3[:, 0] % 2,
            st[1] + cnt[Wn:] % 3,
        ) + st[2:]

    print(f"D +word one-hot     : {loop(body_words, st0)/STEPS*1e3:.3f} ms/step")

    # E: + LUT gather + emit-buffer where-writes
    buf0 = (
        jnp.zeros((Wn, S), jnp.int32),
        jnp.zeros((Wn, S), jnp.int32),
    )
    slot_cols = jnp.arange(S, dtype=jnp.int32)[None, :]

    def body_full(i, st_and_buf):
        st, bufs = st_and_buf
        idx = (st[0] * 7919 + i) % n_blocks
        idx2 = (st[1] * 104729 + i) % n_blocks
        rows = jnp.take(fused, jnp.concatenate([idx, idx2]), axis=0)
        w = rows[:, 4:]
        c = (st[2] % 4).astype(jnp.uint32)
        pat = jnp.concatenate([c, c])[:, None] * jnp.uint32(0x55555555)
        x = ~(w ^ pat)
        m = x & (x >> jnp.uint32(1)) & jnp.uint32(0x55555555)
        cnt = jax.lax.population_count(m).astype(jnp.int32).sum(axis=1)
        j = jnp.clip((st[3] + i) % L, 0, L - 1)
        tri = jnp.stack([j >> 4, j >> 4, (j >> 4) + 1], axis=1)
        hit = cols16[:, None, :] == tri[:, :, None]
        w3 = jnp.sum(
            jnp.where(hit, packed[:, None, :], jnp.uint32(0)), axis=2
        ).astype(jnp.int32)
        lv = jnp.take(lut, (st[4] % 65536), axis=0).astype(jnp.int32)
        sel = (slot_cols == (st[5] % S)[:, None]) & ((cnt[:Wn] % 7) == 0)[:, None]
        b0 = jnp.where(sel, w3[:, 0:1], bufs[0])
        b1 = jnp.where(sel, lv[:, 0:1], bufs[1])
        return (
            (
                st[0] + cnt[:Wn] % 3 + w3[:, 0] % 2,
                st[1] + cnt[Wn:] % 3 + lv[:, 1] % 2,
            ) + st[2:],
            (b0, b1),
        )

    print(f"E full-ish          : {loop(body_full, (st0, buf0))/STEPS*1e3:.3f} ms/step")


if __name__ == "__main__":
    main()
