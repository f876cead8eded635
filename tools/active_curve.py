#!/usr/bin/env python
"""Active-walker counts vs lockstep step on the large bench shard:
the data behind _seed_seg_plan's compaction schedule. Each max_steps
value is its own compiled program (persistent cache makes reruns
cheap)."""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> None:
    import jax

    from megapath.utils.compile_cache import use_compile_cache

    use_compile_cache()

    from megapath.align.params import AlignParams
    from megapath.align.seeding_jax import (
        DeviceFM, build_walkers, device_mmp_seed,
    )

    if os.environ.get("TOY"):
        # the toy bench shard (cache-resident, CLASSIC walk mode)
        import bench

        ref, fm, r1, l1, r2, l2 = bench.build_workload()
    else:
        from tools.build_bench_shard import build

        ref, fm, r1, l1, r2, l2 = build()
    dfm = DeviceFM.from_host(fm)
    print(f"blk={dfm.blk}", file=sys.stderr)
    L = r1.shape[1]
    n = len(l1)
    allr = np.concatenate([r1, r2])
    all_lens = np.concatenate([l1, l2]).astype(np.int32)
    walkers, wlens = build_walkers(allr, all_lens)
    mmp = AlignParams().mmp
    max_seeds = int(min(16, max(4, L // 16 + 2)))
    W = 4 * n
    for steps in (80, 110, 140, 170, 200, 230, 280, 340):
        t = time.time()
        _, st = device_mmp_seed(
            dfm, walkers, wlens, mmp, max_seeds=max_seeds,
            max_steps=steps, finalize=False,
            two_phase=(dfm.blk < 128),
        )
        act = int(jax.device_get(st.active.sum()))
        print(
            f"step {steps:4d} ({steps/L:.2f}L): active {act:6d} "
            f"({act/W*100:5.1f}%)  [{time.time()-t:.1f}s]"
        )


if __name__ == "__main__":
    main()
