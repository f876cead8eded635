#!/usr/bin/env python
"""Per-stage wall-clock of the spmd_full one-program engine on the
512 Mbp bench shard (mesh 1x1, production Bl) via the ``stage_stop``
probe builds: each k compiles the program truncated after stage k with
a live checksum, so timing differences attribute cost per stage.

Sync = jax.device_get of the output.

Env:
  LEAN=1             use parallel.spmd_full.LEAN_CAPS
  FAST=1             fast walk compaction plan (matching-heavy)
  STAGES="1,2,5,0"   stages to run (default all; 0 = full program)
  BL=20480           local pair count
  PASSES=2           timed passes per stage (best-of)
  CAPS="pos=16,cand=8,se=4,hit=6,dp=4,rescue=2"  SpmdCaps override
  SEG=1              use the staged walk (once implemented)
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def log(m):
    print(f"[spmd-probe] {m}", file=sys.stderr, flush=True)


def main() -> None:
    import jax

    from megapath.utils.compile_cache import use_compile_cache

    use_compile_cache()
    from jax.sharding import Mesh

    from tools.build_bench_shard import build
    from megapath.align.params import AlignParams
    from megapath.parallel.spmd_full import (
        SpmdCaps,
        build_spmd_full_engine,
        pad_ref_codes,
        pad_seq_offsets,
        place_spmd_full_inputs,
        stack_fms_exact,
    )

    ref, fm, r1, l1, r2, l2 = build()
    Bl = int(os.environ.get("BL", "20480"))
    passes = int(os.environ.get("PASSES", "2"))
    L = r1.shape[1]

    caps = SpmdCaps()
    if os.environ.get("LEAN"):
        from megapath.parallel.spmd_full import LEAN_CAPS

        caps = LEAN_CAPS
    if os.environ.get("CAPS"):
        kv = dict(
            (p.split("=")[0], float(p.split("=")[1]))
            for p in os.environ["CAPS"].split(",")
        )
        caps = SpmdCaps(
            pos_factor=kv.get("pos", caps.pos_factor),
            cand_factor=kv.get("cand", caps.cand_factor),
            se_factor=kv.get("se", caps.se_factor),
            hit_factor=kv.get("hit", caps.hit_factor),
            dp_factor=kv.get("dp", caps.dp_factor),
            rescue_factor=kv.get("rescue", caps.rescue_factor),
        )
    log(f"caps: {caps}")

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "shard"))
    sfm, meta = stack_fms_exact([fm])
    ref_codes = pad_ref_codes([ref.codes])
    seq_off = pad_seq_offsets([ref.offsets])
    sfm, ref_dev, off_dev = place_spmd_full_inputs(
        mesh, sfm, ref_codes, seq_off
    )

    def pad2(a):
        out = np.zeros((Bl, a.shape[1]), np.uint8)
        out[: min(len(a), Bl)] = a[:Bl]
        return out

    def pad1(a):
        out = np.zeros(Bl, np.int32)
        out[: min(len(a), Bl)] = a[:Bl]
        return out

    rr1, rr2, ll1, ll2 = pad2(r1), pad2(r2), pad1(l1), pad1(l2)
    params = AlignParams()

    stages = [
        int(s)
        for s in os.environ.get("STAGES", "1,2,3,4,5,6,7,0").split(",")
    ]
    names = {
        1: "walk", 2: "+locate", 3: "+cluster", 4: "+pair", 5: "+deepDP",
        6: "+SE", 7: "+rescue", 0: "FULL",
    }
    prev = 0.0
    for k in stages:
        step = build_spmd_full_engine(
            mesh, meta, L, params=params, caps=caps, stage_stop=k,
            plan_fast=bool(os.environ.get("FAST")),
        )
        t = time.time()
        out = step(sfm, ref_dev, off_dev, rr1, rr2, ll1, ll2)
        tok = jax.device_get(out.overflow)
        log(f"stage {names[k]}: compile+first {time.time()-t:.1f}s "
            f"(tok {int(tok.ravel()[0])})")
        best = 1e9
        for _ in range(passes):
            t = time.time()
            out = step(sfm, ref_dev, off_dev, rr1, rr2, ll1, ll2)
            tok = jax.device_get(out.overflow)
            best = min(best, time.time() - t)
        delta = "" if k == 0 else f"  (delta {best - prev:+.2f}s)"
        log(f"stage {names[k]}: {best:.2f}s{delta}")
        if k != 0:
            prev = best


if __name__ == "__main__":
    main()
