#!/usr/bin/env python
"""Stage timing of the bench pipeline leg (run_records) on the device.

Usage: python tools/profile_pipeline.py [n_passes]
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
    from megapath.utils.compile_cache import use_compile_cache

    use_compile_cache()

    import bench
    from megapath.io.fastq import FastqRecord
    from megapath.pipeline.megapath import MegaPathPipeline, PipelineConfig

    ref, fm, reads1, lens1, reads2, lens2 = bench.build_workload()
    decode = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = "I" * bench.READ_LEN
    recs1 = [
        FastqRecord(f"rd{i:06d}", decode[reads1[i]].tobytes().decode(), qual)
        for i in range(bench.N_PAIRS)
    ]
    recs2 = [
        FastqRecord(f"rd{i:06d}", decode[reads2[i]].tobytes().decode(), qual)
        for i in range(bench.N_PAIRS)
    ]
    pipe = MegaPathPipeline(
        [(ref, fm)], bench._bench_taxdb(ref),
        config=PipelineConfig(
            read_len=bench.READ_LEN, skip_human=True, device_seeding=True,
            max_read_len=bench.READ_LEN,
        ),
    )

    times = defaultdict(float)

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t = time.time()
            out = fn(*a, **k)
            times[label] += time.time() - t
            return out

        setattr(obj, name, timed)

    wrap(pipe, "_filter_batch", "filter(bbduk+pack)")
    wrap(pipe, "_align_shards", "align")
    wrap(pipe, "_spike_banned", "spike")
    wrap(pipe, "_merge_arrays", "merge")
    wrap(pipe, "_tail", "tail(reassign+reports)")
    wrap(pipe, "_finish_records", "finish_total")

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    print("[pp] warmup", file=sys.stderr, flush=True)
    pipe.run_records(recs1, recs2)
    for i in range(n):
        times.clear()
        t = time.time()
        res = pipe.run_records(recs1, recs2)
        dt = time.time() - t
        print(f"pass {i}: {dt:.3f}s ({2*bench.N_PAIRS/dt:.0f} reads/s)")
        acc = 0.0
        for k in sorted(times, key=lambda k: -times[k]):
            print(f"    {k:24s} {times[k]:7.3f}s")
        inner = sum(v for k, v in times.items() if k != "finish_total")
        print(f"    (untimed: {dt - inner:.3f}s)")


if __name__ == "__main__":
    main()
