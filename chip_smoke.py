#!/usr/bin/env python
"""Run the MegaPath cascade end to end on one GPU and check its output.

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: the multi-card runs only

1. Device: the GPU, the JAX version, the card's name and power limit,
   the compile cache and the four native host libraries.
2. DP at real widths: the deep-DP program (forward + start-finding
   reverse pass) and the BLOSUM62 DP run on the GPU and on the host CPU
   in this process and must agree exactly (the DP is int32 throughout,
   so no floating-point tolerance applies); a few rows are also checked
   against the scalar oracle.
3. Main path: a world generated from --seed (two NT shards, a host
   shard, a taxonomy, adapters, paired 150-bp reads) is indexed by the
   code ``cli build-index`` runs and classified twice by ``cli run``;
   the reports are checked against what was planted. The first 4,000
   pairs then run again on the GPU and on the CPU device and must give
   byte-identical reports.
4. Deep-DP share: the deep-DP calls of one NT-shard alignment pass are
   timed (ending in ``block_until_ready``) against the whole pass.

With ``--four-cards`` only the multi-card cascade runs: ``cli run
--devices 4`` (per-shard engines on their own cards) and ``cli run
--devices 4 --spmd`` (one (data x shard) mesh program) must match the
single-card cascade byte for byte.

Every phase prints its lines as it goes; timings are a smoke run's,
printed beside the card's name and power limit, not a benchmark. The
script exits non-zero, without a result line, when JAX finds no GPU or
any check fails. Its last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(HERE, "bench_cache", "smoke")

# TruSeq adapter read-through (bbduk's adapters.fa holds these)
ADAPTERS = (
    "AGATCGGAAGAGCACACGTCTGAACTCCAGTCACATCACGATCTCGTATGCCGTCTTCTGCTTG",
    "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGTAGATCTCGGTGGTCGCCGTATCATTAAAAAA",
)


@dataclass(frozen=True)
class World:
    """Sizes of one generated world. Every shard's sequences have equal
    length; one species per NT sequence."""

    nt_shards: Tuple[Tuple[int, int], ...] = (
        (4, 64_000_000),  # 256 Mbp: tables above the paired-layout switch
        (2, 4_000_000),  # 8 Mbp: cache-resident classic layout
    )
    host: Tuple[int, int] = (2, 32_000_000)  # 64 Mbp host genome
    pairs: int = 200_000
    read_len: int = 150
    insert: int = 350
    # pair mix: fraction per NT shard, host, junk (sums to 1)
    shard_frac: Tuple[float, ...] = (0.65, 0.10)
    host_frac: float = 0.15
    readthrough_frac: float = 0.05  # of all pairs, drawn from NT pairs
    cpu_pairs: int = 4_000


SMOKE_WORLD = World()
# four shards above the paired-layout switch (~89 Mbp). The pair count
# is kept small because the --spmd backend's exact rescue seeds the
# rescued pairs on the host (numpy), and on each shard most pairs of a
# cascade are rescued.
FOUR_CARD_WORLD = World(
    nt_shards=((1, 96_000_000),) * 4,
    host=(0, 0),
    pairs=4_000,
    shard_frac=(0.25,) * 4,
    host_frac=0.0,
    readthrough_frac=0.0,
    cpu_pairs=0,
)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def native_libraries() -> Dict[str, bool]:
    """Build (first use) and load the four host libraries."""
    from megapath.native import build

    return {
        "saais": build.load_saais() is not None,
        "fastq": build.load_fastq_lib() is not None,
        "bbduk": build.load_bbduk_lib() is not None,
        "spike": build.load_spike_lib() is not None,
    }


def phase_device(n_cards: int) -> Tuple[list, str]:
    import jax

    from megapath.utils.compile_cache import use_compile_cache
    from megapath.utils.gpu import card_name_and_power, require_gpu

    devs = require_gpu(n_cards)
    cache = use_compile_cache()
    card = card_name_and_power()
    log(f"[device] {devs[0].device_kind} x {len(jax.devices())}, "
        f"jax {jax.__version__}")
    log(f"[device] card: {card}")
    log(f"[device] compile cache: {cache}")
    libs = native_libraries()
    log("[device] native libraries: "
        + " ".join(f"{k}={'ok' if v else 'MISSING'}" for k, v in libs.items()))
    missing = [k for k, v in libs.items() if not v]
    if missing:
        raise SystemExit(f"native libraries failed to build/load: {missing}")
    return devs, card


# ---------------------------------------------------------------------------
# phase 2: DP at real widths, GPU vs host CPU
# ---------------------------------------------------------------------------


def _dp_inputs(rng, C: int, L: int, W: int, alphabet: int = 4):
    """Half the rows hold the read inside the window with substitutions
    and one indel; the rest are unrelated. Lengths vary per row."""
    import numpy as np

    reads = rng.integers(0, alphabet, (C, L)).astype(np.uint8)
    wins = rng.integers(0, alphabet, (C, W)).astype(np.uint8)
    read_lens = rng.integers(L * 2 // 3, L + 1, C).astype(np.int32)
    win_lens = rng.integers(W * 3 // 4, W + 1, C).astype(np.int32)
    for c in range(0, C, 2):
        off = int(rng.integers(0, W - L))
        src = reads[c].copy()
        k = int(rng.integers(10, L - 10))
        if c % 4 == 0:  # deletion from the read
            body = np.concatenate([src[:k], src[k + 3:]])
        else:  # insertion into the read
            body = np.concatenate([src[:k], src[k:k + 2], src[k:]])
        body = body[: W - off]
        wins[c, off: off + len(body)] = body
        mut = rng.random(len(body)) < 0.02
        wins[c, off: off + len(body)][mut] = (
            wins[c, off: off + len(body)][mut] + 1
        ) % alphabet
    return reads, wins, read_lens, win_lens


def phase_dp(gpu, C: int = 8192, seed: int = 0) -> None:
    import jax
    import numpy as np

    from megapath.align.device import _align_with_starts_wins
    from megapath.align.engine import dp_window_width
    from megapath.classify.protein import N_AA
    from megapath.ops.dp import DPParams, sw_align_oracle, sw_align_protein

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(seed)
    L = 150
    W = dp_window_width(L)
    params = DPParams()
    fn = jax.jit(_align_with_starts_wins, static_argnames=("width", "params"))
    args = _dp_inputs(rng, C, L, W)
    outs = []
    for dev in (gpu, cpu):
        placed = [jax.device_put(a, dev) for a in args]
        t = time.time()
        out = jax.block_until_ready(fn(*placed, width=W, params=params))
        outs.append((jax.device_get(out), time.time() - t, dev.platform))
    (g, tg, _), (c, tc, _) = outs
    for name in ("score", "start_ref", "end_ref", "end_read", "start_read"):
        if not np.array_equal(getattr(g, name), getattr(c, name)):
            bad = int((getattr(g, name) != getattr(c, name)).sum())
            raise SystemExit(f"[dp] {name} differs GPU vs CPU on {bad} rows")
    reads, wins, read_lens, win_lens = args
    for b in range(0, C, C // 8):
        exp = sw_align_oracle(reads[b, : read_lens[b]], wins[b, : win_lens[b]])
        got = (int(g.score[b]), int(g.end_ref[b]), int(g.end_read[b]))
        if got != exp:
            raise SystemExit(f"[dp] row {b}: device {got} != oracle {exp}")
    log(f"[dp] deep-DP {C}x{L} reads, window {W}: GPU == CPU exactly "
        f"(int32, no tolerance), oracle rows ok; first call incl. compile "
        f"GPU {tg:.2f}s CPU {tc:.2f}s; mean score "
        f"{float(g.score.mean()):.2f}")

    QL, WL = 50, 128  # 150-bp read frame -> 50 aa, window = query + pads
    pargs = _dp_inputs(rng, C, QL, WL, alphabet=N_AA)
    pouts = []
    for dev in (gpu, cpu):
        placed = [jax.device_put(a, dev) for a in pargs]
        with jax.default_device(dev):
            out = sw_align_protein(*placed)
        pouts.append(jax.device_get(out))
    for name in ("score", "end_ref", "end_read"):
        if not np.array_equal(getattr(pouts[0], name), getattr(pouts[1], name)):
            raise SystemExit(f"[dp] protein {name} differs GPU vs CPU")
    log(f"[dp] BLOSUM62 DP {C}x{QL} aa, window {WL} (s32 one-hot "
        f"einsum): GPU == CPU exactly; mean score "
        f"{float(pouts[0].score.mean()):.2f}")


# ---------------------------------------------------------------------------
# phase 3: the main path through the CLI
# ---------------------------------------------------------------------------

_ACGT = b"ACGT"


def _write_fasta(path: str, names: Sequence[str], seqs) -> None:
    import numpy as np

    lut = np.frombuffer(_ACGT, np.uint8)
    with open(path, "wb") as f:
        for name, codes in zip(names, seqs):
            f.write(b">" + name.encode() + b"\n")
            f.write(lut[codes].tobytes())
            f.write(b"\n")


def _write_fastq(path: str, names: Sequence[str], codes, lens) -> None:
    import numpy as np

    lut = np.frombuffer(_ACGT, np.uint8)
    text = lut[codes]
    parts: List[bytes] = []
    for i, name in enumerate(names):
        n = int(lens[i])
        parts.append(b"@" + name.encode() + b"\n" + text[i, :n].tobytes()
                     + b"\n+\n" + b"I" * n + b"\n")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def _sample_pairs(rng, genome, n: int, L: int, insert: int, adapters,
                  readthrough):
    """Paired reads from one shard's (n_seq, seq_len) code array, about
    one substitution per read, either strand; pairs flagged in
    ``readthrough`` get inserts shorter than the read, so the read runs
    on into the adapter. Returns (read1, read2, sequence index)."""
    import numpy as np

    seq_len = genome.shape[1]
    n_seq = genome.shape[0]
    seq = rng.integers(0, n_seq, n)
    ins = np.clip(rng.normal(insert, 30, n).astype(np.int64), L + 20, 3 * L)
    ins[readthrough] = rng.integers(95, L - 9, int(readthrough.sum()))
    pos = (rng.random(n) * (seq_len - ins)).astype(np.int64)
    j = np.arange(L)[None, :]
    inside = j < ins[:, None]
    src1 = np.minimum(pos[:, None] + j, seq_len - 1)
    src2 = np.clip(pos[:, None] + ins[:, None] - 1 - j, 0, seq_len - 1)
    r1 = genome[seq[:, None], src1]
    r2 = 3 - genome[seq[:, None], src2]
    mut = (rng.random((n, L)) < 1.0 / L) & inside
    r1 = np.where(mut, (r1 + rng.integers(1, 4, (n, L))) % 4, r1)
    mut = (rng.random((n, L)) < 1.0 / L) & inside
    r2 = np.where(mut, (r2 + rng.integers(1, 4, (n, L))) % 4, r2)
    a1, a2 = adapters
    k = np.clip(j - ins[:, None], 0, None)
    r1 = np.where(inside, r1, a1[np.minimum(k, len(a1) - 1)])
    r2 = np.where(inside, r2, a2[np.minimum(k, len(a2) - 1)])
    flip = rng.random(n) < 0.5  # fragment from the reverse strand
    r1, r2 = np.where(flip[:, None], r2, r1), np.where(flip[:, None], r1, r2)
    return r1.astype(np.uint8), r2.astype(np.uint8), seq


def make_world(world: World, workdir: str, seed: int) -> dict:
    """FASTA per shard, taxonomy, adapters and paired FASTQ, all from
    ``seed``. Returns paths plus what was planted."""
    import numpy as np

    from megapath.index.pack import encode_seq

    rng = np.random.default_rng(seed)
    os.makedirs(workdir, exist_ok=True)
    L = world.read_len
    adapters = tuple(encode_seq(a) for a in ADAPTERS)
    shards = []
    species = []  # (shard, seq index, taxid, name)
    for s, (n_seq, seq_len) in enumerate(world.nt_shards):
        text = rng.integers(0, 4, (n_seq, seq_len), dtype=np.uint8)
        names = [f"nt{s}seq{i}" for i in range(n_seq)]
        fa = os.path.join(workdir, f"nt{s}.fa")
        _write_fasta(fa, names, text)
        shards.append((fa, text))
        for i, nm in enumerate(names):
            species.append((s, i, 100 + len(species), nm))
    host_fa, host_text = None, None
    if world.host[0]:
        host_text = rng.integers(0, 4, world.host, dtype=np.uint8)
        host_fa = os.path.join(workdir, "host.fa")
        _write_fasta(host_fa, [f"host{i}" for i in range(world.host[0])],
                     host_text)

    with open(os.path.join(workdir, "nodes.dmp"), "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\t\n2\t|\t1\t|\tsuperkingdom\t|\t\n")
        for _, _, tid, _ in species:
            f.write(f"{tid}\t|\t2\t|\tspecies\t|\t\n")
    with open(os.path.join(workdir, "names.dmp"), "w") as f:
        f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n"
                "2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
        for _, _, tid, nm in species:
            f.write(f"{tid}\t|\tSpecies {nm}\t|\t\t|\tscientific name\t|\n")
    with open(os.path.join(workdir, "acc2tid.map"), "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        for _, _, tid, nm in species:
            f.write(f"{nm}\t{nm}.1\t{tid}\t0\n")
    with open(os.path.join(workdir, "adapters.fa"), "w") as f:
        for i, a in enumerate(ADAPTERS):
            f.write(f">adapter{i}\n{a}\n")

    n = world.pairs
    counts = [int(round(fr * n)) for fr in world.shard_frac]
    n_host = int(round(world.host_frac * n))
    n_junk = n - sum(counts) - n_host
    n_nt = sum(counts)
    rt_all = np.zeros(n_nt, bool)
    rt_all[rng.choice(n_nt, int(round(world.readthrough_frac * n)),
                      replace=False)] = True
    parts1, parts2, planted = [], [], {}
    o = 0
    for s, ((fa, text), c) in enumerate(zip(shards, counts)):
        r1, r2, seq = _sample_pairs(
            rng, text, c, L, world.insert, adapters, rt_all[o: o + c]
        )
        o += c
        parts1.append(r1)
        parts2.append(r2)
        for sh, i, tid, _ in species:
            if sh == s:
                planted[tid] = int((seq == i).sum())
    if n_host:
        r1, r2, _ = _sample_pairs(
            rng, host_text, n_host, L, world.insert, adapters,
            np.zeros(n_host, bool),
        )
        parts1.append(r1)
        parts2.append(r2)
    if n_junk:
        parts1.append(rng.integers(0, 4, (n_junk, L), dtype=np.uint8))
        parts2.append(rng.integers(0, 4, (n_junk, L), dtype=np.uint8))
    r1 = np.concatenate(parts1)
    r2 = np.concatenate(parts2)
    order = rng.permutation(n)  # interleave the categories
    r1, r2 = r1[order], r2[order]
    names = [f"r{i:07d}" for i in range(n)]
    lens = np.full(n, L, np.int32)
    fq1 = os.path.join(workdir, "r1.fq")
    fq2 = os.path.join(workdir, "r2.fq")
    _write_fastq(fq1, [nm + "/1" for nm in names], r1, lens)
    _write_fastq(fq2, [nm + "/2" for nm in names], r2, lens)
    sub = None
    if world.cpu_pairs:
        sub = (os.path.join(workdir, "sub_r1.fq"),
               os.path.join(workdir, "sub_r2.fq"))
        k = world.cpu_pairs
        _write_fastq(sub[0], [nm + "/1" for nm in names[:k]], r1[:k], lens)
        _write_fastq(sub[1], [nm + "/2" for nm in names[:k]], r2[:k], lens)
    return {
        "nt_fasta": [fa for fa, _ in shards],
        "host_fasta": host_fa,
        "r1": fq1, "r2": fq2, "sub": sub,
        "nodes": os.path.join(workdir, "nodes.dmp"),
        "names": os.path.join(workdir, "names.dmp"),
        "acc2tid": os.path.join(workdir, "acc2tid.map"),
        "adapters": os.path.join(workdir, "adapters.fa"),
        "planted": planted,  # species taxid -> planted pairs
        "n_host": n_host, "n_junk": n_junk, "pairs": n,
    }


def _build_index(fasta: str, out_prefix: str) -> str:
    """What ``cli build-index FASTA OUT --lut-k 8`` runs (numpy and the
    native SA-IS only, no JAX): one shard, its prefix returned."""
    from megapath.index.shard import build_shard_indexes, split_fasta

    shards = split_fasta(fasta, out_prefix)
    build_shard_indexes(shards, os.path.dirname(out_prefix), lut_k=8)
    return os.path.join(os.path.dirname(out_prefix), "shard0")


def build_indexes(fastas: Sequence[str], workdir: str) -> List[str]:
    """Index every FASTA, in parallel worker processes that stay off
    JAX and the card."""
    import multiprocessing as mp

    outs = [os.path.join(workdir, f"idx{i}", "db")
            for i in range(len(fastas))]
    for o in outs:
        os.makedirs(os.path.dirname(o), exist_ok=True)
    ctx = mp.get_context("spawn")
    with ctx.Pool(len(fastas)) as pool:
        return pool.starmap(_build_index, zip(fastas, outs))


def run_cli(w: dict, nt: Sequence[str], host, prefix: str, r1: str, r2: str,
            extra: Sequence[str] = ()) -> float:
    from megapath import cli

    argv = ["run", "-1", r1, "-2", r2, "-p", prefix, "--nt-index", *nt,
            "--nodes", w["nodes"], "--names", w["names"],
            "--acc2tid", w["acc2tid"], "-L", "150", *extra]
    if host:
        argv += ["--hg-index", host, "--adapters", w["adapters"]]
    t = time.time()
    rc = cli.main(argv)
    if rc != 0:
        raise SystemExit(f"cli run exited {rc}")
    return time.time() - t


def read_outputs(prefix: str) -> Dict[str, bytes]:
    out = {}
    for ext in (".nt.report", ".nt.ra.report", ".nt.lsam.id"):
        with open(prefix + ext, "rb") as f:
            out[ext] = f.read()
    return out


def check_report(report: str, w: dict) -> str:
    """Planted species at their planted counts (each pair counts its two
    ends), host pairs removed, junk unclassified."""
    clade, uncl = {}, 0
    for line in report.splitlines()[1:]:
        cols = line.split("\t")
        if cols[3] == "U":
            uncl = int(cols[1])
        clade[int(cols[4])] = int(cols[1])
    total = uncl + clade.get(1, 0)
    expect_total = 2 * (w["pairs"] - w["n_host"])
    if total != expect_total:
        raise SystemExit(f"[main] report counts {total} read ends, expected "
                         f"{expect_total} (host pairs not all removed?)")
    worst = 1.0
    for tid, pairs in w["planted"].items():
        got = clade.get(tid, 0)
        ratio = got / max(2 * pairs, 1)
        worst = min(worst, ratio)
        # loss bound: ends whose best hit falls under the cutoff or ties
        # across species; the planted reads carry ~1 substitution each
        if not 0.99 <= ratio <= 1.0 + 1e-9:
            raise SystemExit(f"[main] species {tid}: {got} ends in report, "
                             f"planted {2 * pairs}")
    junk_ends = 2 * w["n_junk"]
    missing = sum(2 * p - clade.get(t, 0) for t, p in w["planted"].items())
    # junk classified somewhere lowers the unclassified count below the
    # junk; lost planted ends can raise it above
    if not junk_ends - max(2, junk_ends // 100) <= uncl <= junk_ends + missing:
        raise SystemExit(f"[main] {uncl} unclassified ends, {junk_ends} "
                         f"junk ends planted")
    return (f"{len(w['planted'])} species at >= {worst:.4f} of planted "
            f"ends, {uncl} unclassified ({junk_ends} junk ends)")


def _clean(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)


def phase_main(world: World = SMOKE_WORLD, workdir: str = WORK_DIR,
               seed: int = 0, card: str = "") -> dict:
    """Generate, index, run ``cli run`` twice, check, then the CPU
    comparison. Returns the timings and the state phase 4 needs."""
    import jax

    from megapath.align.engine import AlignEngine

    _clean(workdir)
    t0 = time.time()
    w = make_world(world, workdir, seed)
    t_gen = time.time() - t0
    idx = build_indexes(w["nt_fasta"] + [w["host_fasta"]], workdir)
    nt, host = idx[:-1], idx[-1]
    t_setup = time.time() - t0
    log(f"[main] set-up {t_setup:.1f}s (generate {t_gen:.1f}s, index "
        f"{t_setup - t_gen:.1f}s): {w['pairs']} pairs, NT shards "
        f"{[n * ln for n, ln in world.nt_shards]} bp, host "
        f"{world.host[0] * world.host[1]} bp")

    # record the first NT shard's alignment call of the warm run for
    # phase 4: (engine, args) of its first align_pairs
    seen: List[tuple] = []
    nt0_len = world.nt_shards[0][0] * world.nt_shards[0][1]
    orig = AlignEngine.align_pairs

    def recording(self, *args):
        if not seen and len(self.ref.codes) == nt0_len and self.dfm is not None:
            seen.append((self, args))
        return orig(self, *args)

    p1 = os.path.join(workdir, "run1")
    t_cold = run_cli(w, nt, host, p1, w["r1"], w["r2"])
    AlignEngine.align_pairs = recording
    try:
        p2 = os.path.join(workdir, "run2")
        t_warm = run_cli(w, nt, host, p2, w["r1"], w["r2"])
    finally:
        AlignEngine.align_pairs = orig
    o1, o2 = read_outputs(p1), read_outputs(p2)
    if o1 != o2:
        raise SystemExit("[main] two runs of the same input differ")
    verdict = check_report(o2[".nt.report"].decode(), w)
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not available")
    log(f"[main] cli run: first run (compiles) {t_cold:.1f}s, warm run "
        f"{t_warm:.1f}s = {2 * w['pairs'] / t_warm:.0f} reads/s (smoke "
        f"run, not a benchmark; {card}); peak device bytes {peak}")
    log(f"[main] report: {verdict}")

    if w["sub"]:
        k = world.cpu_pairs
        p3 = os.path.join(workdir, "sub_dev")
        p4 = os.path.join(workdir, "sub_cpu")
        t_dev = run_cli(w, nt, host, p3, *w["sub"])
        cpu = jax.devices("cpu")[0]
        jax.config.update("jax_default_device", cpu)
        try:
            t_cpu = run_cli(w, nt, host, p4, *w["sub"])
        finally:
            jax.config.update("jax_default_device", None)
        a, b = read_outputs(p3), read_outputs(p4)
        for ext in a:
            if a[ext] != b[ext]:
                raise SystemExit(f"[main] {ext} of the first {k} pairs "
                                 f"differs between {dev.platform} and cpu")
        log(f"[main] first {k} pairs: nt.report, nt.ra.report, nt.lsam.id "
            f"byte-identical {dev.platform} ({t_dev:.1f}s) vs cpu "
            f"({t_cpu:.1f}s)")
    return {"world": w, "nt_pass": seen[0] if seen else None}


# ---------------------------------------------------------------------------
# phase 4: deep-DP share of one alignment pass
# ---------------------------------------------------------------------------


def phase_deep_dp_share(nt_pass, card: str, reps: int = 3) -> None:
    """Time the deep-DP calls inside one NT-shard pass (each ending in
    block_until_ready) against the pass, then the largest call alone."""
    import statistics

    import jax

    from megapath.align import device as device_mod

    engine, args = nt_pass
    engine.align_pairs(*args)  # steady state: plans promoted, compiled
    passes = []
    for _ in range(reps):
        t = time.time()
        engine.align_pairs(*args)
        passes.append(time.time() - t)
    pass_s = statistics.median(passes)

    orig = device_mod.deep_dp_fused_walk
    calls: List[tuple] = []

    def timed(*a, **kw):
        t = time.time()
        out = jax.block_until_ready(orig(*a, **kw))
        calls.append((time.time() - t, a, kw))
        return out

    device_mod.deep_dp_fused_walk = timed
    try:
        t = time.time()
        engine.align_pairs(*args)
        timed_pass = time.time() - t
    finally:
        device_mod.deep_dp_fused_walk = orig
    if not calls:
        raise SystemExit("[deep-dp] the pass made no deep_dp_fused_walk call")
    dp_s = sum(c[0] for c in calls)
    _, a, kw = max(calls, key=lambda c: c[1][5].shape[0])
    alone = []
    for _ in range(5):
        t = time.time()
        jax.block_until_ready(orig(*a, **kw))
        alone.append(time.time() - t)
    C, L, width = a[5].shape[0], a[2].shape[1], a[11]
    log(f"[deep-dp] {len(args[0])} pairs on NT shard 0: pass {pass_s:.3f}s "
        f"(median of {reps}); deep-DP calls in an instrumented pass "
        f"{dp_s:.3f}s of {timed_pass:.3f}s = {dp_s / timed_pass:.1%} in "
        f"{len(calls)} call(s); largest call alone (C={C} candidates x 2 "
        f"legs, read width {L}, window {width}) "
        f"{statistics.median(alone):.4f}s median of 5 ({card})")


# ---------------------------------------------------------------------------
# phase 5 (--four-cards): the multi-card cascade
# ---------------------------------------------------------------------------


def phase_four_cards(world: World = FOUR_CARD_WORLD, workdir: str = WORK_DIR,
                     seed: int = 1, card: str = "") -> None:
    _clean(workdir)
    t0 = time.time()
    w = make_world(world, workdir, seed)
    nt = build_indexes(w["nt_fasta"], workdir)
    log(f"[four-cards] set-up {time.time() - t0:.1f}s: {w['pairs']} pairs, "
        f"{len(nt)} NT shards of {world.nt_shards[0][1]} bp")
    runs = (("one card, sequential cascade", "single", ()),
            ("--devices 4", "dev4", ("--devices", "4")),
            ("--devices 4 --spmd", "spmd4", ("--devices", "4", "--spmd")))
    outs = {}
    for label, tag, extra in runs:
        p = os.path.join(workdir, tag)
        dt = run_cli(w, nt, None, p, w["r1"], w["r2"], extra)
        outs[tag] = read_outputs(p)
        log(f"[four-cards] {label}: {dt:.1f}s incl. compile ({card})")
    check_report(outs["single"][".nt.report"].decode(), w)
    for tag in ("dev4", "spmd4"):
        for ext, data in outs[tag].items():
            if data != outs["single"][ext]:
                raise SystemExit(f"[four-cards] {tag} {ext} differs from "
                                 "the single-card cascade")
    log("[four-cards] nt.report, nt.ra.report, nt.lsam.id byte-identical "
        "across the single-card cascade, --devices 4 and --devices 4 --spmd")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card cascade comparison")
    args = ap.parse_args(argv)

    import jax

    n_cards = 4 if args.four_cards else 1
    devs, card = phase_device(n_cards)
    if args.four_cards:
        phase_four_cards(seed=args.seed, card=card)
    else:
        phase_dp(devs[0], seed=args.seed)
        state = phase_main(seed=args.seed, card=card)
        phase_deep_dp_share(state["nt_pass"], card)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
