"""Translated protein search (the AC-DIAMOND blastx stage replacement).

Reference contract: runMegaPath.sh:312-323 — blastx of contigs +
unmapped reads vs NR, m8 output whose subject ids carry taxids joined
by '0x1', then m8_to_lsam -> taxLookup -> report.
"""

import numpy as np
import pytest

from megapath.classify.protein import (
    AA_CODE,
    BLOSUM62,
    BlastxParams,
    ProteinDB,
    blastx,
    blastx_m8,
    translate_frames,
)

DNA = {"A": 0, "C": 1, "G": 2, "T": 3}


def enc_dna(s):
    return np.array([DNA[c] for c in s], np.uint8)


def aa_str(codes):
    from megapath.classify.protein import AA

    return "".join(AA[c] for c in codes)


def test_translate_standard_code():
    # ATG GCA TTT TAA -> M A F *
    codes = enc_dna("ATGGCATTTTAA")
    frames = dict(translate_frames(codes))
    assert aa_str(frames[1]) == "MAF*"
    # frame 2 drops the first base: TGG CAT TTT -> W H F
    assert aa_str(frames[2]) == "WHF"
    # reverse strand frame -1: revcomp = TTAAAATGCCAT -> L K C H
    assert aa_str(frames[-1]) == "LKCH"


def test_translate_roundtrip_length():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 100).astype(np.uint8)
    for frame, aa in translate_frames(codes):
        off = abs(frame) - 1
        assert len(aa) == (100 - off) // 3


def _reverse_translate(aa_seq: str, rng) -> str:
    """Any codon that decodes to each aa (for planting queries)."""
    from megapath.classify.protein import CODON_AA

    out = []
    for c in aa_seq:
        cands = np.flatnonzero(CODON_AA == AA_CODE[c])
        v = int(cands[rng.integers(0, len(cands))])
        out.append("ACGT"[v >> 4] + "ACGT"[(v >> 2) & 3] + "ACGT"[v & 3])
    return "".join(out)


@pytest.fixture(scope="module")
def prot_db():
    rng = np.random.default_rng(5)
    from megapath.classify.protein import AA

    real20 = AA[:20]
    seqs = []
    for i in range(6):
        s = "".join(real20[j] for j in rng.integers(0, 20, 120))
        # subject names carry taxids joined by 0x1 like the NR build
        seqs.append((f"{9000 + i}0x1{500 + i}", s))
    return ProteinDB.build(seqs, k=4), seqs


def test_blastx_recovers_planted_protein(prot_db):
    db, seqs = prot_db
    rng = np.random.default_rng(7)
    # query = reverse-translated fragment of subject 2 (aa 10..60)
    frag = seqs[2][1][10:60]
    dna = _reverse_translate(frag, rng)
    hits = blastx([("q0", enc_dna(dna))], db)
    assert hits, "planted protein fragment must be found"
    top = hits[0]
    assert top.sseqid == seqs[2][0]
    assert top.pident == 100.0
    assert top.length == 50
    assert top.mismatch == 0 and top.gapopen == 0
    assert (top.sstart, top.send) == (11, 60)  # 1-based aa coords
    assert top.qstart == 1 and top.qend == 150
    assert top.bitscore_ > 40


def test_blastx_reverse_strand(prot_db):
    db, seqs = prot_db
    rng = np.random.default_rng(8)
    frag = seqs[4][1][20:70]
    dna = _reverse_translate(frag, rng)
    # reverse-complement the DNA: hit must appear on a negative frame
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = "".join(comp[c] for c in reversed(dna))
    hits = blastx([("q0", enc_dna(rc))], db)
    assert hits and hits[0].sseqid == seqs[4][0]
    assert hits[0].pident == 100.0
    # blastx convention: minus-strand hits have qstart > qend
    assert hits[0].qstart > hits[0].qend


def test_blastx_mutations_reported(prot_db):
    db, seqs = prot_db
    rng = np.random.default_rng(9)
    frag = list(seqs[1][1][0:60])
    from megapath.classify.protein import AA

    # two aa substitutions
    frag[20] = AA[(AA_CODE[frag[20]] + 1) % 20]
    frag[40] = AA[(AA_CODE[frag[40]] + 1) % 20]
    dna = _reverse_translate("".join(frag), rng)
    hits = blastx([("q0", enc_dna(dna))], db)
    assert hits and hits[0].sseqid == seqs[1][0]
    assert hits[0].mismatch == 2
    assert hits[0].pident == pytest.approx(100.0 * 58 / 60, abs=0.01)


def test_blastx_no_random_hits(prot_db):
    db, _ = prot_db
    rng = np.random.default_rng(10)
    dna = rng.integers(0, 4, 120).astype(np.uint8)
    hits = blastx([("junk", dna)], db)
    assert hits == []


def test_m8_flows_into_lsam(prot_db):
    from megapath.classify.extras import m8_to_lsam

    db, seqs = prot_db
    rng = np.random.default_rng(11)
    dna = _reverse_translate(seqs[0][1][5:55], rng)
    lines = blastx_m8([("contig_1", enc_dna(dna))], db)
    assert lines
    recs = list(m8_to_lsam(lines))
    assert recs[0].name == "contig_1"
    tids = {t for _, t in recs[0].hits}
    assert tids == {"9000", "500"}  # split on the literal 0x1


def test_device_blosum_dp_matches_host_oracle():
    """sw_align_substmat vs a plain numpy SW under BLOSUM62."""
    from megapath.ops.dp import DPParams, sw_align_protein

    rng = np.random.default_rng(12)
    B, R, W = 8, 40, 64
    q = rng.integers(0, 20, (B, R)).astype(np.uint8)
    s = rng.integers(0, 20, (B, W)).astype(np.uint8)
    # plant exact & mutated copies
    s[0, 10:50] = q[0]
    s[1, 5:45] = q[1]
    s[1, 20] = (s[1, 20] + 1) % 20
    ql = np.full(B, R, np.int32)
    sl = np.full(B, W, np.int32)
    out = sw_align_protein(q, s, ql, sl)

    def oracle(qq, ss):
        go, ge = -11, -1
        nq, ns = len(qq), len(ss)
        H = np.zeros((nq + 1, ns + 1), np.int64)
        E = np.full((nq + 1, ns + 1), -(10**6), np.int64)
        F = np.full((nq + 1, ns + 1), -(10**6), np.int64)
        for i in range(1, nq + 1):
            for j in range(1, ns + 1):
                E[i, j] = max(H[i, j - 1] + go, E[i, j - 1] + ge)
                F[i, j] = max(H[i - 1, j] + go, F[i - 1, j] + ge)
                H[i, j] = max(
                    0,
                    H[i - 1, j - 1] + BLOSUM62[qq[i - 1], ss[j - 1]],
                    E[i, j],
                    F[i, j],
                )
        return int(H.max())

    for b in range(B):
        assert int(out.score[b]) == oracle(q[b], s[b]), b


def test_protein_remap_stage(mini_taxdb):
    """Stage 4.1 end-to-end: contigs + unmapped reads -> blastx -> tax
    lookup -> r2c_to_r2g join -> NR report (runMegaPath.sh:300-325)."""
    from megapath.io.lsam import LsamRecord
    from megapath.pipeline.assembly import AssemblyResult, protein_remap

    rng = np.random.default_rng(21)
    from megapath.classify.protein import AA

    real20 = AA[:20]
    # protein subjects named by ACCESSION (0x1-joined), mapped by the
    # mini acc2tid: NC_045512 -> 694009 (SARS2), NC_000913 -> 83333
    prot_seqs = [
        ("NC_045512", "".join(real20[j] for j in rng.integers(0, 20, 150))),
        ("NC_0009130x1NC_003197",
         "".join(real20[j] for j in rng.integers(0, 20, 150))),
    ]
    db = ProteinDB.build(prot_seqs, k=4)

    # contig 0 encodes a fragment of subject 0; read u1 encodes a
    # fragment of subject 1; read u2 is junk
    contig0 = _reverse_translate(prot_seqs[0][1][10:110], rng)
    u1_dna = _reverse_translate(prot_seqs[1][1][40:90], rng)

    def dec(codes):
        return "".join("ACGT"[c] for c in codes)

    recs1 = [
        type("R", (), {"name": "u1", "seq": u1_dna})(),
        type("R", (), {"name": "u2",
                       "seq": dec(rng.integers(0, 4, 150))})(),
        type("R", (), {"name": "mapped", "seq": dec(rng.integers(0, 4, 150))})(),
    ]
    recs2 = []
    # r2c: 'mapped' aligned well to contig 0; u1/u2 didn't
    r2c = [
        LsamRecord(name="mapped", flag=0, score=120, seq="*", qual="*",
                   hits=[(120.0, "0")]),
        LsamRecord(name="u1", flag=0, score=0, seq="*", qual="*", hits=[]),
        LsamRecord(name="u2", flag=0, score=0, seq="*", qual="*", hits=[]),
    ]
    asm = AssemblyResult(contigs=[contig0], read2contig=r2c)
    nr_lsam_id, r2g, report = protein_remap(
        asm, recs1, recs2, db, mini_taxdb, cutoff=40
    )
    by_name = {r.name: r for r in nr_lsam_id}
    # the contig hit subject 0 -> taxid 694009
    assert "contig_0" in by_name
    assert {t for _, t in by_name["contig_0"].hits} == {"694009"}
    # unmapped read u1 hit subject 1 -> both accessions' SPECIES
    # taxids (taxLookupAcc pops strains to species: 83333 -> 562,
    # 59201 -> 28901)
    assert "u1" in by_name
    assert {t for _, t in by_name["u1"].hits} == {"562", "28901"}
    # junk read found nothing
    assert "u2" not in by_name
    # transitive join: 'mapped' (r2c score 120 > 40) inherits the
    # contig's genome hits
    r2g_by = {r.name: r for r in r2g}
    assert "mapped" in r2g_by
    assert {t for _, t in r2g_by["mapped"].hits} == {"694009"}
    # report counts u1 + mapped (contig_ rows excluded), not u2
    assert "Severe acute" in report or "694009" in report


# ---------------------------------------------------------------------------
# parity vs the VENDORED ac-diamond binary (golden pinned by
# tests/fixtures/make_protein_fixtures.py from
# /root/reference/ac-diamond-0.1-beta-linux64/ac-diamond, the binary
# runMegaPath.sh:312-316 invokes)
# ---------------------------------------------------------------------------


def _read_fasta(path):
    out = []
    name, seq = None, []
    for line in open(path):
        line = line.strip()
        if line.startswith(">"):
            if name:
                out.append((name, "".join(seq)))
            name, seq = line[1:].split()[0], []
        else:
            seq.append(line)
    if name:
        out.append((name, "".join(seq)))
    return out


@pytest.fixture(scope="module")
def acd_world():
    import pathlib

    fix = pathlib.Path(__file__).parent / "fixtures" / "protein"
    prots = _read_fasta(fix / "prot.fa")
    contigs = _read_fasta(fix / "contigs.fa")
    golden = {}
    for line in open(fix / "acd.m8"):
        c = line.rstrip("\n").split("\t")
        golden[c[0]] = c  # one (top) hit per query in the fixture
    db = ProteinDB.build(prots)
    queries = [(n, enc_dna(s)) for n, s in contigs]
    ours_lines = blastx_m8(queries, db)
    ours = {}
    for line in ours_lines:
        c = line.split("\t")
        ours.setdefault(c[0], []).append(c)
    return golden, ours


def test_acd_hit_pairs_match(acd_world):
    """Every ac-diamond (query -> subject) top pair is recovered, and
    junk queries stay hitless on both sides."""
    golden, ours = acd_world
    for q, g in golden.items():
        assert q in ours, f"{q}: ac-diamond hit {g[1]}, we found nothing"
        top = max(ours[q], key=lambda c: float(c[11]))
        assert top[1] == g[1], f"{q}: want {g[1]}, got {top[1]}"
    for q in ours:
        if q.endswith("_junk"):
            raise AssertionError(f"junk query {q} produced hits: {ours[q]}")


def test_acd_scores_and_coords_match(acd_world):
    """Bitscores within 10% of ac-diamond's; exact-match contigs also
    reproduce the aligned length, identity and subject coordinates."""
    golden, ours = acd_world
    for q, g in golden.items():
        top = max(ours[q], key=lambda c: float(c[11]))
        g_bits, o_bits = float(g[11]), float(top[11])
        assert abs(o_bits - g_bits) <= 0.10 * g_bits, (
            f"{q}: bitscore {o_bits} vs golden {g_bits}"
        )
        if float(g[2]) == 100.0:  # exact-match contigs: hard columns
            assert float(top[2]) == 100.0, f"{q}: pident {top[2]}"
            assert top[3] == g[3], f"{q}: length {top[3]} vs {g[3]}"
            assert top[4] == g[4] == "0"
            assert (top[8], top[9]) == (g[8], g[9]), (
                f"{q}: subject span {top[8]}-{top[9]} vs {g[8]}-{g[9]}"
            )
