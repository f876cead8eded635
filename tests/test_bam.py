"""BAM writer/reader round-trip + BGZF validity."""

import gzip
import io

from megapath.io.bam import BgzfWriter, bgzf_decompress, read_bam, write_bam

HEADER = (
    "@HD\tVN:1.6\tSO:unsorted\n"
    "@SQ\tSN:chr1\tLN:10000\n"
    "@SQ\tSN:chr2\tLN:5000\n"
    "@PG\tID:megapath\tPN:megapath\n"
)
LINES = [
    "r1\t99\tchr1\t100\t60\t50M\t=\t300\t250\t" + "A" * 50 + "\t" + "I" * 50 + "\tAS:i:48",
    "r1\t147\tchr1\t300\t60\t10S40M\t=\t100\t-250\t" + "C" * 50 + "\t" + "J" * 50 + "\tAS:i:40",
    "r2\t77\t*\t0\t0\t*\t*\t0\t0\tACGTN\tIIIII\tAS:i:0",
    "r3\t0\tchr2\t17\t13\t5M2I3M1D5M\t*\t0\t0\t" + "G" * 15 + "\t" + "K" * 15 + "\tAS:i:9\tXX:Z:hello",
]


def test_bgzf_is_valid_gzip():
    buf = io.BytesIO()
    w = BgzfWriter(buf)
    payload = b"hello bgzf world" * 10000  # spans multiple blocks
    w.write(payload)
    w.close()
    # python gzip handles concatenated members, including the EOF block
    assert gzip.decompress(buf.getvalue()) == payload
    assert bgzf_decompress(buf.getvalue()) == payload


def test_bgzf_block_walker():
    """Advance block-by-block via BSIZE+1 the way htslib does.

    BSIZE is total block size MINUS 1 (SAM spec 4.1); a walker that
    reads exactly BSIZE+1 bytes per block must land on each following
    block's gzip magic and decompress every payload."""
    import struct
    import zlib

    buf = io.BytesIO()
    w = BgzfWriter(buf)
    payload = bytes(range(256)) * 2000  # spans several 64 KB blocks
    w.write(payload)
    w.close()
    data = buf.getvalue()
    pos = 0
    out = bytearray()
    nblocks = 0
    while pos < len(data):
        assert data[pos : pos + 4] == b"\x1f\x8b\x08\x04", f"block {nblocks}"
        xlen = struct.unpack("<H", data[pos + 10 : pos + 12])[0]
        # scan the extra subfields for BC
        ext = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        i = 0
        while i < len(ext):
            si1, si2, slen = ext[i], ext[i + 1], struct.unpack("<H", ext[i + 2 : i + 4])[0]
            if (si1, si2) == (66, 67):
                bsize = struct.unpack("<H", ext[i + 4 : i + 6])[0]
            i += 4 + slen
        assert bsize is not None
        block = data[pos : pos + bsize + 1]
        comp = block[12 + xlen : -8]
        crc, isize = struct.unpack("<II", block[-8:])
        chunk = zlib.decompress(comp, -15)
        assert len(chunk) == isize and zlib.crc32(chunk) == crc
        out += chunk
        pos += bsize + 1
        nblocks += 1
    assert bytes(out) == payload
    assert nblocks >= 8  # multiple data blocks + EOF


def test_bam_readable_by_pysam(tmp_path):
    """External-tool check when pysam is available (optional)."""
    try:
        import pysam  # type: ignore
    except ImportError:
        import pytest

        pytest.skip("pysam not installed")
    path = tmp_path / "t.bam"
    with open(path, "wb") as f:
        write_bam(f, HEADER, LINES)
    with pysam.AlignmentFile(str(path), "rb", check_sq=False) as bf:
        got = [a.query_name for a in bf.fetch(until_eof=True)]
    assert got == ["r1", "r1", "r2", "r3"]


def test_bam_roundtrip():
    buf = io.BytesIO()
    write_bam(buf, HEADER, LINES)
    buf.seek(0)
    header, lines = read_bam(buf)
    assert header == HEADER
    assert lines == LINES


def test_bam_from_sam_writer(tmp_path):
    """BAM of the engine's own SAM output round-trips."""
    import numpy as np

    from megapath.index.fm import build_fm_index
    from megapath.index.pack import COMPLEMENT, decode_seq, pack_fasta
    from megapath.io.fastq import FastqRecord
    from megapath.io.sam import hits_to_sam, sam_header
    from megapath.align import AlignEngine, AlignParams

    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, 5000).astype(np.uint8)
    ref = pack_fasta([FastqRecord("g1", decode_seq(genome), "", "")])
    fm = build_fm_index(ref.codes, sa_interval=4, lut_k=6)
    eng = AlignEngine(ref, fm, AlignParams())
    n, L, ins = 8, 80, 300
    r1 = np.zeros((n, L), np.uint8)
    r2 = np.zeros((n, L), np.uint8)
    for i in range(n):
        p = int(rng.integers(0, 5000 - ins))
        r1[i] = genome[p : p + L]
        r2[i] = COMPLEMENT[genome[p + ins - L : p + ins][::-1]]
    lens = np.full(n, L, np.int32)
    hits = eng.align_pairs(r1, lens, r2, lens.copy())
    names = [f"q{i}" for i in range(n)]
    sam_lines = list(hits_to_sam(hits, ref, names, r1, lens, r2, lens))
    assert sam_lines
    buf = io.BytesIO()
    write_bam(buf, sam_header(ref), sam_lines)
    buf.seek(0)
    _, out_lines = read_bam(buf)
    assert len(out_lines) == len(sam_lines)
    # first record survives field-for-field
    assert out_lines[0].split("\t")[:6] == sam_lines[0].split("\t")[:6]


def test_sort_and_merge_bams(tmp_path):
    """samtools sort/merge equivalent over per-shard BAMs."""
    import io as _io

    from megapath.io.bam import merge_bams, read_bam, sort_sam_lines, write_bam

    header = "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n@SQ\tSN:chr2\tLN:500\n"

    def rec(name, ref, pos):
        return "\t".join(
            [name, "0", ref, str(pos), "60", "4M", "*", "0", "0",
             "ACGT", "IIII"]
        )

    bam1 = _io.BytesIO()
    write_bam(bam1, header, [rec("a", "chr2", 5), rec("b", "chr1", 100)])
    bam2 = _io.BytesIO()
    write_bam(bam2, header, [rec("c", "chr1", 7), rec("d", "chr2", 2),
                             rec("e", "*", 0)])
    bam1.seek(0)
    bam2.seek(0)
    out = _io.BytesIO()
    merge_bams([bam1, bam2], out)
    out.seek(0)
    h, lines = read_bam(out)
    names = [l.split("\t")[0] for l in lines]
    assert names == ["c", "b", "d", "a", "e"]  # chr1 by pos, chr2, unmapped
    assert sort_sam_lines(header, lines) == lines  # idempotent


def test_merge_bams_header_mismatch(tmp_path):
    import io as _io

    import pytest as _pytest

    from megapath.io.bam import merge_bams, write_bam

    h1 = "@SQ\tSN:chr1\tLN:1000\n"
    h2 = "@SQ\tSN:chrX\tLN:99\n"
    b1, b2 = _io.BytesIO(), _io.BytesIO()
    write_bam(b1, h1, [])
    write_bam(b2, h2, [])
    b1.seek(0)
    b2.seek(0)
    with _pytest.raises(ValueError, match="differ"):
        merge_bams([b1, b2], _io.BytesIO())
