"""Native SA-IS builder tests."""

import numpy as np
import pytest

from megapath.native.build import load_saais, suffix_array_native
from megapath.index.suffix import _suffix_array_doubling, suffix_array


@pytest.mark.skipif(load_saais() is None, reason="native build unavailable")
@pytest.mark.parametrize("n", [1, 2, 3, 17, 256, 4097, 100_000])
def test_saais_matches_doubling(n):
    codes = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    sa = suffix_array_native(codes)
    np.testing.assert_array_equal(sa, _suffix_array_doubling(codes))


@pytest.mark.skipif(load_saais() is None, reason="native build unavailable")
def test_saais_repetitive_text():
    # highly repetitive inputs exercise the recursion path
    codes = np.tile(np.array([0, 1, 0, 1, 2], np.uint8), 2000)
    sa = suffix_array_native(codes)
    np.testing.assert_array_equal(sa, _suffix_array_doubling(codes))


def test_suffix_array_dispatches_native():
    codes = np.random.default_rng(0).integers(0, 4, 5000).astype(np.uint8)
    np.testing.assert_array_equal(
        suffix_array(codes, native=True), suffix_array(codes, native=False)
    )


def test_native_fastq_reader(tmp_path):
    import gzip

    import numpy as np
    import pytest

    from megapath.native.build import NativeFastqReader, load_fastq_lib

    if load_fastq_lib() is None:
        pytest.skip("native fastq parser unavailable")

    p = tmp_path / "r.fq.gz"
    with gzip.open(p, "wt") as f:
        f.write("@read1/1 comment here\nACGTN\n+\nIIIII\n")
        f.write("@read2/2\nacgt\n+\nJJJJ\n")
        f.write("@read3\n" + "A" * 600 + "\n+\n" + "K" * 600 + "\n")
    with NativeFastqReader(str(p), max_len=512) as r:
        codes, lens, quals, seqs, names = r.next_batch(10)
        assert names == ["read1", "read2", "read3"]
        np.testing.assert_array_equal(lens, [5, 4, 512])
        np.testing.assert_array_equal(codes[0, :5], [0, 1, 2, 3, 2])  # N->G
        np.testing.assert_array_equal(codes[1, :4], [0, 1, 2, 3])
        assert quals[0, :5].tobytes() == b"IIIII"
        assert seqs[0, :5].tobytes() == b"ACGTN"
        assert codes[2, :512].sum() == 0  # truncated to max_len, all A
        # EOF
        codes, lens, quals, seqs, names = r.next_batch(10)
        assert len(names) == 0


def test_native_fastq_fasta(tmp_path):
    import pytest

    from megapath.native.build import NativeFastqReader, load_fastq_lib

    if load_fastq_lib() is None:
        pytest.skip("native fastq parser unavailable")
    p = tmp_path / "r.fa"
    p.write_text(">ctg1 desc\nACGT\n>ctg2\nGGGG\n")
    with NativeFastqReader(str(p), max_len=16) as r:
        codes, lens, quals, seqs, names = r.next_batch(4)
        assert names == ["ctg1", "ctg2"]
        assert list(lens) == [4, 4]
        assert quals[0, :4].tobytes() == b"IIII"


def test_native_fastq_multiline_fasta(tmp_path):
    import pytest

    from megapath.native.build import NativeFastqReader, load_fastq_lib

    if load_fastq_lib() is None:
        pytest.skip("native fastq parser unavailable")
    p = tmp_path / "m.fa"
    p.write_text(">ctg1\nACGT\nTTTT\n>ctg2\nCC\n")
    with NativeFastqReader(str(p), max_len=32) as r:
        codes, lens, quals, seqs, names = r.next_batch(4)
        assert names == ["ctg1", "ctg2"]
        assert list(lens) == [8, 2]
        assert codes[0, :8].tolist() == [0, 1, 2, 3, 3, 3, 3, 3]
