"""Realignment-stage parity vs the REFERENCE realigner binary.

Builds /root/reference/scripts/realignment/realign/{ssw,realigner} into
a shared library (no boost needed — only the dBG consensus requires
boost, and haplotypes are supplied explicitly here, exactly as
realign_illumina_reads.py supplies the dBG output), then drives both
the reference ``realign_reads`` and our ``realign_reads_window``
(amplicon/realign.py transliteration of realigner.cpp:88-470) on
identical windows with planted SNP / deletion / insertion haplotypes,
asserting the realigned positions and cigars agree read for read.

This is the parity evidence for the realignment stage; the
GATK-replacement pileup caller is tested separately on
planted truth (test_amplicon_pipeline.py).
"""

import ctypes
import pathlib
import subprocess

import numpy as np
import pytest

SRC = pathlib.Path("/root/reference/scripts/realignment/realign")
BUILD = pathlib.Path("/tmp/refrealign")

MAXN = 1000  # struct_str_arr arrays (realigner.h:42-46)


class StructPointer(ctypes.Structure):
    _fields_ = [
        ("position", ctypes.c_int * MAXN),
        ("cigar_string", ctypes.c_char_p * MAXN),
    ]


@pytest.fixture(scope="module")
def ref_realigner():
    so = BUILD / "realigner.so"
    if not so.exists():
        if not SRC.exists():
            pytest.skip("reference realigner sources unavailable")
        BUILD.mkdir(exist_ok=True)
        for f in ("ssw.c", "ssw.h", "ssw_cpp.cpp", "ssw_cpp.h",
                  "realigner.cpp", "realigner.h"):
            (BUILD / f).write_bytes((SRC / f).read_bytes())
        r = subprocess.run(
            ["g++", "-std=c++14", "-O2", "-shared", "-fPIC", "-o",
             str(so), str(BUILD / "ssw_cpp.cpp"), str(BUILD / "ssw.c"),
             str(BUILD / "realigner.cpp")],
            capture_output=True,
        )
        if r.returncode != 0:
            pytest.skip(f"reference realigner build failed: {r.stderr[-200:]}")
    return ctypes.cdll.LoadLibrary(str(so))


def run_reference(lib, reads, positions, cigars, reference, haplotypes,
                  ref_start, ref_prefix, ref_suffix):
    n = len(reads)
    seq_list = (ctypes.c_char_p * n)(*[r.encode() for r in reads])
    pos_list = (ctypes.c_int * n)(*positions)
    cig_list = (ctypes.c_char_p * n)(*[c.encode() for c in cigars])
    lib.realign_reads.restype = ctypes.POINTER(StructPointer)
    lib.realign_reads.argtypes = [
        ctypes.c_char_p * n, ctypes.c_int * n, ctypes.c_char_p * n,
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    p = lib.realign_reads(
        seq_list, pos_list, cig_list,
        ctypes.c_char_p(reference.encode()),
        ctypes.c_char_p(" ".join(haplotypes).encode()),
        ref_start, ref_prefix, ref_suffix, n,
    )
    out_pos = list(p.contents.position[:n])
    out_cig = [c.decode() if c else "" for c in p.contents.cigar_string[:n]]
    lib.free_memory.restype = ctypes.POINTER(ctypes.c_void_p)
    lib.free_memory.argtypes = [ctypes.POINTER(StructPointer), ctypes.c_int]
    lib.free_memory(p, n)
    return out_pos, out_cig


def norm_cigar(c):
    """'='/'X' -> M with run merging, so both sides compare equal."""
    out = []
    n = 0
    for ch in c:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            o = "M" if ch in "=X" else ch
            if out and out[-1][0] == o:
                out[-1] = (o, out[-1][1] + n)
            else:
                out.append((o, n))
            n = 0
    return "".join(f"{ln}{o}" for o, ln in out)


def _mkseq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def _compare(lib, reads, positions, cigars, reference, haplotypes,
             ref_start, ref_prefix, ref_suffix):
    from megapath.amplicon.realign import realign_reads_window

    rp, rc = run_reference(lib, reads, positions, cigars, reference,
                           haplotypes, ref_start, ref_prefix, ref_suffix)
    op, oc = realign_reads_window(reads, positions, cigars, reference,
                                  haplotypes, ref_start, ref_prefix,
                                  ref_suffix)
    mism = []
    for i in range(len(reads)):
        ref_result = (rp[i], norm_cigar(rc[i].replace("X", "M")))
        our_result = (op[i], norm_cigar(oc[i]))
        if ref_result != our_result:
            mism.append((i, ref_result, our_result))
    assert mism == [], mism
    return rp, rc


def test_snp_window_parity(ref_realigner):
    rng = np.random.default_rng(31)
    prefix, center, suffix = _mkseq(rng, 20), _mkseq(rng, 200), _mkseq(rng, 20)
    reference = prefix + center + suffix
    var = list(center)
    var[100] = "ACGT"[("ACGT".index(var[100]) + 1) % 4]
    hap = prefix + "".join(var) + suffix
    # reads of 80bp from the variant haplotype at several offsets:
    # spanning the SNP, before it, after it
    reads, positions, cigars = [], [], []
    for off in (0, 30, 60, 90, 120, 150):
        reads.append(hap[off : off + 80])
        positions.append(1000 + off)
        cigars.append("80M")
    rp, rc = _compare(ref_realigner, reads, positions, cigars, reference,
                      [hap], 1000, len(prefix), len(suffix))
    # sanity: positions stay anchored (SNP costs no shift)
    assert rp[0] == 1000


def test_deletion_window_parity(ref_realigner):
    rng = np.random.default_rng(32)
    prefix, center, suffix = _mkseq(rng, 20), _mkseq(rng, 200), _mkseq(rng, 20)
    reference = prefix + center + suffix
    hap = prefix + center[:100] + center[103:] + suffix  # 3bp deletion
    reads, positions, cigars = [], [], []
    for off in (0, 40, 60, 90, 130, 150):
        reads.append(hap[off : off + 70])
        positions.append(500 + off)
        cigars.append("70M")
    rp, rc = _compare(ref_realigner, reads, positions, cigars, reference,
                      [hap], 500, len(prefix), len(suffix))
    # a read entirely downstream of the deletion shifts +3 in ref coords
    assert rp[5] == 500 + 150 + 3


def test_insertion_window_parity(ref_realigner):
    rng = np.random.default_rng(33)
    prefix, center, suffix = _mkseq(rng, 20), _mkseq(rng, 200), _mkseq(rng, 20)
    reference = prefix + center + suffix
    hap = prefix + center[:100] + "GTCA" + center[100:] + suffix  # 4bp ins
    reads, positions, cigars = [], [], []
    for off in (0, 50, 80, 120, 160):
        reads.append(hap[off : off + 70])
        positions.append(0 + off)
        cigars.append("70M")
    _compare(ref_realigner, reads, positions, cigars, reference,
             [hap], 0, len(prefix), len(suffix))


def test_multi_haplotype_and_junk_parity(ref_realigner):
    """Two candidate haplotypes + a junk read that matches neither."""
    rng = np.random.default_rng(34)
    prefix, center, suffix = _mkseq(rng, 20), _mkseq(rng, 160), _mkseq(rng, 20)
    reference = prefix + center + suffix
    v1 = list(center)
    v1[60] = "ACGT"[("ACGT".index(v1[60]) + 1) % 4]
    hap1 = prefix + "".join(v1) + suffix
    hap2 = prefix + center[:80] + center[82:] + suffix  # 2bp del
    reads = [hap1[30:100], hap2[40:110], _mkseq(rng, 70)]
    positions = [30, 40, 50]
    cigars = ["70M", "70M", "70M"]
    _compare(ref_realigner, reads, positions, cigars, reference,
             [hap1, hap2], 0, len(prefix), len(suffix))
