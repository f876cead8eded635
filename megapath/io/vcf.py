"""Minimal VCF 4.2 output for the amplicon pipeline.

The reference's amplicon driver ends in a realigned VCF
(/root/reference/runMegaPath-Amplicon.sh:240-264,
scripts/realignment/extract_vcf_position.py); here the pipeline's
confirmed variants serialize directly.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, TextIO, Tuple


def write_vcf(
    variants: Iterable,  # pipeline.amplicon.Variant ducks: seq/pos/ref/alt/depth/alt_count
    out: TextIO,
    contigs: Optional[Sequence[Tuple[str, int]]] = None,
    sample: str = "SAMPLE",
    source: str = "megapath-amplicon",
) -> None:
    out.write("##fileformat=VCFv4.2\n")
    out.write(f"##source={source}\n")
    if contigs:
        for name, length in contigs:
            out.write(f"##contig=<ID={name},length={length}>\n")
    out.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">\n')
    out.write(
        '##INFO=<ID=AC,Number=1,Type=Integer,Description="Alt read count">\n'
    )
    out.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    out.write('##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allele depths">\n')
    out.write(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample + "\n"
    )
    for v in variants:
        frac = v.alt_count / v.depth if v.depth else 0.0
        gt = "1/1" if frac > 0.8 else "0/1"
        ref_depth = max(v.depth - v.alt_count, 0)
        out.write(
            f"{v.seq.split()[0]}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t"
            f"{min(99, int(frac * 100))}\tPASS\t"
            f"DP={v.depth};AC={v.alt_count}\tGT:AD\t{gt}:{ref_depth},{v.alt_count}\n"
        )


def find_af(depth: int, alt_info: dict, ref_base: str, alt_base: str):
    """extract_vcf_position.find_AF: allele count from the pileup alt
    table keyed by SNP base / 'I'+inserted / 'D'+deleted suffix."""
    count = 0
    if len(ref_base) == len(alt_base) == 1:
        count = int(alt_info.get(alt_base, 0))
    elif len(ref_base) < len(alt_base):
        count = int(alt_info.get("I" + alt_base[1:], 0))
    elif len(ref_base) > len(alt_base):
        count = int(alt_info.get("D" + ref_base[1:], 0))
    if count > 0 and depth:
        return count / float(depth)
    return None


def update_vcf_af(
    vcf_lines: Iterable[str],
    alt_table: dict,
) -> List[str]:
    """extract_vcf_position.ExtractVcfPosition: rewrite each variant
    row's sample column with the realignment pileup's depth + allele
    frequency (GT:GQ:DP:AF) when the site has a recomputed AF; rows
    without a pileup entry or with AF<=0 pass through unchanged.
    ``alt_table`` maps (contig, pos) -> (depth, {allele: count}).
    """
    out: List[str] = []
    for row in vcf_lines:
        row = row.rstrip("\n")
        if not row or row[0] == "#":
            out.append(row)
            continue
        cols = row.split("\t")
        key = (cols[0], int(cols[1]))
        if key not in alt_table:
            out.append(row)
            continue
        ref_base, alt_base = cols[3], cols[4]
        depth, alt_info = alt_table[key]
        new_af = find_af(depth, alt_info, ref_base, alt_base)
        if not new_af or new_af <= 0:
            out.append(row)
            continue
        parts = cols[-1].split(":")
        if len(parts) == 4:  # Clair-style GT:GQ:DP:AF sample column
            gt, gq = parts[0], parts[1]
            cols = cols[:-1] + [f"{gt}:{gq}:{depth}:{new_af:.4f}"]
        else:
            cols = cols + [f"{depth}:{new_af:.4f}"]
        out.append("\t".join(cols))
    return out
