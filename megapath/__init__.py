"""megapath: a JAX metagenomic pathogen-detection engine.

Re-implements the capabilities of HKU-BAL/MegaPath (reference surveyed in
SURVEY.md) as one JAX/XLA framework instead of a shell-orchestrated
cascade of native tools:

- ``megapath.io``        FASTQ / cfq / LSAM / SAM formats (host-side IO).
- ``megapath.taxonomy``  NCBI taxonomy, LCA, Kraken-style reports.
- ``megapath.index``     2-bit packed references, FM-index, k-mer LUT,
                         shard splitting (replaces 2bwt-lib / splitFasta).
- ``megapath.ops``       batched affine-gap DP (XLA scan) and its
                         host oracle and traceback.
- ``megapath.align``     MMP seeding, insert-window pairing, the batch
                         alignment engine (replaces soap4).
- ``megapath.filters``   bbduk-style read QC and SPIKE coverage filters.
- ``megapath.classify``  accession->taxid lookup, read reassignment.
- ``megapath.pipeline``  end-to-end drivers (runMegaPath equivalents).
- ``megapath.parallel``  device-mesh sharding of index shards x read
                         batches, collective hit merges.
"""

__version__ = "0.1.0"
