from megapath.filters.bbduk import (  # noqa: F401
    KmerRef,
    build_kmer_ref,
    load_adapters,
    kmask,
    quality_trim,
    average_entropy,
    bbduk_pair,
    BBDukResult,
)
from megapath.filters.spike import (  # noqa: F401
    CoverageRuns,
    genome_coverage,
    spike_regions,
    spike_read_filter,
)
