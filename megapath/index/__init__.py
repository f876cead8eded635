from megapath.index.pack import (  # noqa: F401
    PackedReference,
    encode_seq,
    decode_seq,
    revcomp,
    pack_fasta,
    pack_fasta_file,
    pack_reads,
)
from megapath.index.suffix import suffix_array, bwt_from_sa  # noqa: F401
from megapath.index.fm import FMIndex, build_fm_index  # noqa: F401
from megapath.index.shard import split_fasta, build_shard_indexes  # noqa: F401
