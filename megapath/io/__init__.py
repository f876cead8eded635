from megapath.io.fastq import (  # noqa: F401
    FastqRecord,
    read_fastx,
    write_fastq,
    trim_readno,
    open_maybe_gz,
)
from megapath.io.lsam import (  # noqa: F401
    LsamRecord,
    fastq_to_lsam,
    parse_hits,
    format_hits,
    read_lsam,
    write_lsam,
    deinterleave,
    lsam_read_filter,
)
