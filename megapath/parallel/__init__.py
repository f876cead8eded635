from megapath.parallel.dist import (  # noqa: F401
    make_mesh,
    build_dist_align_step,
    shard_arrays,
    DistAlignOut,
)
from megapath.parallel.spmd import (  # noqa: F401
    SpmdAlignOut,
    StackedFM,
    build_spmd_engine_step,
    make_mesh_for,
    pad_and_index_shards,
    place_spmd_inputs,
    stack_fms,
)
