from megapath.amplicon.debruijn import DeBruijnGraph, candidate_haplotypes  # noqa: F401
from megapath.amplicon.realign import realign_window, WindowRealignment  # noqa: F401
