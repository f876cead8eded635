from megapath.classify.taxlookup import tax_lookup_acc, tax_lookup_line  # noqa: F401
from megapath.classify.reassign import Reassigner, reassign_lines  # noqa: F401
