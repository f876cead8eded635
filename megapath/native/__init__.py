"""Native (C++) components, loaded via ctypes with graceful fallback.

The compute path is JAX/XLA; these are the host-runtime pieces
the reference implements natively (index construction). Build with
``python -m megapath.native.build`` or let the loader compile on
first use (g++ -O3 -shared).
"""

from megapath.native.build import load_saais, suffix_array_native  # noqa: F401
