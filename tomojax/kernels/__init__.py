"""Hand-written GPU kernels (Pallas through Triton).

- :mod:`tomojax.kernels.slab` — the slab family's plane-quadrature forward.
"""
