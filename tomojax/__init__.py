"""tomojax — rigid-body tomographic alignment + reconstruction in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``pandekan/tomography_alignment``:

- ``core``    : geometry, rotations, phantoms, and the matrix-free
                differentiable projector families (the replacement for the
                reference's f2py Fortran kernels ``ray_wt_grad``/``vox_wt_grad``
                and the scipy CSR system matrix of
                ``utilities/projection_operators.py``).
- ``kernels`` : the Pallas-Triton GPU kernel of the slab family's
                plane-quadrature forward.
- ``recon``   : CGLS / SIRT / Tikhonov / ISTA-FISTA-lasso / TV-FISTA solvers as
                ``lax.while_loop`` iterations over a matrix-free operator
                (replaces ``recon/*.py`` and the ``*_mpi.py`` twins).
- ``align``   : FFT phase-correlation coarse alignment + per-view 6-DoF
                gradient refinement + the alternating pipeline
                (replaces ``align/align_cc.py``,
                ``utilities/alignment_functions.py``,
                ``examples/align_rigid.py``).
- ``dist``    : projection-angle data parallelism over a ``jax.sharding.Mesh``
                (psum over the device interconnect replaces the reference's
                MPI allreduce).
"""

__version__ = "0.1.0"


def compilation_cache_dir() -> str:
    """Where compiled programs persist across processes:
    ``$JAX_COMPILATION_CACHE_DIR`` if set (JAX reads it itself), otherwise
    ``<checkout>/.jax_cache`` — a fixed path beside the package, so a
    later process in the same checkout finds it again."""
    import os
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), ".jax_cache"))


def _setup_compilation_cache():
    """Fill in the default cache directory; the variable, or an explicit
    ``jax.config.update`` before import, wins."""
    import os
    import jax
    if (not os.environ.get("JAX_COMPILATION_CACHE_DIR")
            and jax.config.jax_compilation_cache_dir is None):
        jax.config.update("jax_compilation_cache_dir",
                          compilation_cache_dir())


_setup_compilation_cache()

from tomojax.core.geometry import Geometry, Views
from tomojax.core import rotations
from tomojax.core import phantom

__all__ = ["Geometry", "Views", "rotations", "phantom", "__version__"]
