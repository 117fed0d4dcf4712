"""pcr_tpu — point-cloud registration with global refinement, in JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference repo
``Point-Cloud-Registration-with-Global-Refinement`` (FPFH+FGR coarse
registration, multi-scale GICP refinement, and SLERP/LUM/SLERP+LUM/pose-graph
global refinement), re-designed for accelerators: fixed-shape masked arrays,
batched pairs over a device mesh, matmul-based neighbor search, and
collective-reduced pose-graph solves.
"""

import os as _os

import jax as _jax

# Persistent XLA compile cache: the big fixed-shape modules (FPFH, pyramid,
# GICP) take seconds to minutes to compile.  JAX itself reads
# JAX_COMPILATION_CACHE_DIR at import; where it is set it wins and nothing
# else is configured here.  Otherwise the cache lives at a fixed path in the
# checkout (gitignored), so repeated runs of one checkout find it, unless the
# caller already configured a directory.
if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
    _jax.config.update("jax_compilation_cache_dir",
                       _os.environ["JAX_COMPILATION_CACHE_DIR"])
elif _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                      ".jax_cache"))
_jax.config.update(
    "jax_persistent_cache_min_compile_time_secs",
    float(_os.environ.get("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")))

# Geometry workloads need true-f32 matmuls: on the GPU a float32 dot product
# may run in TF32 (~3 decimal digits), which is catastrophic for
# squared-distance ranking (errors ~|q||r|*2^-10 vs neighbor gaps of
# millimeters).  'highest' keeps full f32; kernels that can tolerate less
# override locally.
_jax.config.update("jax_default_matmul_precision", "highest")

from . import utils  # noqa: F401,E402

__version__ = "0.1.0"
