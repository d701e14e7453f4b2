"""TUNA-TPU: an accelerator-native quantum chemistry framework for atoms and diatomics.

A ground-up JAX/XLA rebuild with the capability matrix of the reference TUNA
package (CLI grammar `CALC : A B R : METHOD BASIS : KEYWORDS`): HF/DFT/MPn/
CC/CI electronic structure, geometry optimisation, frequencies, ab-initio MD
and property calculations -- with batched on-device molecular integrals,
jit-compiled SCF and correlation solvers, and autodiff derivatives.
"""

__version__ = "0.2.0"

import os as _os
import pathlib as _pathlib

import jax as _jax

# f64 numerics everywhere: chemical accuracy targets (1e-8 Ha) are
# unreachable in f32.
_jax.config.update("jax_enable_x64", True)

# On GPUs XLA may run f32 matrix products in TF32 (about three significant
# digits); nothing in quantum chemistry wants that silently, so every
# product runs at full precision unless a call asks otherwise.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the integral, SCF and CC programs are
# reusable across processes, so a warm run skips their compiles.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the cache lives
# at a fixed path in the checkout (the path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        str(_pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
