"""Test configuration: run JAX on CPU (float64, 8 virtual devices).

Unit tests validate numerics on the CPU backend.  Behaviour on the GPU is
exercised by `chip_smoke.py` and by tests marked `gpu`, which skip (inside
the `gpu_device` fixture) when no card is visible.
"""

import os

import pytest

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

# CPU unless the caller names platforms (the `gpu` tests run on the card
# with JAX_PLATFORMS=cuda,cpu).
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


# XLA:CPU's backend_compile_and_load segfaults when a LARGE program is
# compiled late in a long suite process (reproduced deterministically after
# ~84 tests at whatever big compile comes next, e.g. the UCCSD production
# solver in test_newton_finisher.py; every such program passes in
# isolation).  The
# trigger is accumulated in-process compiled-executable state, so the suite
# bounds it: jax.clear_caches() drops the live jitted executables every few
# tests, trading recompiles for a compiler that never sees the pathological
# accumulation.  Module-level kernel caches (scf._KERNEL_CACHE etc.) hold
# callables, not executables -- they transparently recompile.
_CLEAR_EVERY = 10
_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _bound_xla_cpu_compiler_state(request):
    # Slow-tier tests compile the largest programs in the suite (cc-pV5Z
    # parity, cc-pV6Z-shape sharded transforms) -- exactly the class that
    # segfaults on accumulated state (observed once in the slow tier,
    # 2026-08-17).  Their runtime dwarfs a recompile, so start each one
    # from a clean compiler.
    if request.node.get_closest_marker("slow") is not None:
        jax.clear_caches()
    yield
    _test_counter["n"] += 1
    if _test_counter["n"] % _CLEAR_EVERY == 0:
        jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none.  Decided here, at test
    time, never at import: every xdist worker must collect the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (on the card: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests -m gpu)")
