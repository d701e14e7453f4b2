"""Accelerator-residency guard for pipeline arrays.

An array committed to the CPU device silently pins every downstream jit that
consumes it (SCF, CC) to the CPU backend: XLA raises no error, committed
inputs simply move the computation.  A former host-CPU ERI fallback did
exactly that once.  This guard makes the invariant explicit: when the
default device is an accelerator, every array the solvers consume must live
there.  The one stage pinned to the host on purpose (the minimal-basis
guess) runs inside a `jax.default_device(cpu)` scope, which the guard
respects.

Call `assert_on_accelerator` after integral generation.  The check is free:
it reads Python-side device metadata, no transfers, no sync.
"""

from __future__ import annotations

import jax


class DevicePlacementError(RuntimeError):
    pass


def _offending_devices(x):
    try:
        devices = x.devices()
    except AttributeError:  # not a jax.Array (numpy, python scalar): host data
        return None
    bad = {d for d in devices if d.platform == "cpu"}
    return bad or None


def _default_platform() -> str:
    # The DEFAULT DEVICE's platform, not jax.default_backend(): tests fake
    # the backend name to force accelerator code paths on CPU-only hosts,
    # but a leak only exists when a real non-CPU device is the default.
    # An active `jax.default_device(...)` scope overrides the global
    # default: stages deliberately pinned to the host (the minimal-basis
    # guess SCF, drivers/energy.py) place their arrays on CPU BY INTENT,
    # and the pinning wrapper strips the commitment at its boundary.
    scoped = jax.config.jax_default_device
    if scoped is not None:
        return getattr(scoped, "platform", str(scoped))
    return jax.devices()[0].platform


def assert_on_accelerator(arrays: dict, stage: str = "pipeline"):
    """Raise if any array in `arrays` (name -> array, None entries skipped)
    is resident on a CPU device while the default device is an accelerator.

    No-op on CPU-only hosts (tests, CI) -- there is nothing to leak to.
    """
    if _default_platform() == "cpu":
        return
    leaks = []
    for name, x in arrays.items():
        if x is None:
            continue
        bad = _offending_devices(x)
        if bad:
            leaks.append(f"{name} on {sorted(str(d) for d in bad)}")
    if leaks:
        raise DevicePlacementError(
            f"{stage}: array(s) committed to the CPU backend would drag every "
            f"downstream jit onto the host (the round-3 silent-CPU-leak class): "
            + "; ".join(leaks)
            + ". Transfer with jax.device_put(x, jax.devices()[0]) at the "
            "fallback boundary.")
