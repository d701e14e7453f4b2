"""Regression guard for the silent-CPU-leak class: arrays committed to the
CPU backend by a stage must be caught before they drag downstream jits onto
the host."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tuna_tpu.ops import device_guard


def test_noop_on_cpu_backend():
    # On a CPU-only host there is nothing to leak to.
    device_guard.assert_on_accelerator({"x": jnp.ones(3)})


def test_flags_cpu_committed_arrays(monkeypatch):
    x = jax.device_put(jnp.ones(3), jax.devices("cpu")[0])
    monkeypatch.setattr(device_guard, "_default_platform", lambda: "gpu")
    with pytest.raises(device_guard.DevicePlacementError) as err:
        device_guard.assert_on_accelerator({"ERI": x}, stage="integral generation")
    assert "ERI" in str(err.value)
    assert "integral generation" in str(err.value)


def test_respects_default_device_scope():
    """Inside jax.default_device(cpu) -- the deliberately host-pinned guess
    stage -- CPU placement is the INTENT, not a leak (the guard must not
    abort the pinned minimal-basis SCF)."""
    cpu0 = jax.devices("cpu")[0]
    with jax.default_device(cpu0):
        assert device_guard._default_platform() == "cpu"
        # must not raise, whatever the global default platform is
        device_guard.assert_on_accelerator(
            {"S": jax.device_put(jnp.ones(2), cpu0)}, stage="guess integrals")


def test_skips_none_and_host_data(monkeypatch):
    monkeypatch.setattr(device_guard, "_default_platform", lambda: "gpu")
    # None entries (DIRECT defers the ERI) and plain numpy arrays (host-side
    # metadata) must not trip the guard.
    assert device_guard._offending_devices(np.ones(3)) is None
    with pytest.raises(device_guard.DevicePlacementError):
        device_guard.assert_on_accelerator(
            {"ERI": None, "S": jax.device_put(jnp.ones(2), jax.devices("cpu")[0])})
