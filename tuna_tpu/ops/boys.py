"""Vectorised Boys function F_n(T) in pure JAX, stable in float64.

The reference computes Boys values through scipy's cython hyp1f1
(tuna_integral.pyx:1490-1505, 1540-1572), which is unavailable on-device.
Here we use a table-driven two-regime scheme:

  T < T_SWITCH : Taylor expansion of F_nmax about the nearest grid point
                 T_i (spacing 0.1, |dT| <= 0.05, 10 terms -> ~1e-16 abs),
                     F_m(T_i + dT) = sum_k F_{m+k}(T_i) (-dT)^k / k!,
                 then downward recursion
                 F_{m-1} = (2T F_m + e^-T) / (2m - 1)      (stable downward)
  T >= T_SWITCH: F_0 = sqrt(pi/(4T)) (erf(sqrt(T)) = 1 to ~1e-15 relative
                 for T >= 30), then upward recursion
                 F_{m+1} = ((2m+1) F_m - e^-T) / (2T)      (stable for large T)

Both branches are evaluated for every element (XLA select), keeping the
computation branch-free and batchable.  Accuracy ~1e-15 relative across the
full range used by molecular integrals.

The Taylor table replaces a 130-term Kummer cumprod evaluated per element,
which materialised (batch, 130) f64 intermediates through a multi-pass
scan; the table path is one gather from a (301, 10) constant plus a
10-term Horner.  The grid values
themselves are computed once on the host with the same Kummer series in
float64 numpy (200 terms, fully converged at T <= 30).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

T_SWITCH = 30.0
_GRID_STEP = 0.1
_N_TAYLOR = 10
_N_SERIES_TERMS = 200  # host-side table build only


def _host_boys_top(m: int, T: np.ndarray) -> np.ndarray:
    """F_m(T) by the Kummer series, float64 numpy, T <= T_SWITCH only."""
    two_T = 2.0 * T
    denominators = 2.0 * m + 2.0 * np.arange(1, _N_SERIES_TERMS + 1) + 1.0
    ratios = two_T[..., None] / denominators
    series = 1.0 + np.sum(np.cumprod(ratios, axis=-1), axis=-1)
    return np.exp(-T) * series / (2.0 * m + 1.0)


_TABLE_CACHE: dict[int, np.ndarray] = {}


def _taylor_table(nmax: int) -> np.ndarray:
    """(n_grid, _N_TAYLOR) table: tab[i, k] = F_{nmax+k}(T_i) (-1)^k / k!."""
    tab = _TABLE_CACHE.get(nmax)
    if tab is None:
        n_grid = int(round(T_SWITCH / _GRID_STEP)) + 1
        grid = np.arange(n_grid) * _GRID_STEP
        # series at the highest order, downward recursion for the rest
        # (downward is the stable direction; errors shrink every step)
        top = nmax + _N_TAYLOR - 1
        rows = [_host_boys_top(top, grid)]
        exp_g = np.exp(-grid)
        for m in range(top, nmax, -1):
            rows.append((2.0 * grid * rows[-1] + exp_g) / (2.0 * m - 1.0))
        F = np.stack(rows[::-1], axis=-1)  # (n_grid, K), orders nmax..top
        sign_fact = np.array([(-1.0) ** k / math.factorial(k)
                              for k in range(_N_TAYLOR)])
        tab = F * sign_fact
        _TABLE_CACHE[nmax] = tab
    return tab


def boys_table(nmax: int, T: jnp.ndarray) -> jnp.ndarray:
    """Boys functions F_0..F_nmax of T.

    Args:
        nmax: highest order (static).
        T: any-shape array of non-negative arguments.

    Returns:
        array of shape T.shape + (nmax + 1,)
    """
    T = jnp.asarray(T)
    # Clamp each branch's argument into its own safe domain; selection at the
    # end picks the valid branch, so the clamped values never leak.
    T_small = jnp.minimum(T, T_SWITCH)
    T_large = jnp.maximum(T, T_SWITCH)

    exp_small = jnp.exp(-T_small)

    # --- small-T branch: Taylor about the nearest grid point, then
    # downward recursion ----------------------------------------------------
    tab = jnp.asarray(_taylor_table(nmax), dtype=T.dtype)
    idx = jnp.clip(jnp.round(T_small / _GRID_STEP).astype(jnp.int32),
                   0, tab.shape[0] - 1)
    dT = T_small - idx.astype(T.dtype) * _GRID_STEP  # |dT| <= 0.05
    coeffs = tab[idx]  # (..., K): F_{nmax+k}(T_i) (-1)^k / k!
    F_top = coeffs[..., -1]
    for k in range(_N_TAYLOR - 2, -1, -1):
        F_top = F_top * dT + coeffs[..., k]

    two_T = 2.0 * T_small
    downward = [F_top]
    for m in range(nmax, 0, -1):
        downward.append((two_T * downward[-1] + exp_small) / (2.0 * m - 1.0))
    F_small = jnp.stack(downward[::-1], axis=-1)  # (..., nmax+1), order 0..nmax

    # --- large-T branch: closed-form F_0, then upward recursion -----------
    # erf(sqrt(T)) = 1 to ~1e-15 relative at T >= 30, so F_0 needs no erf.
    sqrt_T = jnp.sqrt(T_large)
    F0 = jnp.sqrt(jnp.pi) / (2.0 * sqrt_T)
    exp_large = jnp.exp(-T_large)
    upward = [F0]
    for m in range(nmax):
        upward.append(((2.0 * m + 1.0) * upward[-1] - exp_large) / (2.0 * T_large))
    F_large = jnp.stack(upward, axis=-1)

    return jnp.where((T < T_SWITCH)[..., None], F_small, F_large)


@partial(jax.jit, static_argnums=0)
def boys_table_jit(nmax: int, T: jnp.ndarray) -> jnp.ndarray:
    return boys_table(nmax, T)
