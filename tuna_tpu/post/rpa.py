"""Orbital-rotation linear response on device.

One module serves every consumer of the RPA/TD-SCF structure -- excited
states (TDHF/TDA/TD-DFT), SCF stability analysis, and the Z-vector equations
behind relaxed MP2 densities.  The organising insight is that all of them
consume the COMBINATIONS (A+B) and (A-B) of the orbital-rotation blocks, not
A and B separately:

  * excitations:  the non-Hermitian Casida problem [[A,B],[-B,-A]] folds, for
    a real SO(2)-symmetric reference, into the HERMITIAN product eigenproblem
        (A-B)^1/2 (A+B) (A-B)^1/2  T = w^2 T,
    which runs as two on-device symmetric eigensolves (ops.linalg.eigh) --
    no host LAPACK round trip and no general eig;
  * stability:    the orbital Hessian [[A,B],[B,A]] is orthogonally
    equivalent to diag(A+B, A-B), so its spectrum is eig(A+B) u eig(A-B);
  * Z-vector:     solves (A+B) z = -L directly.

Everything is built from the chemists'-notation MO tensor (pq|rs) exactly as
the integral transform produces it -- no physicists' pre-transposes.
Capability parity with the reference's per-matrix host implementation:
/root/reference/TUNA/tuna_ci.py:715-1217 (A/B builds, TDHF/TDA eigensolves,
orbital Hessians); the factorisation here is original.

For hybrid/HF kernels and the local TD-DFT kernels supported here, (A-B) is
the SAME matrix for singlet and triplet channels (the Coulomb and f_xc parts
couple only X+Y), so one build serves both.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import linalg

# (A-B) eigenvalues below this are treated as an unstable reference
INSTABILITY_FLOOR = 1e-12


def _as_ov_matrix(M4):
    """(i,a,j,b) tensor -> symmetric (ia, jb) matrix."""
    n_ov = M4.shape[0] * M4.shape[1]
    M = M4.reshape(n_ov, n_ov)
    return 0.5 * (M + M.T)


def orbital_gap_diagonal(epsilons, o, v):
    """Flattened diagonal of the zeroth-order excitation operator."""
    return (epsilons[v][None, :] - epsilons[o][:, None]).ravel()


# ---------------------------------------------------------------------------
# Closed-shell (spin-adapted) blocks, chemists' notation
# ---------------------------------------------------------------------------

def restricted_apb(g, epsilons, o, v, hfx, channel="singlet", K_XC=None):
    """(A+B) for one spin channel of a closed-shell reference.

    (A+B)_{ia,jb} = delta (e_a - e_i)
                    + 4 (ia|jb) [singlet only]
                    - c_x [ (ij|ab) + (ib|ja) ]
                    + 2 K_XC
    """
    g = jnp.asarray(g)
    x_pair = g[o, o, v, v].transpose(0, 2, 1, 3) + g[o, v, o, v].transpose(0, 3, 2, 1)
    M4 = -hfx * x_pair
    if channel == "singlet":
        M4 = M4 + 4.0 * g[o, v, o, v]
    if K_XC is not None:
        M4 = M4 + 2.0 * jnp.asarray(K_XC)
    M = _as_ov_matrix(M4)
    return M + jnp.diag(orbital_gap_diagonal(jnp.asarray(epsilons), o, v))


def restricted_amb(g, epsilons, o, v, hfx):
    """(A-B), identical for singlet and triplet channels:

    (A-B)_{ia,jb} = delta (e_a - e_i) - c_x [ (ij|ab) - (ib|ja) ]
    """
    g = jnp.asarray(g)
    M4 = -hfx * (g[o, o, v, v].transpose(0, 2, 1, 3)
                 - g[o, v, o, v].transpose(0, 3, 2, 1))
    M = _as_ov_matrix(M4)
    return M + jnp.diag(orbital_gap_diagonal(jnp.asarray(epsilons), o, v))


def restricted_tda_matrix(g, epsilons, o, v, hfx, channel="singlet", K_XC=None):
    """The bare excitation block A = ((A+B) + (A-B)) / 2, built directly."""
    g = jnp.asarray(g)
    M4 = -hfx * g[o, o, v, v].transpose(0, 2, 1, 3)
    if channel == "singlet":
        M4 = M4 + 2.0 * g[o, v, o, v]
    if K_XC is not None:
        M4 = M4 + jnp.asarray(K_XC)
    M = _as_ov_matrix(M4)
    return M + jnp.diag(orbital_gap_diagonal(jnp.asarray(epsilons), o, v))


# ---------------------------------------------------------------------------
# Spin-orbital blocks (unrestricted references)
# ---------------------------------------------------------------------------
# Take the response-scaled physicists' tensor  g~ = <pq|rs> - c_x <pq|sr>
# (antisymmetrised at c_x = 1), as produced by the spin-orbital transform.

def spin_orbital_apb(g_scaled, epsilons, o, v, K_XC=None):
    g = jnp.asarray(g_scaled)
    # A_{ia,jb} = <aj|ib>~ ;  B_{ia,jb} = <ab|ij>~
    M4 = (g[v, o, o, v].transpose(2, 0, 1, 3)
          + g[v, v, o, o].transpose(2, 0, 3, 1))
    if K_XC is not None:
        M4 = M4 + 2.0 * jnp.asarray(K_XC)
    M = _as_ov_matrix(M4)
    return M + jnp.diag(orbital_gap_diagonal(jnp.asarray(epsilons), o, v))


def spin_orbital_amb(g_scaled, epsilons, o, v):
    g = jnp.asarray(g_scaled)
    M4 = (g[v, o, o, v].transpose(2, 0, 1, 3)
          - g[v, v, o, o].transpose(2, 0, 3, 1))
    M = _as_ov_matrix(M4)
    return M + jnp.diag(orbital_gap_diagonal(jnp.asarray(epsilons), o, v))


def spin_orbital_tda_matrix(g_scaled, epsilons, o, v, K_XC=None):
    g = jnp.asarray(g_scaled)
    M4 = g[v, o, o, v].transpose(2, 0, 1, 3)
    if K_XC is not None:
        M4 = M4 + jnp.asarray(K_XC)
    M = _as_ov_matrix(M4)
    return M + jnp.diag(orbital_gap_diagonal(jnp.asarray(epsilons), o, v))


# ---------------------------------------------------------------------------
# Solvers (device-side; ops.linalg eigensolves)
# ---------------------------------------------------------------------------

def tda_excitations(A):
    """Hermitian (CIS / TDA) eigenproblem; ascending energies."""
    return linalg.eigh(A)


def rpa_excitations(apb, amb):
    """Full-response (TDHF/TD-DFT) excitations by the Hermitian product form.

    Returns (energies, vectors, amb_min, w2_min) where vectors stacks
    [X; Y] column-wise with the X^2 - Y^2 = 1 metric built in:
        X+Y = (A-B)^{1/2} T / sqrt(w),   X-Y = (A-B)^{-1/2} T sqrt(w).
    amb_min < 0 or w2_min < 0 signals an unstable reference (where the
    non-Hermitian problem has imaginary roots); the affected states carry
    clamped (meaningless) energies and should be dropped by the caller.
    """
    s, U = linalg.eigh(amb)
    s_safe = jnp.maximum(s, INSTABILITY_FLOOR)
    root = jnp.sqrt(s_safe)
    half = (U * root) @ U.T
    half_inv = (U * (1.0 / root)) @ U.T

    M = half @ apb @ half
    w2, T = linalg.eigh(0.5 * (M + M.T))
    w = jnp.sqrt(jnp.maximum(w2, INSTABILITY_FLOOR))

    XpY = (half @ T) / jnp.sqrt(w)[None, :]
    XmY = (half_inv @ T) * jnp.sqrt(w)[None, :]
    vectors = jnp.concatenate([0.5 * (XpY + XmY), 0.5 * (XpY - XmY)], axis=0)
    return w, vectors, jnp.min(s), jnp.min(w2)


def orbital_hessian_lowest(apb, amb):
    """Lowest eigenvalue of the stability Hessian [[A,B],[B,A]].

    The orthogonal rotation (u, v) -> ((u+v)/sqrt2, (u-v)/sqrt2) block-
    diagonalises the Hessian into (A+B) direct-sum (A-B), so the full 2n x 2n
    eigenproblem never needs to be formed.
    """
    return jnp.minimum(jnp.min(jnp.linalg.eigvalsh(apb)),
                       jnp.min(jnp.linalg.eigvalsh(amb)))


def zvector_solve(apb, lagrangian_ov):
    """Orbital-response z from (A+B) z = -L, on device."""
    z, _ = linalg.solve_symmetric(jnp.asarray(apb),
                                  -jnp.asarray(lagrangian_ov).ravel())
    return z.reshape(lagrangian_ov.shape)
