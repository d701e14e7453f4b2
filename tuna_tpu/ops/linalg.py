"""Precision-polished dense linear algebra.

Quantum chemistry needs eigenvectors/eigenvalues at ~1e-12 (SCF densities,
MP/CC denominators).  These routines polish the raw `jnp.linalg.eigh` output
with perturbation-theory refinement built from matmuls, build S^-1/2 by a
constraint polish of an eigh seed, and solve small systems by unrolled
elimination -- all jit-safe and differentiable.  They were written for a
backend without f64 factorisations; whether the GPU's native f64 eigh and
solves can replace them is an open measurement (PERF.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_POLISH_STEPS = 3
_NS_STEPS = 4


def eigh(A: jnp.ndarray, polish_steps: int = _POLISH_STEPS):
    """Symmetric eigendecomposition, polished to near machine-f64 accuracy.

    Runs jnp.linalg.eigh, then iteratively refines with first-order
    perturbation theory: H = V^T A V is nearly diagonal, eigenvalues are
    updated to diag(H), and eigenvectors are rotated by K_ij = H_ij/(w_j-w_i)
    (zeroed inside near-degenerate blocks, where the mixing is physically
    arbitrary).  Each step squares the off-diagonal error.
    """
    w, V = jnp.linalg.eigh(A)

    for _ in range(polish_steps):
        H = V.T @ A @ V
        w = jnp.diagonal(H)
        scale = jnp.maximum(jnp.max(jnp.abs(w)), 1e-30)
        gaps = w[None, :] - w[:, None]
        degenerate = jnp.abs(gaps) < 1e-9 * scale
        K = jnp.where(degenerate, 0.0, H / jnp.where(degenerate, 1.0, gaps))
        K = K - jnp.diag(jnp.diagonal(K))
        V = V + V @ K
        # Re-orthonormalise (first-order): V <- V (3I - V^T V)/2
        VtV = V.T @ V
        V = V @ (1.5 * jnp.eye(V.shape[0], dtype=V.dtype) - 0.5 * VtV)

    # Final eigenvalue estimate from accurate Rayleigh quotients
    H = V.T @ A @ V
    w = jnp.diagonal(H)
    order = jnp.argsort(w)
    return w[order], V[:, order]


def solve_symmetric(A: jnp.ndarray, b: jnp.ndarray, rcond: float = 1e-14):
    """Solve A x = b for symmetric A via the polished eigendecomposition.

    The TPU backend implements no f64 LU factorisation (LuDecomposition is
    F32/C64-only), so jnp.linalg.solve cannot compile there; the eigh route
    can, and doubles as a pseudo-inverse for near-singular systems such as
    saturated DIIS B-matrices.  Returns (x, ok) where ok certifies a small
    residual -- False signals a genuinely inconsistent (singular) system.
    """
    w, V = eigh(A)
    scale = jnp.max(jnp.abs(w))
    cutoff = rcond * jnp.maximum(scale, 1e-300)
    safe = jnp.abs(w) > cutoff
    inv_w = jnp.where(safe, 1.0 / jnp.where(safe, w, 1.0), 0.0)
    x = V @ (inv_w * (V.T @ b))
    residual = jnp.linalg.norm(A @ x - b)
    ok = residual < 1e-8 * (1.0 + jnp.linalg.norm(b))
    return x, ok


def solve_linear_small(A: jnp.ndarray, b: jnp.ndarray):
    """Dense solve for small in-loop systems (DIIS) by statically-unrolled,
    row-equilibrated Gauss-Jordan elimination.

    On TPU there is no f64 LAPACK, and sequential fori_loop steps with
    dynamic indexing (pivot search, row swaps) cost ~10 ms EACH inside a
    while_loop body -- a pivoted fori version of this routine dominated the
    whole CC iteration.  n is static here, so the elimination unrolls into
    ~4n fully-fusible vector ops with no dynamic indexing.  Row equilibration
    replaces pivoting for stability; the residual check catches the rare
    genuinely-singular system, and ok doubles as the DIIS reset signal.
    """
    n = A.shape[0]
    r = jnp.max(jnp.abs(A), axis=1)
    r = jnp.where(r > 0, r, 1.0)
    M = jnp.concatenate([A / r[:, None], (b / r)[:, None]], axis=1)

    for k in range(n):  # static unroll
        pivot = M[k, k]
        safe = jnp.abs(pivot) > 1e-300
        row_k = M[k] * jnp.where(safe, 1.0 / jnp.where(safe, pivot, 1.0), 0.0)
        factors = M[:, k].at[k].set(0.0)
        M = M - factors[:, None] * row_k[None, :]
        M = M.at[k].set(row_k)

    x = M[:, n]
    residual = jnp.linalg.norm(A @ x - b)
    ok = jnp.isfinite(residual) & (residual < 1e-8 * (1.0 + jnp.linalg.norm(b)))
    return x, ok


def solve_linear_small_refined(A: jnp.ndarray, b: jnp.ndarray,
                               steps: int = 3):
    """Dense small-system solve: native-f32 Gauss-Jordan INVERSE plus
    `steps` rounds of iterative refinement in the input dtype.

    The O(n) elimination ops all run in f32, and only the O(steps)
    refinement matmuls run in the input dtype: x holds
    ~(kappa*eps_f32)^(steps+1) relative error, ~1e-12 for the kappa <~ 1e4
    systems this serves once operands are pre-scaled.  The residual check
    `ok` (in the input dtype) still catches ill-conditioned systems, which
    fall back to the caller's reset path exactly as with the plain solver.
    """
    if A.dtype == jnp.float32:
        return solve_linear_small(A, b)
    n = A.shape[0]
    A32 = A.astype(jnp.float32)
    r = jnp.max(jnp.abs(A32), axis=1)
    r = jnp.where(r > 0, r, 1.0)
    M = jnp.concatenate([A32 / r[:, None], jnp.eye(n, dtype=jnp.float32)],
                        axis=1)
    for k in range(n):  # static unroll, all native f32
        pivot = M[k, k]
        safe = jnp.abs(pivot) > 1e-30
        row_k = M[k] * jnp.where(safe, 1.0 / jnp.where(safe, pivot, 1.0), 0.0)
        factors = M[:, k].at[k].set(0.0)
        M = M - factors[:, None] * row_k[None, :]
        M = M.at[k].set(row_k)
    # M[:, n:] inverts the row-equilibrated matrix D^-1 A, so A^-1 = that
    # inverse times D^-1 applied on the right (columns scaled by 1/r).
    # The inverse stays in f32: classical iterative refinement only needs
    # the RESIDUAL in high precision -- the correction solve contracts the
    # error by ~kappa*eps_f32 per step either way, so an f64 Ainv matvec
    # buys nothing over the f32 one.
    Ainv32 = M[:, n:] * (1.0 / r)[None, :]
    x = (Ainv32 @ b.astype(jnp.float32)).astype(A.dtype)
    for _ in range(steps):
        res = b - A @ x
        x = x + (Ainv32 @ res.astype(jnp.float32)).astype(A.dtype)
    residual = jnp.linalg.norm(A @ x - b)
    ok = jnp.isfinite(residual) & (residual < 1e-8 * (1.0 + jnp.linalg.norm(b)))
    return x, ok


def expm_skew(K: jnp.ndarray):
    """exp(K) for skew-symmetric K (orbital rotations) via eigh of -K^2.

    -K^2 is symmetric PSD with eigenpairs (theta^2, V); on each invariant
    plane exp(K) = cos(theta) + K sinc(theta).  Needs no f64 LU/Pade and is
    jittable, unlike jax.scipy.linalg.expm.
    """
    A = -K @ K
    w, V = eigh(A)
    theta = jnp.sqrt(jnp.maximum(w, 0.0))
    cos_term = (V * jnp.cos(theta)) @ V.T
    safe = theta > 1e-12
    sinc = jnp.where(safe, jnp.sin(theta) / jnp.where(safe, theta, 1.0), 1.0)
    return cos_term + K @ ((V * sinc) @ V.T)


@partial(jax.jit, static_argnames=("ns_steps",))
def inverse_sqrt(S: jnp.ndarray, eigenvalues: jnp.ndarray | None = None,
                 ns_steps: int = _NS_STEPS):
    """Orthogonalising X ~ S^-1/2 for SPD S via eigh seed + constraint polish.

    Jitted: callers invoke it eagerly from the host-level pipeline, and one
    compiled call replaces ~10 eager dispatches of the unrolled polish loop.

    An eigh seed may carry ~1e-7..1e-5 eigenvector noise (worse with
    basis-set condition number) on backends with inexact f64 eigh.  Newton-Schulz variants cannot repair it:
    both Y <- Y(3I-SY^2)/2 and the coupled (Y, Z) pair only contract the
    error component that COMMUTES with S, so they stall exactly at the
    seed's non-commuting noise (measured: a frozen 1.1e-5 |X^T S X - I| at
    cc-pVTZ, independent of iteration count).  The symmetric sandwich

        E = X^T S X - I,    X <- X (I - E/2)

    contracts the orthonormality constraint itself:
    X'^T S X' - I = -(3/4) E^2 + O(E^3) with no commutation assumption, so
    two-three steps reach the rounding floor (~1e-13).  X
    drifts from the symmetric Loewdin form by O(seed noise) -- harmless, any
    X with X^T S X = I orthogonalises the SCF -- hence S^-1 = X X^T (not XX).
    Returns (X, smallest eigenvalue of S, S^-1).
    """
    w, V = jnp.linalg.eigh(S)
    X = (V * (1.0 / jnp.sqrt(w))) @ V.T
    X = 0.5 * (X + X.T)
    identity = jnp.eye(S.shape[0], dtype=S.dtype)
    for _ in range(ns_steps):
        E = X.T @ S @ X - identity
        X = X - 0.5 * (X @ E)
    S_inverse = X @ X.T
    return X, jnp.min(w), S_inverse
