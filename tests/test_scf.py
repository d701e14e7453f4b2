"""End-to-end SCF tests: literature golden values and an independent plain
NumPy SCF solver built on the oracle integrals."""

import numpy as np
import pytest

from tuna_tpu.cli import run

import oracle_integrals as oracle


def numpy_rhf(basis_functions, atoms, n_doubly_occ, V_NN, max_iter=200, tol=1e-11):
    """Independent dense RHF fixed-point solver (simple damped iteration)."""
    S, T, V, _, _ = oracle.one_electron_matrices(
        basis_functions, atoms, np.zeros(3))
    eri = oracle.eri_tensor(basis_functions)
    H = T + V
    w, U = np.linalg.eigh(S)
    X = (U / np.sqrt(w)) @ U.T
    P = np.zeros_like(S)
    E_old = 0.0
    for it in range(max_iter):
        J = np.einsum("ijkl,kl->ij", eri, P)
        K = np.einsum("ilkj,kl->ij", eri, P)
        F = H + J - 0.5 * K
        eps, C = np.linalg.eigh(X.T @ F @ X)
        C = X @ C
        P_new = 2 * C[:, :n_doubly_occ] @ C[:, :n_doubly_occ].T
        P = 0.5 * P + 0.5 * P_new if it < 8 else P_new
        E = 0.5 * np.einsum("ij,ij->", P, H + F)
        if abs(E - E_old) < tol and it > 5:
            break
        E_old = E
    return E + V_NN


def test_h2_sto3g_literature():
    """HF/STO-3G H2 at 0.74 A; golden value from this framework, cross-checked
    against Szabo & Ostlund at 1.4 bohr (-1.1167593)."""
    result = run("SPE : H H 0.74 : HF STO-3G", suppress_output=True)
    _, _, energy, _ = result
    assert abs(energy - (-1.11675930740)) < 1e-8


def test_rhf_vs_independent_solver():
    """RHF energies match an independent NumPy solver for several systems."""
    cases = [
        ("SPE : H H 0.74 : HF STO-3G", 1),
        ("SPE : LI H 1.60 : HF STO-3G", 2),
        ("SPE : HE H 0.9 : HF 6-31G : CH 1", 1),
    ]
    for line, n_occ in cases:
        SCF_output, molecule, energy, _ = run(line, suppress_output=True)
        V_NN = float(np.prod(molecule.charges)
                     / np.linalg.norm(molecule.coordinates[1] - molecule.coordinates[0]))
        E_ref = numpy_rhf(molecule.cartesian_basis_functions, molecule.atoms,
                          n_occ, V_NN)
        assert abs(energy - E_ref) < 1e-8, line


def test_uhf_h2_cation():
    """H2+ UHF: one-electron system, exact within basis; energy equals the
    lowest eigenvalue of H_core plus V_NN."""
    SCF_output, molecule, energy, _ = run(
        "SPE : H H 1.06 : UHF STO-3G : CH 1 ML 2", suppress_output=True)
    H = np.array(SCF_output.T) + np.array(SCF_output.V_NE)
    S = np.array(SCF_output.S)
    w, U = np.linalg.eigh(S)
    X = (U / np.sqrt(w)) @ U.T
    eps = np.linalg.eigvalsh(X.T @ H @ X)
    V_NN = 1.0 / np.linalg.norm(molecule.coordinates[1] - molecule.coordinates[0])
    assert abs(energy - (eps[0] + V_NN)) < 1e-9


def test_uhf_triplet_vs_rhf():
    """UHF triplet H2 is bound above the RHF singlet at equilibrium."""
    _, _, E_singlet, _ = run("SPE : H H 0.74 : HF 6-31G", suppress_output=True)
    _, _, E_triplet, _ = run("SPE : H H 0.74 : UHF 6-31G : ML 3", suppress_output=True)
    assert E_triplet > E_singlet


def test_spherical_equals_cartesian_energy():
    """CARTHARM and spherical-harmonic bases give identical energies for
    d-free systems, and consistent energies with d functions."""
    _, _, E_sph, _ = run("SPE : H H 0.74 : HF 6-31G", suppress_output=True)
    _, _, E_cart, _ = run("SPE : H H 0.74 : HF 6-31G : CARTHARM", suppress_output=True)
    assert abs(E_sph - E_cart) < 1e-10

    _, _, E_sph_d, _ = run("SPE : LI H 1.6 : HF 6-31G** : SADGUESS", suppress_output=True)
    _, _, E_cart_d, _ = run("SPE : LI H 1.6 : HF 6-31G** : CARTHARM SADGUESS", suppress_output=True)
    # Cartesian d shell contains an extra s-type component -> lower energy
    assert E_cart_d < E_sph_d + 1e-10
    assert abs(E_cart_d - E_sph_d) < 5e-3


def test_guess_strategies_agree():
    """All three guess strategies converge to the same SCF energy."""
    energies = []
    for guess_kw in ("", " : COREGUESS", " : SADGUESS", " : SCFGUESS"):
        _, _, E, _ = run("SPE : LI H 1.6 : HF 6-31G" + guess_kw, suppress_output=True)
        energies.append(E)
    assert np.ptp(energies) < 1e-8


def test_host_pinned_guess_branch_matches(monkeypatch):
    """The minimal-basis guess SCF is pinned to the host CPU device on every
    backend (drivers/energy.calculate_self_consistent_guess): the pinning
    context and the numpy re-commit boundary must leave the energy unchanged
    whatever platform JAX reports."""
    import jax as _jax

    _, _, E_default, _ = run("SPE : LI H 1.6 : HF 6-31G", suppress_output=True)
    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    _, _, E_pinned, _ = run("SPE : LI H 1.6 : HF 6-31G", suppress_output=True)
    assert abs(E_pinned - E_default) < 1e-10


def test_electric_field():
    """A finite field along z lowers the energy (polarisation) for H2."""
    _, _, E0, _ = run("SPE : H H 0.74 : HF 6-31G", suppress_output=True)
    _, _, Ez, _ = run("SPE : H H 0.74 : HF 6-31G : EZ 0.01", suppress_output=True)
    assert Ez < E0


def test_convergence_keywords():
    _, _, E_loose, _ = run("SPE : H H 0.74 : HF STO-3G : LOOSE NODIIS NODAMP",
                           suppress_output=True)
    _, _, E_tight, _ = run("SPE : H H 0.74 : HF STO-3G : EXTREME", suppress_output=True)
    assert abs(E_loose - E_tight) < 1e-5


def test_inverse_sqrt_repairs_noncommuting_seed_noise():
    """The S^-1/2 polish must contract |X^T S X - I| quadratically even when
    the eigh seed carries eigenvector noise that does not commute with S --
    the failure mode of an inexact f64 eigh that froze SCF convergence at
    cc-pVTZ (a Newton-Schulz stall at the seed error, see ops/linalg.py
    docstring)."""
    import numpy as np
    import jax.numpy as jnp
    from tuna_tpu.ops import linalg

    rng = np.random.default_rng(7)
    n = 40
    # ill-conditioned SPD overlap-like matrix (cond ~ 1e5)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    w = np.logspace(-5, 0, n)
    S = Q @ np.diag(w) @ Q.T
    X, wmin, S_inv = linalg.inverse_sqrt(jnp.asarray(S))
    err = np.abs(np.asarray(X).T @ S @ np.asarray(X) - np.eye(n)).max()
    assert err < 1e-11
    assert abs(float(wmin) - w.min()) < 1e-8
    assert np.abs(np.asarray(S_inv) @ S - np.eye(n)).max() < 1e-7
