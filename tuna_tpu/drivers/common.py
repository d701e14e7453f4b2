"""Shared driver-level machinery: coordinate hygiene, nuclear repulsion,
orthogonalisation, dispersion corrections, spherical-harmonic integral
transformation, electric fields and CBS extrapolation.

Capability parity with /root/reference/TUNA/tuna_kernel.py (driver pieces).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants
from ..containers import Integrals
from ..ops import linalg
from ..ops.integrals import IntegralPlan
from ..output import error, log, timer, warning


def clean_coordinates(coordinates: np.ndarray) -> np.ndarray:
    """Align the molecule exactly on the z axis (tuna_util.py:845-880)."""
    coordinates = np.asarray(coordinates, dtype=np.float64)
    if coordinates.shape == (2, 3):
        bond = float(np.linalg.norm(coordinates[1] - coordinates[0]))
        return np.array([[0.0, 0.0, 0.0], [0.0, 0.0, bond]])
    if coordinates.shape == (1, 3):
        return np.array([[0.0, 0.0, 0.0]])
    return coordinates


def calculate_nuclear_repulsion_energy(charges, coordinates, calculation, silent=False):
    log(" Calculating nuclear repulsion energy...  ", calculation, 1, end="", silent=silent)
    V_NN = float(np.prod(charges) / np.linalg.norm(coordinates[1] - coordinates[0]))
    log(f"[Done]\n\n Nuclear repulsion energy: {V_NN:.10f}\n", calculation, 1, silent=silent)
    return V_NN


def calculate_orthogonalisation_matrix(S, calculation, silent=False):
    """X = S^-1/2 (Newton-Schulz polished), smallest eigenvalue, S^-1."""
    timer("Fock orthogonalisation matrix", 0)
    log(" Constructing Fock orthogonalisation matrix... ", calculation, 1,
        end="", silent=silent)
    X, smallest, S_inverse = linalg.inverse_sqrt(jnp.asarray(S))
    smallest = float(smallest)
    if smallest < 0:
        error("A negative overlap matrix eigenvalue was found!")
    log("[Done]", calculation, 1, silent=silent)
    timer("Fock orthogonalisation matrix", 1)
    return X, smallest, S_inverse


def check_overlap_eigenvalues(smallest_S_eigenvalue, calculation, silent=False):
    log(f"\n Smallest overlap matrix eigenvalue is {smallest_S_eigenvalue:.8f}, "
        f"threshold is {calculation.S_eigenvalue_threshold:.8f}.",
        calculation, 2, silent=silent)
    if smallest_S_eigenvalue < calculation.S_eigenvalue_threshold:
        error("An overlap matrix eigenvalue is too small! Change the basis set "
              "or decrease the threshold with STHRESH.")
    elif smallest_S_eigenvalue < 10 * calculation.S_eigenvalue_threshold:
        warning(f"Smallest overlap matrix eigenvalue is close to the threshold, "
                f"at {smallest_S_eigenvalue:.8f}! \n", space=1)


def calculate_D2_dispersion_energy(molecule, calculation, silent):
    """Grimme D2 pairwise dispersion (tuna_kernel.py:984-1023)."""
    atoms = molecule.atoms
    S6 = calculation.functional.D2_S6 if calculation.DFT_calculation else 1.2
    log(f" Calculating semi-empirical dispersion energy with S6 value of "
        f"{S6:.3f}...  ", calculation, 1, end="", silent=silent)
    damping_factor = 20  # matches the ORCA HF-D2 implementation
    C6 = np.sqrt(atoms[0].C6 * atoms[1].C6)
    vdw_sum = atoms[0].vdw_radius + atoms[1].vdw_radius
    f_damp = 1 / (1 + np.exp(-damping_factor * (molecule.bond_length / vdw_sum - 1)))
    E_D2 = -S6 * C6 / molecule.bond_length**6 * f_damp
    log(f"[Done]\n\n Dispersion energy (D2): {E_D2:.10f}\n", calculation, 1, silent=silent)
    return E_D2


def calculate_additive_dispersion_energy(molecule, calculation, silent):
    if calculation.monatomic or not calculation.D2:
        return 0.0
    return calculate_D2_dispersion_energy(molecule, calculation, silent)


def apply_electric_field(D, electric_field):
    return jnp.einsum("i,ijk->jk", jnp.asarray(electric_field), D)


def apply_electric_field_gradient(Q, electric_field_gradient):
    # Reference uses components (xx, xx, yy) here (tuna_kernel.py:705);
    # replicated for output parity.
    Q_stack = jnp.stack([Q[0], Q[0], Q[1]])
    return jnp.einsum("i,ijk->jk", jnp.asarray(electric_field_gradient), Q_stack)


@jax.jit
def _spherical_one_electron(U, S, T, V_NE, D, Q):
    return (U @ S @ U.T, U @ T @ U.T, U @ V_NE @ U.T,
            jnp.einsum("mw,awx,nx->amn", U, D, U),
            jnp.einsum("mw,awx,nx->amn", U, Q, U))


@jax.jit
def _spherical_eri(U, ERI):
    for _ in range(4):
        ERI = jnp.moveaxis(jnp.tensordot(U, ERI, axes=(1, 0)), 0, 3)
    return ERI


def transform_to_spherical_harmonics(S, T, V_NE, D, Q, ERI, molecule, calculation,
                                     silent):
    """U M U^T for one-electron, four dot_general sweeps for the ERI tensor,
    jitted into two compiled calls (one-electron bundle + ERI sweep)."""
    if calculation.cartesian_harmonics:
        return S, T, V_NE, D, Q, ERI
    timer("Spherical harmonic transformation", 0)
    log("\n Transforming to spherical harmonics...    ", calculation, 1, end="",
        silent=silent)
    U = jnp.asarray(molecule.spherical_transformation)
    S, T, V_NE, D, Q = _spherical_one_electron(U, S, T, V_NE, D, Q)
    if ERI is not None:
        ERI = _spherical_eri(U, ERI)
    jax.block_until_ready((S, T, V_NE, D, Q, ERI))
    log("[Done]\n", calculation, 1, silent=silent)
    timer("Spherical harmonic transformation", 1)
    return S, T, V_NE, D, Q, ERI


# --- Integral plan cache (one compiled engine per chemical system/basis) ---

_PLAN_CACHE: dict = {}


def get_integral_plan(molecule) -> IntegralPlan:
    key = tuple(
        (bf.lmn, bf.atom_index, tuple(bf.exps.tolist()), tuple(bf.coefs.tolist()))
        for bf in molecule.cartesian_basis_functions
    ) + (molecule.n_atoms,)
    if key not in _PLAN_CACHE:
        _PLAN_CACHE[key] = IntegralPlan(molecule.cartesian_basis_functions,
                                        molecule.n_atoms)
    return _PLAN_CACHE[key]


def calculate_analytical_integrals(molecule, calculation, silent) -> Integrals:
    """One- and two-electron integrals in the (spherical) AO basis."""
    coords = molecule.coordinates
    if molecule.n_atoms == 2 and (np.abs(coords[:, :2]) > 1e-10).any():
        error("Molecule is incorrectly aligned! Unable to calculate molecular integrals.")

    direct = bool(getattr(calculation, "direct_scf", False))
    memory_bytes = 8 * molecule.n_cartesian_basis**4
    log(f" Memory required for two-electron integrals is "
        f"{memory_bytes / 1e9:.2f} GB\n", calculation, 3, silent=silent)
    if memory_bytes > 12e9 and not direct:
        error("Not enough memory to store two-electron integrals! "
              'Use the "DIRECT" keyword (integral-direct SCF) or a smaller '
              "basis set.")

    plan = get_integral_plan(molecule)

    log(" Calculating one-electron integrals...     ", calculation, 1, end="", silent=silent)
    timer("One-electron integrals", 0)
    S, T, V_NE, D, Q = plan.one_electron(
        jnp.asarray(coords), jnp.asarray(molecule.charges, dtype=jnp.float64),
        molecule.centre_of_mass)
    # Stage timers wait for the device, so they time the work, not its enqueue
    jax.block_until_ready((S, T, V_NE, D, Q))
    timer("One-electron integrals", 1)
    log("[Done]", calculation, 1, silent=silent)

    if direct:
        # Integral-direct SCF: J/K are contracted against the quartet values
        # as they are generated (IntegralPlan.fock_direct), so the N^4 tensor
        # is never formed.  An upgrade over the reference, which can only
        # store it (tuna_kernel.py:392-406).
        log(" Two-electron integrals deferred (integral-direct SCF).",
            calculation, 1, silent=silent)
        ERI = None
    else:
        log(" Calculating two-electron integrals...     ", calculation, 1, end="", silent=silent)
        timer("Two-electron integrals", 0)
        ERI = jax.block_until_ready(plan.eri(jnp.asarray(coords)))
        timer("Two-electron integrals", 1)
        log("[Done]", calculation, 1, silent=silent)

    S, T, V_NE, D, Q, ERI = transform_to_spherical_harmonics(
        S, T, V_NE, D, Q, ERI, molecule, calculation, silent)

    # Regression guard: an array committed to the CPU here would drag every
    # downstream jit onto the host.  Fail loudly instead.
    from ..ops.device_guard import assert_on_accelerator
    assert_on_accelerator(
        {"S": S, "T": T, "V_NE": V_NE, "D": D, "Q": Q, "ERI": ERI},
        stage="integral generation")
    return Integrals(S, T, V_NE, D, Q, ERI)


# --- CBS extrapolation (tuna_kernel.py:152-248) ---------------------------

EXTRAPOLATION_ALPHA = {
    "CC-PVDZ": 4.42, "CC-PVTZ": 5.46, "CC-PVQZ": 9.74, "CC-PV5Z": 9.74,
    "AUG-CC-PVDZ": 4.30, "AUG-CC-PVTZ": 5.79, "AUG-CC-PVQZ": 9.71, "AUG-CC-PV5Z": 9.71,
    "D-AUG-CC-PVDZ": 4.30, "D-AUG-CC-PVTZ": 5.79, "D-AUG-CC-PVQZ": 9.71, "D-AUG-CC-PV5Z": 9.71,
    "T-AUG-CC-PVDZ": 4.30, "T-AUG-CC-PVTZ": 5.79, "T-AUG-CC-PVQZ": 9.71, "T-AUG-CC-PV5Z": 9.71,
    "PC-1": 7.02, "PC-2": 9.78, "PC-3": 9.78,
    "DEF2-SVP": 10.39, "DEF2-TZVPP": 7.88, "DEF2-TZVP": 7.88,
    "DEF2-SVPD": 10.39, "DEF2-TZVPPD": 7.88, "DEF2-TZVPD": 7.88,
    "ANO-PVDZ": 5.41, "ANO-PVTZ": 4.48, "ANO-PVQZ": 4.48,
    "AUG-ANO-PVDZ": 5.12, "AUG-ANO-PVTZ": 5.00, "AUG-ANO-PVQZ": 5.00,
}

ZETA_PARAMS = {
    "double": ("Double", "Triple", 2, 3, 2.4),
    "triple": ("Triple", "Quadruple", 3, 4, 3.0),
    "quadruple": ("Quadruple", "Quintuple", 4, 5, 3.0),
    "quintuple": ("Quintuple", "Sextuple", 5, 6, 3.0),
}


def extrapolate_energies(small_basis, E_SCF_small, E_SCF_large, E_corr_small,
                         E_corr_large, small_basis_zeta):
    """Two-point CBS extrapolation (ORCA-compatible formulas)."""
    alpha = EXTRAPOLATION_ALPHA.get(small_basis)
    if alpha is None:
        error("Your chosen basis set is not parameterised for extrapolation!")
    _, _, n_small, n_large, beta = ZETA_PARAMS[small_basis_zeta]
    E_SCF_cbs = E_SCF_small + (E_SCF_large - E_SCF_small) / (
        1 - np.exp(alpha * (np.sqrt(n_small) - np.sqrt(n_large))))
    E_corr_cbs = (n_small**beta * E_corr_small - n_large**beta * E_corr_large) / (
        n_small**beta - n_large**beta)
    return E_SCF_cbs, E_corr_cbs


def print_molecule_information(molecule, calculation, silent=False):
    n_occ, n_virt = ((molecule.n_occ, molecule.n_virt)
                     if calculation.reference == "UHF"
                     else (molecule.n_occ // 2, molecule.n_virt // 2))
    log(" ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~", calculation, 1, silent=silent)
    log("    Molecule and Basis Information", calculation, 1, silent=silent)
    log(" ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~", calculation, 1, silent=silent)
    log("  Molecular structure: " + molecule.molecular_structure, calculation, 1, silent=silent)
    log("\n  Number of basis functions: " + str(molecule.n_basis), calculation, 1, silent=silent)
    log("  Number of primitive Gaussians: " + str(int(np.sum(molecule.primitive_Gaussians))),
        calculation, 1, silent=silent)
    log("\n  Charge: " + str(molecule.charge), calculation, 1, silent=silent)
    log("  Multiplicity: " + str(molecule.multiplicity), calculation, 1, silent=silent)
    log("  Number of electrons: " + str(molecule.n_electrons), calculation, 1, silent=silent)
    log("  Number of alpha electrons: " + str(molecule.n_alpha), calculation, 1, silent=silent)
    log("  Number of beta electrons: " + str(molecule.n_beta), calculation, 1, silent=silent)
    log("  Number of occupied orbitals: " + str(n_occ), calculation, 1, silent=silent)
    log("  Number of virtual orbitals: " + str(n_virt), calculation, 1, silent=silent)
    log(f"\n  Point group: {molecule.point_group}", calculation, 1, silent=silent)
    if calculation.diatomic:
        log(f"  Bond length: {constants.bohr_to_angstrom(molecule.bond_length):.5f} ",
            calculation, 1, silent=silent)
    log(" ~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~\n", calculation, 1, silent=silent)


def print_reference_type(method, calculation, silent):
    ref_type = "Kohn-Sham" if method.density_functional_method else "Hartree-Fock"
    prefix = "restricted" if calculation.reference == "RHF" else "unrestricted"
    log(f" Beginning {prefix} {ref_type} calculation...  \n", calculation, 1, silent=silent)
