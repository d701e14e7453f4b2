"""Parity tests for the on-device integral engine against an independent
NumPy McMurchie-Davidson oracle (tests/oracle_integrals.py)."""

import numpy as np
import pytest

from tuna_tpu.config import Config
from tuna_tpu.methods import lookup_method
from tuna_tpu.ops.integrals import IntegralPlan, cross_overlap
from tuna_tpu.system import Molecule

import oracle_integrals as oracle


def make_molecule(symbols, bond_angstrom, basis, params=()):
    import tuna_tpu.constants as const

    cfg = Config("SPE", lookup_method("HF"), 0.0, list(params), basis, symbols, suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0],
                       [0.0, 0.0, const.angstrom_to_bohr(bond_angstrom)]])[: len(symbols)]
    return Molecule(symbols, coords, cfg), cfg


CASES = [
    (["H", "H"], 0.74, "STO-3G"),
    (["N", "N"], 1.10, "6-31G"),
    (["H", "F"], 0.95, "6-31G**"),     # polarisation: d on F, p on H
    (["LI", "H"], 1.60, "CC-PVDZ"),    # heteronuclear with p and d shells
]


@pytest.mark.parametrize("symbols,bond,basis", CASES)
def test_one_electron_parity(symbols, bond, basis):
    mol, cfg = make_molecule(symbols, bond, basis)
    plan = IntegralPlan(mol.cartesian_basis_functions, mol.n_atoms)
    com = mol.centre_of_mass
    S, T, V, D, Q = plan.one_electron(mol.coordinates, mol.charges.astype(float), com)

    S_ref, T_ref, V_ref, D_ref, Q_ref = oracle.one_electron_matrices(
        mol.cartesian_basis_functions, mol.atoms, np.array([0.0, 0.0, com]))

    np.testing.assert_allclose(np.array(S), S_ref, atol=1e-12)
    np.testing.assert_allclose(np.array(T), T_ref, atol=1e-11)
    np.testing.assert_allclose(np.array(V), V_ref, atol=1e-11)
    np.testing.assert_allclose(np.array(D), D_ref, atol=1e-12)
    np.testing.assert_allclose(np.array(Q), Q_ref, atol=1e-12)


@pytest.mark.parametrize("symbols,bond,basis", [
    (["H", "H"], 0.74, "STO-3G"),
    (["H", "H"], 0.90, "6-31G**"),
    (["LI", "H"], 1.60, "STO-3G"),
])
def test_eri_parity(symbols, bond, basis):
    mol, cfg = make_molecule(symbols, bond, basis)
    plan = IntegralPlan(mol.cartesian_basis_functions, mol.n_atoms)
    eri = np.array(plan.eri(mol.coordinates))
    eri_ref = oracle.eri_tensor(mol.cartesian_basis_functions)
    np.testing.assert_allclose(eri, eri_ref, atol=1e-11)


def test_eri_d_function_quartet():
    """Spot-check an ERI with d functions against the oracle."""
    mol, cfg = make_molecule(["H", "F"], 0.95, "6-31G**")
    plan = IntegralPlan(mol.cartesian_basis_functions, mol.n_atoms)
    eri = np.array(plan.eri(mol.coordinates))
    bfs = mol.cartesian_basis_functions
    # pick indices that include a d function on F (lmn sum == 2)
    d_idx = next(i for i, bf in enumerate(bfs) if bf.l_total == 2)
    p_idx = next(i for i, bf in enumerate(bfs) if bf.l_total == 1)
    checks = [(d_idx, p_idx, 0, 1), (d_idx, d_idx, d_idx, d_idx),
              (d_idx, 0, p_idx, 1), (0, 0, d_idx, d_idx)]
    for i, j, k, l in checks:
        ref = oracle.contracted_eri(bfs[i], bfs[j], bfs[k], bfs[l])
        np.testing.assert_allclose(eri[i, j, k, l], ref, atol=1e-12)


def test_cross_overlap():
    mol_big, _ = make_molecule(["N", "N"], 1.10, "6-31G")
    mol_small, _ = make_molecule(["N", "N"], 1.10, "STO-3G")
    S_cross = cross_overlap(mol_big.cartesian_basis_functions,
                            mol_small.cartesian_basis_functions)
    for i in (0, 3, 7):
        for j in (0, 2, 5):
            ref = oracle.contracted(oracle.overlap_prim,
                                    mol_big.cartesian_basis_functions[i],
                                    mol_small.cartesian_basis_functions[j])
            np.testing.assert_allclose(S_cross[i, j], ref, atol=1e-12)


def test_normalisation():
    """Contracted Cartesian diagonal overlaps are 1."""
    for symbols, bond, basis in CASES:
        mol, _ = make_molecule(symbols, bond, basis)
        plan = IntegralPlan(mol.cartesian_basis_functions, mol.n_atoms)
        S = np.array(plan.one_electron(mol.coordinates, mol.charges.astype(float), mol.centre_of_mass)[0])
        np.testing.assert_allclose(np.diag(S), np.ones(len(S)), atol=1e-12)
