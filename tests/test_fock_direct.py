"""Direct (never-materialise-N^4) Fock build must match the dense J/K
contractions for every shell structure.  This is the large-basis SCF path:
peak memory is the row chunk's (R, n_pairs) workspace instead of the N^4
tensor the reference pre-flight-checks host RAM for."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from tuna_tpu.cli import parse_input, process_method
from tuna_tpu.config import Config
from tuna_tpu.ops.integrals import IntegralPlan
from tuna_tpu.scf import coulomb_matrix, exchange_matrix
from tuna_tpu.system import Molecule


def _plan(line, R_bohr=1.8):
    ct, ms, basis, symbols, _, params = parse_input(line)
    cfg = Config(ct, process_method(ms), time.time(), params, basis, symbols,
                 suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, R_bohr]])
    mol = Molecule(list(symbols), coords, cfg)
    return IntegralPlan(mol.cartesian_basis_functions, mol.n_atoms), coords


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : HF STO-3G",        # s only
    "SPE : N N 1.1 : HF 6-31G",          # s, p
    "SPE : H H 0.74 : HF CC-PVDZ",       # s, p on H
    "SPE : LI H 1.6 : HF 6-311G",        # mixed centres
])
def test_direct_matches_dense(line):
    plan, coords = _plan(line)
    rng = np.random.RandomState(3)
    n = plan.n_basis
    P = rng.randn(n, n)
    P = jnp.asarray(P + P.T)

    coords = jnp.asarray(coords)
    ERI = plan.eri(coords)
    J_ref = coulomb_matrix(P, ERI)
    K_ref = exchange_matrix(P, ERI)

    J, K = plan.fock_direct(coords, P)
    assert np.max(np.abs(np.asarray(J - J_ref))) < 1e-10, line
    assert np.max(np.abs(np.asarray(K - K_ref))) < 1e-10, line


def test_direct_small_chunks():
    """Chunking must not change results (padding rows are inert)."""
    plan, coords = _plan("SPE : N N 1.1 : HF STO-3G")
    ct, ms, basis, symbols, _, params = parse_input("SPE : N N 1.1 : HF STO-3G")
    cfg = Config(ct, process_method(ms), time.time(), params, basis, symbols,
                 suppress_output=True)
    mol = Molecule(list(symbols), np.asarray(coords), cfg)
    plan3 = IntegralPlan(mol.cartesian_basis_functions, mol.n_atoms,
                         eri_row_chunk=3)

    rng = np.random.RandomState(5)
    n = plan.n_basis
    P = rng.randn(n, n)
    P = jnp.asarray(P + P.T)
    coords = jnp.asarray(coords)
    J1, K1 = plan.fock_direct(coords, P)
    J2, K2 = plan3.fock_direct(coords, P)
    assert np.max(np.abs(np.asarray(J1 - J2))) < 1e-11
    assert np.max(np.abs(np.asarray(K1 - K2))) < 1e-11


@pytest.mark.parametrize("line_pair", [
    ("SPE : H H 0.74 : HF 6-31G : TIGHTSCF",
     "SPE : H H 0.74 : HF 6-31G : DIRECT TIGHTSCF"),
    ("SPE : LI H 1.6 : UHF 6-31G : CH 1 ML 2 TIGHTSCF",
     "SPE : LI H 1.6 : UHF 6-31G : CH 1 ML 2 DIRECT TIGHTSCF"),
])
def test_direct_scf_matches_stored(line_pair):
    """End-to-end: the DIRECT keyword (integral-direct SCF, N^4 tensor never
    formed) must reproduce the stored-tensor SCF energy."""
    from tuna_tpu.cli import run
    stored, direct = line_pair
    E_stored = run(stored, suppress_output=True)[2]
    E_direct = run(direct, suppress_output=True)[2]
    assert abs(E_stored - E_direct) < 1e-9, (E_stored, E_direct)
