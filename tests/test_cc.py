"""Coupled cluster tests built on physics degeneracies: for two-electron
systems CCSD = CISD = QCISD = FCI, and restricted (spin-adapted) vs
unrestricted (spin-orbital) implementations must agree on closed shells."""

import numpy as np
import pytest

from tuna_tpu.cli import run


def final_energy(line):
    _, _, energy, _ = run(line, suppress_output=True)
    return energy


def test_h2_fci_degeneracies():
    """All doubles-complete methods hit FCI for two electrons."""
    E_ccsd = final_energy("SPE : H H 0.74 : CCSD 6-31G")
    E_cisd = final_energy("SPE : H H 0.74 : CISD 6-31G")
    E_qcisd = final_energy("SPE : H H 0.74 : QCISD 6-31G")
    assert abs(E_ccsd - E_cisd) < 1e-9
    assert abs(E_ccsd - E_qcisd) < 1e-9
    # CCSD(T) on a 2-electron system reduces to CISD (method complexity reduction)
    E_ccsd_t = final_energy("SPE : H H 0.74 : CCSD[T] 6-31G")
    assert abs(E_ccsd_t - E_cisd) < 1e-9


def test_rccsd_equals_uccsd():
    E_r = final_energy("SPE : LI H 1.6 : CCSD STO-3G")
    E_u = final_energy("SPE : LI H 1.6 : UCCSD STO-3G : NOROTATE")
    assert abs(E_r - E_u) < 1e-8


def test_rccd_equals_uccd():
    E_r = final_energy("SPE : LI H 1.6 : CCD STO-3G")
    E_u = final_energy("SPE : LI H 1.6 : UCCD STO-3G : NOROTATE")
    assert abs(E_r - E_u) < 1e-8


def test_rlccd_equals_ulccd():
    E_r = final_energy("SPE : H H 0.74 : LCCD 6-31G")
    E_u = final_energy("SPE : H H 0.74 : ULCCD 6-31G : NOROTATE")
    assert abs(E_r - E_u) < 1e-8


def test_cepa_is_lccsd():
    """CEPA(0) aliases to LCCSD via keyword processing."""
    E_cepa = final_energy("SPE : H H 0.74 : CEPA0 6-31G")
    E_lccsd = final_energy("SPE : H H 0.74 : LCCSD 6-31G")
    assert abs(E_cepa - E_lccsd) < 1e-10


def test_correlation_hierarchy():
    """|E_LCCD| >= |E_CCD| and CCSD below CCD for LiH."""
    E_hf = final_energy("SPE : LI H 1.6 : HF 6-31G")
    E_ccd = final_energy("SPE : LI H 1.6 : CCD 6-31G")
    E_ccsd = final_energy("SPE : LI H 1.6 : CCSD 6-31G")
    assert E_ccd < E_hf
    assert E_ccsd <= E_ccd + 1e-9


def test_ccsd_t_n2_sto3g():
    """CCSD and (T) run for a triple-bonded system; (T) is negative."""
    SCF_output, molecule, E_total, _ = run("SPE : N N 1.1 : CCSD[T] STO-3G",
                                           suppress_output=True)
    E_hf = SCF_output.energy
    assert E_total < E_hf
    E_ccsd = final_energy("SPE : N N 1.1 : CCSD STO-3G")
    assert E_total < E_ccsd  # (T) adds negative correlation


def test_ccsd_t_paren_spelling_matches_bracket():
    """CCSD(T) (parenthesis spelling, registered as its own method) computes
    the same Lee-formulation correction as CCSD[T].  The reference registers
    it (tuna_util.py:1355) but crashes on it with a TypeError inside
    apply_damping; here both spellings run and agree exactly."""
    E_paren = final_energy("SPE : LI H 1.6 : CCSD(T) STO-3G : TIGHTSCF")
    E_bracket = final_energy("SPE : LI H 1.6 : CCSD[T] STO-3G : TIGHTSCF")
    assert abs(E_paren - E_bracket) < 1e-12
    assert abs(E_paren - (-7.8823222714)) < 1e-9


def test_uccsd_t_open_shell():
    """Spin-orbital CCSD(T) runs for an open-shell doublet."""
    E = final_energy("SPE : LI H 1.6 : UCCSD[T] STO-3G : CH 1 ML 2")
    E_hf = final_energy("SPE : LI H 1.6 : UHF STO-3G : CH 1 ML 2")
    assert E < E_hf


def test_cc2_close_to_mp2():
    """CC2 energies sit near MP2 for well-behaved systems."""
    E_cc2 = final_energy("SPE : H H 0.74 : CC2 6-31G")
    E_mp2 = final_energy("SPE : H H 0.74 : MP2 6-31G")
    assert abs(E_cc2 - E_mp2) < 5e-3


def test_fused_residual_matches_unfused():
    """The fused-contraction CCSD residual (blocked matmuls, post/cc.py
    _r_ccsd) must reproduce the one-einsum-per-term reference map exactly,
    with and without the singles channel."""
    import jax.numpy as jnp
    import numpy as np
    from tuna_tpu.post import cc

    rng = np.random.RandomState(3)
    no, nv = 5, 11
    n = no + nv
    g = jnp.asarray(rng.randn(n, n, n, n) * 0.1)
    F = jnp.asarray(rng.randn(n, n) * 0.1)
    o, v = slice(0, no), slice(no, None)
    d1 = jnp.asarray(rng.rand(no, nv) + 0.5)
    d2 = jnp.asarray(rng.rand(no, no, nv, nv) + 0.5)
    t1 = jnp.asarray(rng.randn(no, nv) * 0.05)
    t2 = jnp.asarray(rng.randn(no, no, nv, nv) * 0.05)

    B = cc._restricted_blocks(g, o, v)
    for freeze in (False, True):
        a1, a2 = cc._r_ccsd_unfused(B, F[o, v], d1, d2, t1, t2, {},
                                    freeze_singles=freeze)
        b1, b2 = cc._r_ccsd(B, F[o, v], d1, d2, t1, t2, {},
                            freeze_singles=freeze)
        assert float(jnp.max(jnp.abs(a1 - b1))) < 1e-13, freeze
        assert float(jnp.max(jnp.abs(a2 - b2))) < 1e-13, freeze
