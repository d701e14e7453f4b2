"""The mixed-precision Newton--Krylov CC finisher must reach the same fixed
point as the pure-f64 while_loop solver, starting from an f32-converged
amplitude set.  The driver no longer routes to this solver (the f64
while_loop serves every backend), so these tests call it directly."""

import time

import jax.numpy as jnp
import numpy as np
import pytest

from tuna_tpu.cli import parse_input, process_method
from tuna_tpu.config import Config
from tuna_tpu.drivers.energy import calculate_energy
from tuna_tpu.post import transforms
from tuna_tpu.post.cc import CCSettings, get_cc_solver, get_newton_finisher


def _mo_problem(config_line):
    calc_type, method_string, basis, symbols, coordinates, params = \
        parse_input(config_line)
    cfg = Config(calc_type, process_method(method_string), time.time(), params,
                 basis, symbols, suppress_output=True)
    SCF_output, molecule, _, _ = calculate_energy(
        cfg, symbols, coordinates, silent=True, do_correlation=False)
    g, _, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
        molecule, SCF_output.integrals.ERI_AO, SCF_output, cfg, silent=True)
    g = g.swapaxes(1, 2)
    epsilons = jnp.asarray(epsilons)
    F = jnp.diag(epsilons)
    d1 = transforms.singles_epsilons(epsilons, o, v)
    d2 = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    return cfg, g, F, d1, d2, o, v


@pytest.fixture(scope="module")
def n2_sto3g():
    return _mo_problem("SPE : N N 1.1 : CCSD STO-3G : TIGHTSCF")


def _settings(cfg, method, o, v, d2):
    from tuna_tpu.post.cc import _NO_DISCONNECTED, _NO_SINGLES
    return CCSettings(
        method=method, restricted=True,
        update_singles=method not in _NO_SINGLES,
        keep_disconnected=method not in _NO_DISCONNECTED,
        n_occ=o.stop - (o.start or 0), n_virt=int(d2.shape[-1]),
        max_iter=cfg.correlated_max_iter, use_diis=True,
        max_diis=cfg.max_DIIS_matrices, damping=0.0)


@pytest.mark.parametrize("method", ["CCSD", "CCD", "CISD"])
def test_newton_matches_f64_solver(n2_sto3g, method):
    cfg, g, F, d1, d2, o, v = n2_sto3g
    settings = _settings(cfg, method, o, v, d2)
    solver = get_cc_solver(settings)
    finisher = get_newton_finisher(settings)

    t1_0 = d1 * F[o, v]
    t2_0 = g[o, o, v, v] * d2
    dummy, d3 = jnp.zeros((1, 1)), jnp.zeros((1,))

    # Reference: pure f64 while_loop solve
    (n64, conv64, fail64, E64, t1_64, t2_64, _, _, _) = solver(
        g, F, d1, d2, t1_0, t2_0, dummy, dummy, dummy, d3, 1e-10, 1e-8)
    assert bool(conv64) and not bool(fail64)

    # Production path: f32 warm solve, then the Newton finisher
    f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
    (nw, convw, failw, _, t1_w, t2_w, _, _, _) = solver(
        f32(g), f32(F), f32(d1), f32(d2), f32(t1_0), f32(t2_0),
        f32(dummy), f32(dummy), f32(dummy), f32(d3), 1e-7, 1e-5)
    assert bool(convw) and not bool(failw)

    (nn, convn, failn, En, t1_n, t2_n, hist, _) = finisher(
        g, F, d1, d2, jnp.asarray(t1_w, dtype=jnp.float64),
        jnp.asarray(t2_w, dtype=jnp.float64), dummy, dummy, dummy, d3,
        1e-10, 1e-8)
    assert bool(convn) and not bool(failn)
    assert int(nn) <= 4, f"Newton took {int(nn)} steps (expected <= 4)"

    assert abs(float(En) - float(E64)) < 1e-10, (
        f"{method}: Newton E {float(En):.12f} vs f64 solver {float(E64):.12f}")
    assert float(jnp.max(jnp.abs(t2_n - t2_64))) < 1e-8


def test_newton_from_unconverged_start(n2_sto3g):
    """Starting further from the fixed point (raw MP2 guess in f64), Newton
    must still converge -- more steps, same answer."""
    cfg, g, F, d1, d2, o, v = n2_sto3g
    settings = _settings(cfg, "CCSD", o, v, d2)
    solver = get_cc_solver(settings)
    finisher = get_newton_finisher(settings)

    t1_0 = d1 * F[o, v]
    t2_0 = g[o, o, v, v] * d2
    dummy, d3 = jnp.zeros((1, 1)), jnp.zeros((1,))
    (_, conv64, _, E64, _, _, _, _, _) = solver(
        g, F, d1, d2, t1_0, t2_0, dummy, dummy, dummy, d3, 1e-10, 1e-8)
    assert bool(conv64)

    (nn, convn, failn, En, _, _, _, _) = finisher(
        g, F, d1, d2, t1_0, t2_0, dummy, dummy, dummy, d3, 1e-10, 1e-8)
    assert bool(convn) and not bool(failn)
    assert abs(float(En) - float(E64)) < 1e-10


@pytest.mark.parametrize("line", [
    "SPE : N N 1.1 : CCSD STO-3G : TIGHTSCF",
    "SPE : LI H 1.6 : UCCSD STO-3G : CH 1 ML 2 NOROTATE TIGHTSCF",
    # CC2/CC3 rebuild T1-dressed MO integrals inside the residual; round 4
    # extended the fused warm+Newton production path to them.
    "SPE : N N 1.1 : CC2 STO-3G : TIGHTSCF",
    "SPE : LI H 1.6 : CC3 STO-3G : TIGHTSCF",
])
def test_production_driver_path(monkeypatch, line):
    """The fused f32 warm + Newton finisher production solve, called with
    exactly the operands the CC driver builds, must reproduce the driver's
    f64 solve for restricted AND unrestricted CC (CC2/CC3 included)."""
    from tuna_tpu.cli import run
    import tuna_tpu.post.cc as cc

    captured = {}
    real_get = cc.get_cc_solver

    def capture(settings):
        solver = real_get(settings)

        def wrapper(*args):
            captured["settings"], captured["args"] = settings, args
            return solver(*args)

        return wrapper

    monkeypatch.setattr(cc, "get_cc_solver", capture)
    run(line, suppress_output=True)
    settings, args = captured["settings"], captured["args"]
    plain = real_get(settings)(*args)
    mixed = cc.get_production_solver(settings)(*args)
    n_conv, n_failed, E_mixed = mixed[4], mixed[5], mixed[6]
    assert bool(n_conv) and not bool(n_failed)
    assert abs(float(plain[3]) - float(E_mixed)) < 1e-9, (plain[3], E_mixed)
