"""Self-consistent field engine: RHF/UHF (and RKS/UKS) as a single jitted
jax.lax.while_loop living entirely on device.

Accelerator-first redesign of the reference SCF module
(/root/reference/TUNA/tuna_scf.py): the iteration semantics (Fock build,
commutator-DIIS with a ring buffer, Zerner-Hehenberger dynamic damping,
four-condition convergence, energy decomposition mixing the fresh density
with the previous iteration's J/K) follow the reference exactly so converged
energies agree to machine precision, but there is no per-iteration host
round-trip: iteration statistics are recorded into a fixed buffer and printed
after the loop completes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..containers import Integrals, Output
from ..ops import linalg
from ..output import error, log, log_big_spacer, timer


# ---------------------------------------------------------------------------
# Small pure helpers (shared with guess / post-SCF modules)
# ---------------------------------------------------------------------------

def symmetrise(M):
    return 0.5 * (M + M.T)


def coulomb_matrix(P, ERI):
    return jnp.einsum("ijkl,kl->ij", ERI, P, optimize=True)


def exchange_matrix(P, ERI):
    return jnp.einsum("ilkj,kl->ij", ERI, P, optimize=True)


def density_matrix(mos, n_occ: int, n_per_orbital: int):
    occ = mos[:, :n_occ]
    return symmetrise(n_per_orbital * occ @ occ.T)


def diagonalise_fock(F, X):
    """Orthogonalise, polished-eigh diagonalise, back-transform."""
    F_ortho = symmetrise(X.T @ F @ X)
    eps, vecs = linalg.eigh(F_ortho)
    return eps, X @ vecs


def clean_density_matrix(P, S, n_electrons: int):
    """Rescale so Tr(PS) = n_electrons (tuna_dft.py:35-41)."""
    if n_electrons <= 0:
        return jnp.zeros_like(P)
    return P * (n_electrons / jnp.trace(P @ S))


# ---------------------------------------------------------------------------
# Static settings (jit cache key)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SCFSettings:
    reference: str           # "RHF" | "UHF"
    n_basis: int
    n_alpha: int
    n_beta: int
    max_iter: int
    use_diis: bool
    max_diis: int
    use_damping: bool
    dynamic_damping: bool    # damping_factor is None -> Mulliken-driven
    partition_0: int         # AOs on first atom (for dynamic damping)
    n_atoms: int
    dft: bool = False
    functional_class: str = "LDA"


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

_STAT_COLS = 6  # E_total, dE, rmsDP, maxDP, commutator, damping


def _mulliken_populations(P, S, settings: SCFSettings):
    diag = jnp.diagonal(P @ S)
    if settings.n_atoms == 1:
        return jnp.array([jnp.sum(diag), 0.0])
    k = settings.partition_0
    return jnp.array([jnp.sum(diag[:k]), jnp.sum(diag[k:])])


def _dynamic_damping_factor(P_new, P_old_damped, P_old_raw, P_very_old_damped,
                            S, settings: SCFSettings, max_damping):
    """Zerner-Hehenberger population-oscillation damping (tuna_scf.py:839-861)."""
    A_n_out = _mulliken_populations(P_new, S, settings)
    A_n1_in = _mulliken_populations(P_old_damped, S, settings)
    A_n1_out = _mulliken_populations(P_old_raw, S, settings)
    A_n2_in = _mulliken_populations(P_very_old_damped, S, settings)

    denominator = A_n_out - A_n1_out - A_n1_in + A_n2_in
    safe = jnp.abs(denominator) > 1e-300
    alpha = jnp.where(safe, (A_n_out - A_n1_out) / jnp.where(safe, denominator, 1.0), 0.0)
    alpha = jnp.where(jnp.all(safe), alpha, jnp.zeros_like(alpha))

    if settings.n_atoms == 2:
        n0 = settings.partition_0
        n1 = settings.n_basis - n0
        factor = (alpha[0] * n0 + alpha[1] * n1) / (n0 + n1)
    else:
        factor = alpha[0]
    factor = jnp.maximum(factor, 0.0)
    return jnp.minimum(factor, max_damping)


def _apply_damping(P_new, P_old_damped, P_old_raw, P_very_old_damped, commutator,
                   S, settings: SCFSettings, static_factor, max_damping, step):
    if not settings.use_damping:
        return P_new, jnp.asarray(0.0, dtype=P_new.dtype)
    if not settings.dynamic_damping:
        factor = static_factor
    else:
        dynamic = _dynamic_damping_factor(P_new, P_old_damped, P_old_raw,
                                          P_very_old_damped, S, settings, max_damping)
        factor = jnp.where((commutator > 0.01) & (step > 1), dynamic, 0.0)
    return factor * P_old_damped + (1.0 - factor) * P_new, factor


def _diis_error(F, P, S, X):
    err = X.T @ (F @ P @ S - S @ P @ F) @ X
    commutator = jnp.sqrt(jnp.mean(err * err))
    return commutator, err


def _diis_extrapolate(fock_buf, err_buf, n_valid, X, settings: SCFSettings):
    """Solve the DIIS equations on the ring buffer; returns (ok, F_a, F_b).

    The error ring arrives in f32 (see body): the Gram matrix and bordered
    solve then run in f32 ops --
    coefficient error only multiplies the residual-sized spread of the
    stored Fock matrices, so the SCF fixed point is unaffected.  Only the
    final extrapolation einsum runs in the Fock dtype."""
    M = settings.max_diis
    dtype = err_buf.dtype
    valid = jnp.arange(M) < n_valid                       # (M,)
    errs = jnp.where(valid[:, None], err_buf, 0.0)
    B = errs @ errs.T                                      # (M, M)
    # Masked, bordered DIIS system: invalid slots become identity rows.
    # The Gram block is pre-scaled to O(1) (the bordered solution c is
    # invariant under B -> B/s; only the Lagrange multiplier rescales) so
    # the f32 elimination stays accurate when late-iteration entries are
    # squared commutators ~1e-24.
    vv = valid[:, None] & valid[None, :]
    s = jnp.maximum(jnp.max(jnp.abs(jnp.where(vv, B, 0.0))), 1e-30)
    B = jnp.where(vv, B / s, 0.0) + jnp.where(jnp.eye(M, dtype=bool) & ~valid[:, None],
                                              1.0, 0.0)
    Bfull = jnp.zeros((M + 1, M + 1), dtype=dtype)
    Bfull = Bfull.at[:M, :M].set(B)
    Bfull = Bfull.at[:M, M].set(jnp.where(valid, -1.0, 0.0))
    Bfull = Bfull.at[M, :M].set(jnp.where(valid, -1.0, 0.0))
    rhs = jnp.zeros(M + 1, dtype=dtype).at[M].set(-1.0)
    coeffs, ok = linalg.solve_linear_small(Bfull, rhs)
    coeffs = jnp.where(valid, coeffs[:M], 0.0)
    # Exact sum-to-one so solve error only multiplies the Fock spread.
    csum = jnp.sum(coeffs)
    coeffs = coeffs / jnp.where(jnp.abs(csum) > 1e-3, csum, 1.0)
    ok = ok & (jnp.abs(csum) > 1e-3) & jnp.all(jnp.isfinite(coeffs))
    coeffs = coeffs.astype(fock_buf.dtype)
    F_a = jnp.einsum("m,mij->ij", coeffs, fock_buf[:, 0])
    F_b = jnp.einsum("m,mij->ij", coeffs, fock_buf[:, 1])
    return ok, F_a, F_b


def _push_ring(buf, entry, n_valid, max_n):
    """Append to a fixed ring buffer, evicting the oldest when full."""
    full = n_valid >= max_n
    shifted = jnp.where(full, jnp.roll(buf, -1, axis=0), buf)
    idx = jnp.where(full, max_n - 1, n_valid)
    return shifted.at[idx].set(entry), jnp.minimum(n_valid + 1, max_n)


def _electronic_energy(P_a, P_b, J_a, J_b, K_a, K_b, T, V_NE, Fld, G,
                       HFX_prop, restricted: bool, E_x_grid=0.0, E_c_grid=0.0):
    P = P_a + P_b
    kinetic = jnp.sum(P * T)
    nuclear_electron = jnp.sum(P * V_NE)
    field = jnp.sum(P * Fld)
    field_gradient = jnp.sum(P * G)
    coulomb = 0.5 * jnp.sum(P * (J_a + J_b))
    if restricted:
        exchange = -0.25 * jnp.sum(P * (K_a + K_b)) * HFX_prop + E_x_grid
    else:
        exchange = -0.5 * (jnp.sum(P_a * K_a) + jnp.sum(P_b * K_b)) * HFX_prop + E_x_grid
    correlation = jnp.zeros_like(kinetic) + E_c_grid
    total = kinetic + nuclear_electron + coulomb + exchange + correlation + field + field_gradient
    components = jnp.stack([kinetic, nuclear_electron, coulomb, exchange,
                            correlation, field, field_gradient])
    return total, components


def make_scf_kernel_fn(settings: SCFSettings, xc_closure=None, fock_closure=None,
                       tp_mesh=None):
    """Build the SCF while_loop UNJITTED for a given static configuration.

    Batched callers (tuna_tpu.parallel) vmap this function and jit the
    vmapped result; serial callers use get_scf_kernel (jitted + cached).

    xc_closure(P_a, P_b) -> (V_XC_a, V_XC_b, E_x_grid, E_c_grid,
                             density, alpha_density, beta_density)
    or None for Hartree-Fock.  Grid arrays are closed over as constants.

    fock_closure(coords, P) -> (J, K) replaces the stored-ERI einsums with a
    direct (integral-regenerating) build -- the large-basis path where the
    N^4 tensor is never materialised; the ERI argument is then a dummy.
    Coordinates are a kernel ARGUMENT (not baked into the closure) so that
    repeated geometries (OPT/FREQ/scans) reuse one compiled kernel.

    tp_mesh: a 1-D jax.sharding.Mesh -> the stored ERI tensor is treated as
    SHARDED over the mesh's axis (first AO index) and J/K are built with
    parallel.fock_build_sharded -- the over-HBM tensor-parallel path (the
    caller device_puts the ERI with the matching NamedSharding).
    """
    restricted = settings.reference == "RHF"
    N = settings.n_basis
    M = settings.max_diis

    if tp_mesh is not None:
        from .. import parallel as _par  # deferred: parallel imports scf

        def _jk(P_spin, ERI):
            return _par.fock_build_sharded(ERI, P_spin, tp_mesh)
    else:
        def _jk(P_spin, ERI):
            return coulomb_matrix(P_spin, ERI), exchange_matrix(P_spin, ERI)

    def body_core(carry, jk, args):
        """One SCF iteration given the J/K matrices."""
        (T, V_NE, S, X, Fld, G, HFX_prop, DFX_prop, DFC_prop,
         conv_dE, conv_maxDP, conv_rmsDP, conv_comm,
         static_damping, max_damping) = args
        dtype = T.dtype
        zeros = jnp.zeros((N, N), dtype=dtype)

        (step, E, P_a, P_b, P_old_a, P_old_b, P_raw_prev_a, P_raw_prev_b,
         P_very_old_a, P_very_old_b, fock_buf, err_buf, n_valid,
         converged, stats, outs) = carry

        if True:  # (indentation preserved from the loop-body original)
            # densities at loop start become the "old" quantities
            P = P_a + P_b

            if xc_closure is not None:
                (V_XC_a, V_XC_b, E_x_grid, E_c_grid, density, dens_a, dens_b) = xc_closure(
                    P_a, P_b, HFX_prop, DFX_prop, DFC_prop)
            else:
                V_XC_a = V_XC_b = zeros
                E_x_grid = E_c_grid = jnp.asarray(0.0, dtype=dtype)
                density = dens_a = dens_b = jnp.zeros((1,), dtype=dtype)

            # Fock assembly from the given J/K
            J_a, K_a, J_b, K_b = jk
            if restricted:
                F_a = symmetrise(T + V_NE + Fld + G + 2.0 * J_a - K_a * HFX_prop + V_XC_a)
                F_b = F_a
            else:
                F_a = symmetrise(T + V_NE + J_a + J_b + Fld + G - K_a * HFX_prop + V_XC_a)
                F_b = symmetrise(T + V_NE + J_a + J_b + Fld + G - K_b * HFX_prop + V_XC_b)

            # DIIS error from pre-diagonalisation Fock and density
            comm_a, err_a = _diis_error(F_a, P_a, S, X)
            comm_b, err_b = _diis_error(F_b, P_b, S, X)
            commutator = jnp.maximum(comm_a, comm_b)

            fock_buf2, _ = _push_ring(fock_buf, jnp.stack([F_a, F_b]), n_valid, M)
            # The error ring stays in the working dtype: an f32 ring was
            # measured to push HeH+/6-31G final energies 1.1e-8 off the
            # independent-solver fixed point (the near-singular late-SCF
            # Gram amplifies the 1e-7 entry noise), violating the 1e-8
            # parity contract.  The CC solver CAN run its ring in f32
            # because its Newton finisher re-certifies the energy in f64.
            err_buf2, n_valid2 = _push_ring(
                err_buf, jnp.concatenate([err_a.ravel(), err_b.ravel()]),
                n_valid, M)

            # Diagonalise and rebuild densities
            eps_a, mos_a = diagonalise_fock(F_a, X)
            if restricted:
                eps_b, mos_b = eps_a, mos_a
                P_new_a = density_matrix(mos_a, settings.n_alpha, 2) / 2.0
                P_new_b = P_new_a
            else:
                eps_b, mos_b = diagonalise_fock(F_b, X)
                P_new_a = density_matrix(mos_a, settings.n_alpha, 1)
                P_new_b = density_matrix(mos_b, settings.n_beta, 1)

            # Energy: fresh density against the old iteration's J/K (reference
            # semantics, tuna_scf.py:1137-1141)
            E_old = E
            E_new, components = _electronic_energy(
                P_new_a, P_new_b, J_a, J_b, K_a, K_b, T, V_NE, Fld, G,
                HFX_prop, restricted, E_x_grid, E_c_grid)

            # DIIS extrapolation of the density
            if settings.use_diis:
                ok, F_a_x, F_b_x = _diis_extrapolate(fock_buf2, err_buf2, n_valid2, X, settings)
                do_diis = (step > 2) & (commutator < 0.3)

                def diis_density():
                    eps_ax, mos_ax = diagonalise_fock(F_a_x, X)
                    if restricted:
                        Pa = density_matrix(mos_ax, settings.n_alpha, 2) / 2.0
                        return Pa, Pa
                    eps_bx, mos_bx = diagonalise_fock(F_b_x, X)
                    return (density_matrix(mos_ax, settings.n_alpha, 1),
                            density_matrix(mos_bx, settings.n_beta, 1))

                P_diis_a, P_diis_b = diis_density()
                use = do_diis & ok
                P_new_a = jnp.where(use, P_diis_a, P_new_a)
                P_new_b = jnp.where(use, P_diis_b, P_new_b)
                # singular DIIS system resets the buffers (tuna_scf.py:1038-1048)
                reset = do_diis & ~ok
                n_valid2 = jnp.where(reset, 0, n_valid2)

            P_raw_a, P_raw_b = P_new_a, P_new_b

            # Damping against the previous damped densities
            comm_for_damp_a = comm_a if not restricted else commutator
            comm_for_damp_b = comm_b if not restricted else commutator
            P_damp_a, damping_a = _apply_damping(
                P_new_a, P_a, P_raw_prev_a, P_very_old_a, comm_for_damp_a,
                S, settings, static_damping, max_damping, step)
            P_damp_b, damping_b = _apply_damping(
                P_new_b, P_b, P_raw_prev_b, P_very_old_b, comm_for_damp_b,
                S, settings, static_damping, max_damping, step)
            damping = jnp.maximum(damping_a, damping_b)

            P_final = P_damp_a + P_damp_b
            delta_E = E_new - E_old
            delta_P = P_final - P
            max_DP = jnp.max(jnp.abs(delta_P))
            rms_DP = jnp.sqrt(jnp.mean(delta_P**2))

            is_conv = ((jnp.abs(delta_E) < conv_dE) & (max_DP < conv_maxDP)
                       & (rms_DP < conv_rmsDP) & (commutator < conv_comm))

            stats = stats.at[step - 1].set(jnp.stack(
                [E_new, delta_E, rms_DP, max_DP, commutator, damping]))

            outs = dict(outs)
            outs["mos_a"], outs["mos_b"] = mos_a, mos_b
            outs["eps_a"], outs["eps_b"] = eps_a, eps_b
            outs["F_a"], outs["F_b"] = F_a, F_b
            outs["components"] = components
            outs["density"], outs["dens_a"], outs["dens_b"] = density, dens_a, dens_b

            return (step + 1, E_new, P_damp_a, P_damp_b, P_a, P_b,
                    P_raw_a, P_raw_b, P_old_a, P_old_b,
                    fock_buf2, err_buf2, n_valid2, is_conv, stats, outs)

    def init_carry(P_a0, P_b0, E0, dtype):
        zeros = jnp.zeros((N, N), dtype=dtype)
        grid_size = 1
        outs0 = {
            "mos_a": zeros, "mos_b": zeros,
            "eps_a": jnp.zeros(N, dtype=dtype), "eps_b": jnp.zeros(N, dtype=dtype),
            "F_a": zeros, "F_b": zeros,
            "components": jnp.zeros(7, dtype=dtype),
            "density": jnp.zeros((grid_size,), dtype=dtype),
            "dens_a": jnp.zeros((grid_size,), dtype=dtype),
            "dens_b": jnp.zeros((grid_size,), dtype=dtype),
        }
        if xc_closure is not None:
            outs0["density"] = outs0["dens_a"] = outs0["dens_b"] = xc_closure.zero_density()

        return (jnp.asarray(1), jnp.asarray(E0, dtype=dtype), P_a0, P_b0,
                zeros, zeros, zeros, zeros, zeros, zeros,
                jnp.zeros((M, 2, N, N), dtype=dtype),
                jnp.zeros((M, 2 * N * N), dtype=dtype),
                jnp.asarray(0), jnp.asarray(False),
                jnp.zeros((settings.max_iter, _STAT_COLS), dtype=dtype), outs0)

    def jk_from(carry, ERI, coords):
        """J/K for the carry's densities -- traced inside the while_loop."""
        P_a, P_b = carry[2], carry[3]
        if fock_closure is not None:
            J_a, K_a = fock_closure(coords, P_a)
        else:
            J_a, K_a = _jk(P_a, ERI)
        if restricted:
            J_b, K_b = J_a, K_a
        elif fock_closure is not None:
            J_b, K_b = fock_closure(coords, P_b)
        else:
            J_b, K_b = _jk(P_b, ERI)
        return J_a, K_a, J_b, K_b

    def finalize(final):
        (step, E, P_a, P_b, *_rest) = final
        stats = final[-2]
        outs = final[-1]
        converged = final[-3]
        return (step - 1, converged, E, P_a, P_b, stats, outs)

    def kernel(T, V_NE, ERI, S, X, Fld, G, coords, P_a0, P_b0, E0,
               HFX_prop, DFX_prop, DFC_prop,
               conv_dE, conv_maxDP, conv_rmsDP, conv_comm,
               static_damping, max_damping):
        args = (T, V_NE, S, X, Fld, G, HFX_prop, DFX_prop, DFC_prop,
                conv_dE, conv_maxDP, conv_rmsDP, conv_comm,
                static_damping, max_damping)

        def body(carry):
            return body_core(carry, jk_from(carry, ERI, coords), args)

        def cond(carry):
            step, converged = carry[0], carry[-3]
            return (step <= settings.max_iter) & ~converged

        carry0 = init_carry(P_a0, P_b0, E0, T.dtype)
        final = jax.lax.while_loop(cond, body, carry0)
        return finalize(final)

    return kernel


def _make_scf_kernel(settings: SCFSettings, xc_closure=None, fock_closure=None,
                     tp_mesh=None):
    return jax.jit(make_scf_kernel_fn(settings, xc_closure, fock_closure,
                                      tp_mesh))


_KERNEL_CACHE: dict = {}


def _closure_token(closure):
    """Stable cache identity for a kernel closure.  Closures that are reused
    across geometries (e.g. an IntegralPlan's direct-Fock build) carry a
    `cache_token`; falling back to id() keys one kernel per closure object,
    which is correct but recompiles when callers rebuild closures."""
    if closure is None:
        return None
    return getattr(closure, "cache_token", id(closure))


def _mesh_token(mesh):
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), mesh.devices.shape,
            tuple(d.id for d in mesh.devices.flat))


def get_scf_kernel(settings: SCFSettings, xc_closure=None, fock_closure=None,
                   tp_mesh=None):
    key = (settings, _closure_token(xc_closure), _closure_token(fock_closure),
           _mesh_token(tp_mesh))
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = _make_scf_kernel(settings, xc_closure,
                                              fock_closure, tp_mesh)
    return _KERNEL_CACHE[key]


# ---------------------------------------------------------------------------
# Host-level driver
# ---------------------------------------------------------------------------

def run_self_consistent_field(molecule, calculation, integrals: Integrals, V_NN,
                              X, guess_objects, grid_container=None, silent=False,
                              xc_closure=None, fock_closure=None) -> Output:
    """Run the SCF loop and assemble the Output container."""
    timer("Self-consistent field", 0)
    P, P_alpha, P_beta, E_guess = guess_objects

    log(" Beginning self-consistent field cycle...\n", calculation, 1, silent=silent)
    log(f' Using "{calculation.SCF_conv["name"]}" SCF convergence criteria.',
        calculation, 1, silent=silent)
    _log_acceleration(calculation, silent)

    log_big_spacer(calculation, silent=silent)
    log("                                   Self-consistent Field Cycle Iterations",
        calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent)
    log("  Step          E                 DE             RMS(DP)          MAX(DP)           Error       Damping",
        calculation, 1, silent=silent)
    log_big_spacer(calculation, silent=silent)

    settings = SCFSettings(
        reference=calculation.reference,
        n_basis=int(integrals.n_basis),
        n_alpha=molecule.n_alpha,
        n_beta=molecule.n_beta,
        max_iter=calculation.max_iter,
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        use_damping=bool(calculation.damping),
        dynamic_damping=calculation.damping_factor is None,
        partition_0=int(molecule.partition_ranges[0]),
        n_atoms=molecule.n_atoms,
        dft=calculation.DFT_calculation,
        functional_class=calculation.functional.functional_class,
    )

    # Tensor-parallel routing: when the stored ERI tensor exceeds the
    # per-device HBM budget and more than one device is visible, shard its
    # first AO axis over the mesh and build J/K with
    # parallel.fock_build_sharded (one all_gather per build) --
    # SURVEY.md section 2.3's TP mapping for the cc-pV5Z/6Z memory wall.
    tp_mesh = None
    if fock_closure is None and integrals.ERI_AO is not None:
        from .. import parallel as _par  # deferred: parallel imports scf
        tp_mesh = _par.auto_tp_mesh(8.0 * float(integrals.n_basis) ** 4)
        if tp_mesh is not None:
            log(f" Stored two-electron tensor sharded over "
                f"{len(tp_mesh.devices.flat)} devices (tensor-parallel Fock "
                "build).", calculation, 1, silent=silent)

    Fld = integrals.F if integrals.F is not None else jnp.zeros_like(integrals.S)
    G = integrals.G if integrals.G is not None else jnp.zeros_like(integrals.S)
    conv = calculation.SCF_conv
    static_damping = calculation.damping_factor if calculation.damping_factor is not None else 0.0

    kernel = get_scf_kernel(settings, xc_closure, fock_closure, tp_mesh)
    ERI_arg = (integrals.ERI_AO if integrals.ERI_AO is not None
               else jnp.zeros((1, 1, 1, 1)))
    if tp_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        n_dev = len(tp_mesh.devices.flat)
        ERI_arg = jnp.asarray(ERI_arg)
        pad = (-ERI_arg.shape[0]) % n_dev  # device_put needs
        if pad:             # divisibility; zero rows give zero J/K rows
            ERI_arg = jnp.pad(ERI_arg, ((0, pad),) + ((0, 0),) * 3)
        ERI_arg = jax.device_put(
            ERI_arg,
            NamedSharding(tp_mesh, PartitionSpec(tp_mesh.axis_names[0])))
    n_steps, converged, E, P_a, P_b, stats, outs = kernel(
        integrals.T, integrals.V_NE, ERI_arg, integrals.S, X, Fld, G,
        jnp.asarray(molecule.coordinates),
        jnp.asarray(P_alpha), jnp.asarray(P_beta), E_guess,
        calculation.HFX_prop, calculation.DFX_prop, calculation.DFC_prop,
        conv["delta_E"], conv["max_DP"], conv["RMS_DP"], conv["commutator"],
        static_damping, calculation.max_damping)

    n_steps = int(n_steps)
    stats = np.array(stats)
    for i in range(n_steps):
        E_it, dE, rms, mx, comm, damp = stats[i]
        damp_str = f"{damp:.3f}" if damp != 0 else " ---"
        log(f"  {i + 1:3.0f}  {E_it + V_NN:16.10f}  {dE:16.10f} {rms:16.10f} "
            f"{mx:16.10f} {comm:16.10f}     {damp_str}", calculation, 1, silent=silent)

    if not bool(converged):
        error(f"Self-consistent field not converged in {calculation.max_iter} "
              "iterations! Increase maximum iterations or give up.")

    log_big_spacer(calculation, silent=silent)
    log(f"\n Self-consistent field converged in {n_steps} cycles!\n",
        calculation, 1, silent=silent)

    P_total = P_a + P_b
    restricted = calculation.reference == "RHF"
    mos_a, mos_b = outs["mos_a"], outs["mos_b"]
    eps_a, eps_b = outs["eps_a"], outs["eps_b"]

    if restricted:
        mos, eps = mos_a, eps_a
        F_a = F_b = outs["F_a"] / 2.0
    else:
        eps_comb = np.concatenate([np.array(eps_a), np.array(eps_b)]) \
            if molecule.n_electrons > 1 else np.array(eps_a)
        mos_comb = np.concatenate([np.array(mos_a), np.array(mos_b)], axis=1) \
            if molecule.n_electrons > 1 else np.array(mos_a)
        order = np.argsort(eps_comb)
        eps = eps_comb[order]
        mos = mos_comb[:, order]
        F_a, F_b = outs["F_a"], outs["F_b"]

    k, ne, co, ex, corr, fe, fge = [float(x) for x in np.array(outs["components"])]

    output = Output(
        energy=float(E) + float(V_NN),
        kinetic_energy=k, nuclear_electron_energy=ne, coulomb_energy=co,
        exchange_energy=ex, correlation_energy=corr,
        electric_field_energy=fe, electric_field_gradient_energy=fge,
        P=P_total, P_alpha=P_a, P_beta=P_b, S=integrals.S, X=X,
        molecular_orbitals=mos, molecular_orbitals_alpha=mos_a,
        molecular_orbitals_beta=mos_b,
        epsilons=eps, epsilons_alpha=eps_a, epsilons_beta=eps_b,
        density=outs["density"], alpha_density=outs["dens_a"],
        beta_density=outs["dens_b"],
        F_alpha=F_a, F_beta=F_b, T=integrals.T, V_NE=integrals.V_NE,
        integrals=integrals,
    )
    timer("Self-consistent field", 1)
    return output


def _log_acceleration(calculation, silent):
    damping = calculation.damping
    factor = calculation.damping_factor
    if calculation.DIIS:
        msg = f" Using DIIS, storing {calculation.max_DIIS_matrices} matrices, for convergence acceleration"
        if damping:
            msg += ", with static damping." if factor else ", with dynamic damping."
        else:
            msg += "."
        log(msg, calculation, silent=silent)
    elif damping:
        kind = "static" if factor else "dynamic"
        log(f" Using {kind} damping for convergence acceleration.", calculation, silent=silent)
    else:
        log(" No convergence acceleration used.", calculation, 1, silent=silent)
    log("", calculation, silent=silent)
