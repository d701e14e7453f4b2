"""Multi-device execution: batched geometries sharded over a jax.sharding.Mesh.

The natural data axis for diatomics is the geometry batch -- PES scans,
finite-difference stencils, MD ensembles (SURVEY.md section 2.3).  Here the
whole mean-field pipeline (on-device integrals -> jitted SCF while_loop) is
vmapped over a batch of bond lengths and the batch axis is sharded over the
"dp" mesh axis, so every chip solves its own geometries with one compiled
executable and XLA/GSPMD places the data.  This is an upgrade over the
single-process reference, which walks scan points serially
(tuna_energy.py:975-1085).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from .drivers import common
from .ops import linalg
from .scf import SCFSettings, get_scf_kernel
from .system import Molecule


def device_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.array(devices[:n]), (axis,))


# Per-device budget for one tensor before it is sharded across the mesh
# instead of replicated: a share of the device's own memory limit, leaving
# the rest to the executable's working set (Fock build, DIIS rings, MO
# transform).  The environment override serves tests and other setups.
_HBM_BUDGET_ENV = "TUNA_TPU_HBM_BUDGET_BYTES"
_HBM_BUDGET_FRACTION = 0.5


def tp_hbm_budget_bytes() -> float:
    """Bytes one device may hold of a single tensor.  A device that reports
    no memory limit (the CPU backend) never shards unless the override is
    set: no size is assumed for an unknown device."""
    import os
    override = os.environ.get(_HBM_BUDGET_ENV)
    if override:
        return float(override)
    stats = jax.devices()[0].memory_stats() or {}
    if "bytes_limit" not in stats:
        return float("inf")
    return _HBM_BUDGET_FRACTION * float(stats["bytes_limit"])


def auto_tp_mesh(n_bytes: float, axis: str = "tp") -> Mesh | None:
    """A 1-D tensor-parallel Mesh over all visible devices when the given
    tensor size exceeds the per-device HBM budget and more than one device
    is visible; None otherwise (the serial single-device path).

    This is the production router for the over-HBM paths: the stored-ERI
    Fock build (`fock_build_sharded`) and the transform-direct MO transform
    (`ops.motransform.pair_packed_to_mo_sharded`) -- SURVEY.md section 2.3's
    TP mapping (cc-pV6Z ERI = 32 GB, reference Manual section 7.2).
    """
    devices = jax.devices()
    if len(devices) < 2 or n_bytes <= tp_hbm_budget_bytes():
        return None
    return Mesh(np.array(devices), (axis,))


def fock_build_sharded(ERI, P_total, mesh: Mesh | None = None, axis: str = "tp"):
    """Coulomb and exchange matrices with the ERI tensor sharded over chips.

    The N^4 ERI is the memory wall for big basis sets (3-32 GB at
    cc-pV5Z/6Z, reference Manual section 7.2); sharding its first AO axis
    over the mesh keeps each chip holding N/n_dev * N^3 while J and K rows
    are produced locally and combined with one all_gather over the interconnect:

        J_i. = sum_kl (i.|kl) P_kl      (row-local)
        K_i. = sum_kl (il|k.) P_kl      (row-local in chemists' storage)
    """
    from jax import lax

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), (axis,))
    n_dev = int(np.prod(mesh.devices.shape))
    spec_rows = PartitionSpec(axis)
    spec_full = PartitionSpec()

    # shard_map needs the sharded axis divisible by the mesh size; pad the
    # row axis with zero rows (zero ERI rows give zero J/K rows, sliced
    # off).  Callers may pre-pad (jax.device_put also needs divisibility),
    # so the true AO count is the SECOND axis.
    N = ERI.shape[1]
    pad = (-ERI.shape[0]) % n_dev
    if pad:
        ERI = jnp.pad(ERI, ((0, pad), (0, 0), (0, 0), (0, 0)))

    def local_rows(ERI_block, P):
        J_rows = jnp.einsum("ijkl,kl->ij", ERI_block, P, optimize=True)
        K_rows = jnp.einsum("ilkj,kl->ij", ERI_block, P, optimize=True)
        stacked = jnp.stack([J_rows, K_rows])
        gathered = lax.all_gather(stacked, axis, axis=1, tiled=True)
        return gathered[0], gathered[1]

    J, K = jax.shard_map(local_rows, mesh=mesh,
                         in_specs=(spec_rows, spec_full),
                         out_specs=(spec_full, spec_full),
                         check_vma=False)(ERI, P_total)
    # rows may have been padded here OR pre-padded by the caller (device_put
    # needs divisibility too) -- always slice back to the true AO count
    return J[:N], K[:N]


def _batched_inputs(calculation, atomic_symbols, bond_lengths):
    """Per-geometry integrals, orthogonalisers, core guesses and (for DFT)
    quadrature grids, stacked, plus per-geometry metadata for property
    evaluation.  "E_add" collects the per-point classical additive terms
    (nuclear repulsion + D2 dispersion) the SCF electronic energy lacks."""
    mats = {"T": [], "V": [], "ERI": [], "S": [], "X": [], "Pa": [], "Pb": [],
            "E_add": []}
    is_dft = bool(calculation.DFT_calculation)
    needs_vv10 = _needs_vv10(calculation)
    if is_dft:
        from .dft import grid as dft_grid
        mats["BFS"], mats["W"], mats["GRADS"] = [], [], []
        if needs_vv10:
            mats["PTS"] = []
    meta = []
    molecule = None
    for R in bond_lengths:
        coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, float(R)]])
        molecule = Molecule(list(atomic_symbols), coords, calculation)
        integrals = common.calculate_analytical_integrals(molecule, calculation, True)
        molecule.process_basis_functions(calculation, int(integrals.n_basis))
        X, _, _ = common.calculate_orthogonalisation_matrix(integrals.S, calculation, True)

        H = np.asarray(integrals.T) + np.asarray(integrals.V_NE)
        Xn = np.asarray(X)
        _, C0 = np.linalg.eigh(Xn.T @ H @ Xn)
        C0 = Xn @ C0
        P_a = C0[:, :molecule.n_alpha] @ C0[:, :molecule.n_alpha].T
        P_b = C0[:, :molecule.n_beta] @ C0[:, :molecule.n_beta].T

        mats["T"].append(np.asarray(integrals.T))
        mats["V"].append(np.asarray(integrals.V_NE))
        mats["ERI"].append(np.asarray(integrals.ERI_AO))
        mats["S"].append(np.asarray(integrals.S))
        mats["X"].append(Xn)
        mats["Pa"].append(P_a)
        mats["Pb"].append(P_b)
        V_NN = (float(np.prod([float(c) for c in molecule.charges]))
                / float(R))
        E_disp = common.calculate_additive_dispersion_energy(
            molecule, calculation, True)
        mats["E_add"].append(V_NN + float(E_disp))
        if is_dft:
            # Grid dimensions come from grid_parameters (geometry-independent
            # for a fixed element pair + accuracy tier), so the per-point
            # grid tensors stack into one regular batch axis.
            bfs_g, w_g, grads_g, _pts = dft_grid.set_up_integration_grid(
                molecule, jnp.asarray(P_a), jnp.asarray(P_b), calculation,
                silent=True)
            mats["BFS"].append(np.asarray(bfs_g))
            mats["W"].append(np.asarray(w_g))
            mats["GRADS"].append(np.asarray(grads_g)
                                 if grads_g is not None else None)
            if needs_vv10:
                mats["PTS"].append(np.asarray(_pts))
        meta.append({"coordinates": coords,
                     "centre_of_mass": molecule.centre_of_mass,
                     "charges": molecule.charges,
                     "D": [np.asarray(Dc) for Dc in integrals.D],
                     "integrals": integrals,
                     "E_disp": float(E_disp)})
    if is_dft and mats["GRADS"] and mats["GRADS"][0] is None:
        mats["GRADS"] = None
    stacked = {k: (jnp.asarray(np.stack(vs)) if vs is not None else None)
               for k, vs in mats.items()}
    return molecule, stacked, meta


def _needs_vv10(calculation):
    """The post-SCF VV10 term applies with the NL keyword or the B97M-V
    functional (drivers/energy.py:200)."""
    return (getattr(calculation, "VV10", False)
            or calculation.method.name == "B97M-V")


def mean_field_batchable(calculation, *, fields_free=True):
    """True when a calculation's SCF solves can ride the sharded batch
    kernels below: mean-field HF/UHF or pure/hybrid DFT (grids become a
    stacked batch axis; the post-SCF VV10 term is added per point by
    dft.vv10.vv10_energies_batch; double hybrids stay serial -- their MP2
    stage is not in the kernel), stored integrals (DIRECT closes over
    per-geometry coordinates) and no CBS extrapolation.  `fields_free`
    additionally requires no applied field -- geometry batches share the
    field-free kernel signature, while the field batch
    (field_energies_parallel) naturally owns its field axis."""
    plain_hf = calculation.method.name in ("HF", "UHF")
    batchable_dft = (calculation.DFT_calculation
                     and not getattr(calculation, "MPC_prop", 0))
    ok = ((plain_hf or batchable_dft)
          and not getattr(calculation, "extrapolate", False)
          and not getattr(calculation, "direct_scf", False))
    if fields_free:
        ok = (ok and not np.any(calculation.electric_field)
              and not np.any(calculation.electric_field_gradient))
    return ok


def _solve_points(calculation, atomic_symbols, bond_lengths,
                  mesh: Mesh | None = None, return_orbitals=False):
    """Core sharded batch solve: converged SCF energies, convergence flags,
    total densities and per-point metadata for a batch of bond lengths.
    With return_orbitals, additionally returns the per-point converged MO
    coefficients and eigenvalues plus the (shared-shape) Molecule -- the
    inputs the batched correlated post-processing needs."""
    if mesh is None:
        mesh = device_mesh()

    # Pad the batch to a multiple of the mesh size (replicating the last
    # geometry) so the leading axis shards evenly; padded results are trimmed.
    n_points = len(bond_lengths)
    n_dev = int(np.prod(mesh.devices.shape))
    n_padded = -(-n_points // n_dev) * n_dev
    padded = list(bond_lengths) + [bond_lengths[-1]] * (n_padded - n_points)

    molecule, batch, meta = _batched_inputs(calculation, atomic_symbols,
                                            padded)
    settings = SCFSettings(
        reference=calculation.reference,
        n_basis=int(batch["S"].shape[-1]),
        n_alpha=molecule.n_alpha, n_beta=molecule.n_beta,
        max_iter=calculation.max_iter,
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        use_damping=bool(calculation.damping),
        dynamic_damping=calculation.damping_factor is None,
        partition_0=int(molecule.partition_ranges[0]),
        n_atoms=molecule.n_atoms)

    conv = calculation.SCF_conv
    static_damping = calculation.damping_factor or 0.0
    zeros = jnp.zeros_like(batch["S"])

    coords_dummy = jnp.zeros((molecule.n_atoms, 3))
    is_dft = bool(calculation.DFT_calculation)

    def kernel_call(kern, T, V, ERI, S, X, Pa, Pb):
        n_steps, converged, E, P_a, P_b, _, outs = kern(
            T, V, ERI, S, X, zeros[0], zeros[0], coords_dummy, Pa, Pb, 0.0,
            calculation.HFX_prop, calculation.DFX_prop, calculation.DFC_prop,
            conv["delta_E"], conv["max_DP"], conv["RMS_DP"], conv["commutator"],
            static_damping, calculation.max_damping)
        if return_orbitals:
            return (E, converged, P_a + P_b, outs["mos_a"], outs["eps_a"],
                    outs["mos_b"], outs["eps_b"])
        return E, converged, P_a + P_b

    axis = mesh.axis_names[0]
    shard_b = NamedSharding(mesh, PartitionSpec(axis))

    if is_dft:
        # The per-geometry quadrature grids ride the same batch axis as the
        # integrals: one UNJITTED kernel (make_scf_kernel_fn) whose XC
        # closure consumes the vmapped grid tracers, vmapped + jitted as a
        # whole.  The serial path's jitted-kernel cache is bypassed -- the
        # grid arrays must be arguments, not trace constants, for GSPMD to
        # shard them.
        from .dft import make_xc_fn
        from .scf import make_scf_kernel_fn
        xc_fn, _needs_gradient = make_xc_fn(calculation)
        have_grads = batch.get("GRADS") is not None
        n_grid = int(batch["W"].shape[1] * batch["W"].shape[2])

        def solve_one_dft(T, V, ERI, S, X, Pa, Pb, bfs, w, grads):
            def xc_closure(P_a, P_b, HFX, DFX, DFC):
                return xc_fn(P_a, P_b, HFX, DFX, DFC, bfs, w, grads)
            xc_closure.zero_density = lambda: jnp.zeros((n_grid,),
                                                        dtype=w.dtype)
            kern = make_scf_kernel_fn(settings, xc_closure)
            return kernel_call(kern, T, V, ERI, S, X, Pa, Pb)

        grads_batch = batch["GRADS"] if have_grads else batch["W"]
        grads_axis = 0 if have_grads else None

        def solve_one(T, V, ERI, S, X, Pa, Pb, bfs, w, grads):
            return solve_one_dft(T, V, ERI, S, X, Pa, Pb, bfs, w,
                                 grads if have_grads else None)

        n_out = 7 if return_orbitals else 3
        batched = jax.jit(
            jax.vmap(solve_one,
                     in_axes=(0,) * 9 + (grads_axis,)),
            in_shardings=(shard_b,) * 9
            + ((shard_b,) if have_grads else (None,)),
            out_shardings=(shard_b,) * n_out)
        out = batched(
            batch["T"], batch["V"], batch["ERI"], batch["S"], batch["X"],
            batch["Pa"], batch["Pb"], batch["BFS"], batch["W"], grads_batch)
        energies, converged, P = out[:3]
        if return_orbitals:
            orbitals = out[3:7]
    else:
        kernel = get_scf_kernel(settings)

        def solve_one(T, V, ERI, S, X, Pa, Pb):
            return kernel_call(kernel, T, V, ERI, S, X, Pa, Pb)

        n_out = 7 if return_orbitals else 3
        batched = jax.jit(
            jax.vmap(solve_one),
            in_shardings=(shard_b,) * 7,
            out_shardings=(shard_b,) * n_out)
        out = batched(batch["T"], batch["V"], batch["ERI"],
                      batch["S"], batch["X"], batch["Pa"], batch["Pb"])
        energies, converged, P = out[:3]
        if return_orbitals:
            orbitals = out[3:7]
    energies = (np.asarray(energies) + np.asarray(batch["E_add"]))[:n_points]
    P = np.asarray(P)[:n_points]
    converged = np.asarray(converged)[:n_points]
    if is_dft and _needs_vv10(calculation):
        # Post-SCF non-local dispersion per point, batched over the same
        # stacked grids (serial counterpart: drivers/energy.py:200-204)
        from .dft import vv10
        energies = energies + vv10.vv10_energies_batch(
            P, np.asarray(batch["BFS"])[:n_points],
            np.asarray(batch["GRADS"])[:n_points],
            np.asarray(batch["W"])[:n_points],
            np.asarray(batch["PTS"])[:n_points],
            calculation.functional)
    if return_orbitals:
        orbitals = tuple(np.asarray(x)[:n_points] for x in orbitals)
        return (energies, converged, P, meta[:n_points], orbitals, molecule)
    return energies, converged, P, meta[:n_points]


def _restricted_reference(calculation, atomic_symbols):
    """The RHF/UHF reference is only decided once a Molecule is processed
    (system.py:263-269), so replicate that decision from the multiplicity,
    electron parity and method flags."""
    from .periodic import make_atom
    n_electrons = (sum(make_atom(s.upper(), (0.0, 0.0, 0.0)).charge
                       for s in atomic_symbols)
                   - calculation.charge)
    multiplicity = calculation.multiplicity
    if calculation.default_multiplicity and n_electrons % 2 != 0:
        multiplicity = 2
    return (multiplicity == 1 and not calculation.method.unrestricted
            and calculation.method.restricted_available)


def _scan_common_ok(calculation, allow_extrapolate=False):
    return not (calculation.DFT_calculation
                or (getattr(calculation, "extrapolate", False)
                    and not allow_extrapolate)
                or getattr(calculation, "direct_scf", False)
                or getattr(calculation, "read_checkpoint", False)
                or np.any(calculation.electric_field)
                or np.any(calculation.electric_field_gradient))


_MPN_SCAN_METHODS = ("MP2", "SCS-MP2", "MP3", "SCS-MP3",
                     "MP4", "MP4[SDTQ]", "MP4(SDTQ)", "MP4[SDQ]", "MP4(SDQ)",
                     "MP4[DQ]", "MP4(DQ)")


def mp2_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Restricted closed-form MPn scans ride the batch too: the batched SCF
    returns per-point orbitals and the MP2/MP3/MP4 energies are pure vmapped
    functions of (ERI_AO, C, epsilons).  Iterative/orbital-optimised/Laplace
    variants and spin-orbital (UHF) MPn stay serial; MP3/MP4 with FREEZECORE
    stay serial (the serial cores assume an unfrozen occupied block)."""
    name = calculation.method.name
    if name not in _MPN_SCAN_METHODS:
        return False
    if name not in ("MP2", "SCS-MP2") and calculation.freeze_core:
        return False
    return (_scan_common_ok(calculation, allow_extrapolate)
            and _restricted_reference(calculation, atomic_symbols))


def dh_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Double-hybrid scans ride the batch: the sharded DFT SCF returns
    per-point orbitals and the MP2 stage (scaled by the functional's MPC
    coefficient, with SCS where the functional is spin-scaled) is the same
    vmapped closed form the MPn scans use.  Excited-state/TD and
    relaxed-density variants stay serial.  Serial counterpart:
    drivers/post_scf.py:120-127."""
    return (bool(calculation.DFT_calculation)
            and float(getattr(calculation, "MPC_prop", 0.0) or 0.0) > 0.0
            and not (getattr(calculation, "extrapolate", False)
                     and not allow_extrapolate)
            and not getattr(calculation, "direct_scf", False)
            and not getattr(calculation, "read_checkpoint", False)
            and not np.any(calculation.electric_field)
            and not np.any(calculation.electric_field_gradient)
            and not calculation.time_dependent
            and not calculation.method.excited_state_method
            and not getattr(calculation, "relaxed_density", False)
            and _restricted_reference(calculation, atomic_symbols))


# Restricted iterative methods whose amplitude solver (ONE while_loop,
# post/cc._build_cc_solver_fn) vmaps over the geometry batch; CC2/CC3 (AO
# tensor threaded through every iteration) and triples-and-higher stay
# serial.  [T]/(T) suffixes batch too -- the perturbative correction is a
# pure function of the converged amplitudes.
_CC_SCAN_BASES = ("LCCD", "CCD", "LCCSD", "CID", "CISD", "QCISD", "CCSD")


def _cc_base_name(name):
    for tag in ("[T]", "(T)"):
        name = name.split(tag)[0]
    return name


def cc_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Restricted CC/CI scans (CCSD family incl. perturbative triples) ride
    the batch: per-point MO integrals and MP2 guess amplitudes feed one
    vmapped amplitude while_loop."""
    return (_cc_base_name(calculation.method.name) in _CC_SCAN_BASES
            and calculation.method.name not in ("CC2", "CC3")
            and _scan_common_ok(calculation, allow_extrapolate)
            and _restricted_reference(calculation, atomic_symbols))


def _batched_restricted_mp2(calculation, molecule, ERI_b, mos, eps,
                            eri_axis=0):
    """Vmapped closed-form restricted MP2/SCS-MP2 correlation energies for a
    batch of converged points (transform + energy in ONE jitted call).
    eri_axis=None broadcasts a single AO tensor over the batch (one geometry,
    many field points)."""
    from .post import mp as mp_mod
    from .post import transforms

    o = slice(molecule.n_core_orbitals if calculation.freeze_core else 0,
              molecule.n_doubly_occ)
    v = slice(molecule.n_doubly_occ, None)
    do_scs = mp_mod._spin_component_scaling_active(calculation)
    ss = calculation.same_spin_scaling if do_scs else 1.0
    osc = calculation.opposite_spin_scaling if do_scs else 1.0

    name = calculation.method.name
    base = calculation.method.method_base      # "MP2" | "MP3" | "MP4"
    n_occ = molecule.n_doubly_occ

    # Double hybrids scale the whole MP2 stage by the functional's MPC
    # coefficient (serial: drivers/post_scf.py:124); DFT never reaches the
    # MP3/MP4 branches below.
    dh_scale = (calculation.MPC_prop if calculation.DFT_calculation else 1.0)

    def one(ERI, C, e):
        MO = transforms.ao_to_mo_chemists(ERI, C)
        g_phys = transforms.chemists_to_physicists(MO)
        e_ijab = transforms.doubles_epsilons(e, e, o, o, v, v)
        E_OS, E_SS, *_ = mp_mod._restricted_mp2_core(
            g_phys[o, o, v, v], e_ijab, n_occ)
        E = (osc * E_OS + ss * E_SS) * dh_scale
        if base in ("MP3", "MP4"):
            # The MP3/MP4 cores consume the CHEMISTS' MO tensor and slice
            # the (unfrozen) occupied block themselves.
            E_MP3, e_ijab3, t_ijab, t_dash, L = mp_mod._restricted_mp3_core(
                MO, e_ijab, n_occ)
            E = E + (calculation.MP3_scaling if name == "SCS-MP3" else 1.0) * E_MP3
            if base == "MP4":
                with_singles = name not in ("MP4[DQ]", "MP4(DQ)")
                with_triples = name in ("MP4", "MP4[SDTQ]", "MP4(SDTQ)")
                E_S, E_D, E_T, E_Q = mp_mod._restricted_mp4_core(
                    MO, e_ijab3, t_ijab, t_dash, L, e, n_occ,
                    with_singles, with_triples)
                E = E + E_S + E_D + E_T + E_Q
        return E

    return np.asarray(jax.jit(jax.vmap(one, in_axes=(eri_axis, 0, 0)))(
        jnp.asarray(ERI_b), jnp.asarray(mos), jnp.asarray(eps)))


def _batched_restricted_cc(calculation, molecule, ERI_b, mos, eps,
                           eri_axis=0):
    """Vmapped restricted CC/CI correlation energies for a batch of
    converged points: MO transform + MP2 guess + the full amplitude
    while_loop (+ perturbative (T)) in ONE jitted call.  Returns
    (E_corr, solver_converged) arrays over the batch.  eri_axis=None
    broadcasts a single AO tensor (one geometry, many field points)."""
    from .post import cc as cc_mod
    from .post import transforms

    name = calculation.method.name
    base = _cc_base_name(name)
    do_T = name != base
    s = molecule.n_core_orbitals if calculation.freeze_core else 0
    ndocc = molecule.n_doubly_occ
    n_mo = int(np.asarray(mos).shape[-1])
    o_full, v_full = slice(s, ndocc), slice(ndocc, None)
    no, nv = ndocc - s, n_mo - ndocc

    settings = cc_mod.CCSettings(
        method=base, restricted=True,
        update_singles=base not in cc_mod._NO_SINGLES,
        keep_disconnected=base not in cc_mod._NO_DISCONNECTED,
        n_occ=no, n_virt=nv,
        max_iter=int(calculation.correlated_max_iter),
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        damping=float(calculation.correlated_damping_parameter),
        o_start=s)
    solver_fn = cc_mod._build_cc_solver_fn(settings)
    dummy, d3_dummy = jnp.zeros((1, 1)), jnp.zeros((1,))

    def one(ERI, C, e):
        MO = transforms.ao_to_mo_chemists(ERI, C)
        g = MO.swapaxes(1, 2)          # chemists -> physicists <pq|rs>
        F = jnp.diag(e)
        e_ia = transforms.singles_epsilons(e, o_full, v_full)
        e_ijab = transforms.doubles_epsilons(e, e, o_full, o_full,
                                             v_full, v_full)
        t_ia = e_ia * F[o_full, v_full]
        t_ijab = g[o_full, o_full, v_full, v_full] * e_ijab
        g_l, F_l = (g[s:, s:, s:, s:], F[s:, s:]) if s else (g, F)
        (n_steps, conv, failed, E_CC, t1, t2, stats, parts, _) = solver_fn(
            g_l, F_l, e_ia, e_ijab, t_ia, t_ijab, dummy, dummy, dummy,
            d3_dummy, calculation.energy_convergence, calculation.amp_conv)
        E = E_CC
        if do_T:
            e_ijkabc = transforms.triples_epsilons(e, o_full, v_full)
            V, W, W_weighted = cc_mod._restricted_T_tensors(
                g[o_full, o_full, v_full, v_full],
                g[o_full, v_full, v_full, v_full],
                g[o_full, o_full, v_full, o_full], t1, t2, e_ijkabc)
            if "QCISD" in base:
                V = V * 2.0
            E_T = (1.0 / 3.0) * jnp.einsum(
                "ijkabc,ijkabc,ijkabc->", W + V, W_weighted, e_ijkabc,
                optimize=True)
            E = E + E_T
        return E, conv & ~failed

    E_corr, ok = jax.jit(jax.vmap(one, in_axes=(eri_axis, 0, 0)))(
        jnp.asarray(ERI_b), jnp.asarray(mos), jnp.asarray(eps))
    return np.asarray(E_corr), np.asarray(ok)


def _solve_points_components(calculation, atomic_symbols, bond_lengths,
                             mesh: Mesh | None = None,
                             allow_extrapolate=False):
    """Batched solve returning the energy COMPONENTS per point:
    (E_scf_total, E_corr, E_disp, converged, P_SCF, meta), where E_scf_total
    = electronic + V_NN + dispersion and E_corr is zero for mean-field
    methods.  The CBS scan needs the split; plain scans sum them."""
    dh_corr = dh_scan_batchable(calculation, atomic_symbols,
                                allow_extrapolate)
    restricted_corr = (dh_corr
                       or mp2_scan_batchable(calculation, atomic_symbols,
                                             allow_extrapolate)
                       or cc_scan_batchable(calculation, atomic_symbols,
                                            allow_extrapolate))
    unrestricted_corr = (not restricted_corr
                         and (ump2_scan_batchable(calculation, atomic_symbols,
                                                  allow_extrapolate)
                              or ucc_scan_batchable(calculation,
                                                    atomic_symbols,
                                                    allow_extrapolate)))
    if restricted_corr:
        (energies, converged, P, meta, orbitals,
         molecule) = _solve_points(calculation, atomic_symbols, bond_lengths,
                                   mesh, return_orbitals=True)
        mos, eps = orbitals[0], orbitals[1]
        ERI_b = np.stack([np.asarray(m["integrals"].ERI_AO) for m in meta])
        if dh_corr or mp2_scan_batchable(calculation, atomic_symbols,
                                         allow_extrapolate):
            E_corr = _batched_restricted_mp2(
                calculation, molecule, ERI_b, mos, eps)
        else:
            E_corr, cc_ok = _batched_restricted_cc(
                calculation, molecule, ERI_b, mos, eps)
            converged = converged & cc_ok      # serial fallback if any failed
    elif unrestricted_corr:
        (energies, converged, P, meta, orbitals,
         molecule) = _solve_points(calculation, atomic_symbols, bond_lengths,
                                   mesh, return_orbitals=True)
        E_corr, uok = _batched_unrestricted_corr(
            calculation, molecule, meta, orbitals)
        converged = converged & uok
    else:
        energies, converged, P, meta = _solve_points(
            calculation, atomic_symbols, bond_lengths, mesh)
        E_corr = np.zeros(len(meta))
    E_disp = np.array([m["E_disp"] for m in meta])
    return energies, E_corr, E_disp, converged, P, meta


def _solve_points_correlated(calculation, atomic_symbols, bond_lengths,
                             mesh: Mesh | None = None):
    """Batched solve with the correlated energy added when the method gates
    pass (restricted MP2/SCS-MP2 closed form, or the CC/CI amplitude loop);
    mean-field otherwise.  Returns (total_energies, converged, P_SCF, meta)
    -- the densities are the SCF ones, so callers that feed densities
    downstream (dipole derivatives) must gate on mean_field_batchable."""
    energies, E_corr, _E_disp, converged, P, meta = _solve_points_components(
        calculation, atomic_symbols, bond_lengths, mesh)
    return energies + E_corr, converged, P, meta


def ump2_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Plain UHF-reference MP2 batches through the spin-orbital formula
    E = 1/4 sum t*g (equal to the serial alpha/beta-split evaluation for
    canonical orbitals).  SCS (needs the spin-pair split) and FREEZECORE
    (the serial path splits frozen orbitals per spin, not per sorted
    spin-orbital) stay serial."""
    return (calculation.method.name == "MP2"
            and not calculation.freeze_core
            and _scan_common_ok(calculation, allow_extrapolate)
            and not _restricted_reference(calculation, atomic_symbols))


def ucc_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """UHF-reference CC/CI scans batch through the unrestricted spin-orbital
    solver (same while_loop architecture as the restricted one)."""
    return (_cc_base_name(calculation.method.name) in _CC_SCAN_BASES
            and _scan_common_ok(calculation, allow_extrapolate)
            and not _restricted_reference(calculation, atomic_symbols))


def _batched_unrestricted_corr(calculation, molecule, meta, orbitals):
    """Vmapped UHF-reference spin-orbital correlation energies for a batch
    of converged points: spin-block + SO transform + (MP2 energy | the
    unrestricted amplitude while_loop, + perturbative (T)) in ONE jitted
    call.  Returns (E_corr, ok) arrays over the batch."""
    from .post import cc as cc_mod
    from .post import transforms

    mos_a, eps_a, mos_b, eps_b = orbitals
    name = calculation.method.name
    base = _cc_base_name(name)
    do_T = base != name and base in ("CCSD", "QCISD")
    is_mp2 = name == "MP2"
    s = (molecule.n_core_spin_orbitals if calculation.freeze_core else 0)
    n_occ_so = molecule.n_occ
    n_SO = int(np.asarray(mos_a).shape[-1]) * 2
    o_full, v_full = slice(s, n_occ_so), slice(n_occ_so, None)
    o0 = slice(0, n_occ_so)

    solver_fn = None
    if not is_mp2:
        settings = cc_mod.CCSettings(
            method=base, restricted=False,
            update_singles=base not in cc_mod._NO_SINGLES,
            keep_disconnected=base not in cc_mod._NO_DISCONNECTED,
            n_occ=n_occ_so - s, n_virt=n_SO - n_occ_so,
            max_iter=int(calculation.correlated_max_iter),
            use_diis=bool(calculation.DIIS),
            max_diis=int(calculation.max_DIIS_matrices),
            damping=float(calculation.correlated_damping_parameter),
            o_start=s)
        solver_fn = cc_mod._build_cc_solver_fn(settings)
    dummy, d3_dummy = jnp.zeros((1, 1)), jnp.zeros((1,))
    ERI_b = jnp.asarray(np.stack([np.asarray(m["integrals"].ERI_AO)
                                  for m in meta]))
    Hc_b = jnp.asarray(np.stack([np.asarray(m["integrals"].H_core)
                                 for m in meta]))

    def one(ERI, Hc, Ca, Cb, ea, eb):
        eps_comb = jnp.concatenate([ea, eb])
        order = jnp.argsort(eps_comb)
        Z = jnp.zeros_like(Ca)
        C = jnp.concatenate([jnp.concatenate([Ca, Z], axis=1),
                             jnp.concatenate([Z, Cb], axis=1)],
                            axis=0)[:, order]
        ERI_SO = transforms.ao_to_so_physicists(
            transforms.spin_block_eri(ERI), C, C)
        g = transforms.antisymmetrise(ERI_SO)
        eps_sorted = jnp.sort(eps_comb)
        e_ijab = transforms.doubles_epsilons(eps_sorted, eps_sorted,
                                             o_full, o_full, v_full, v_full)
        t_ijab = g[o_full, o_full, v_full, v_full] * e_ijab
        if is_mp2:
            E = 0.25 * jnp.einsum("ijab,ijab->", t_ijab,
                                  g[o_full, o_full, v_full, v_full],
                                  optimize=True)
            return E, jnp.asarray(True)

        Hc_SO = C.T @ transforms.spin_block_matrix(Hc) @ C
        F = transforms.spin_orbital_fock(Hc_SO, g, o0)
        e_ia = transforms.singles_epsilons(eps_sorted, o_full, v_full)
        t_ia = e_ia * F[o_full, v_full]
        g_l, F_l = (g[s:, s:, s:, s:], F[s:, s:]) if s else (g, F)
        (n_steps, conv, failed, E_CC, t1, t2, stats, parts, _) = solver_fn(
            g_l, F_l, e_ia, e_ijab, t_ia, t_ijab, dummy, dummy, dummy,
            d3_dummy, calculation.energy_convergence, calculation.amp_conv)
        E = E_CC
        if do_T:
            e_ijkabc = transforms.triples_epsilons(eps_sorted, o_full, v_full)
            E_T, t_c, t_d = cc_mod._unrestricted_T_tensors(
                g[o_full, o_full, v_full, v_full],
                g[v_full, o_full, v_full, v_full],
                g[o_full, v_full, o_full, o_full], t1, t2, e_ijkabc)
            if "QCISD" in base:
                E_T = (1.0 / 36.0) * jnp.einsum(
                    "ijkabc,ijkabc->", t_c / e_ijkabc, t_c + 2.0 * t_d,
                    optimize=True)
            E = E + E_T
        return E, conv & ~failed

    E_corr, ok = jax.jit(jax.vmap(one))(
        ERI_b, Hc_b, jnp.asarray(mos_a), jnp.asarray(mos_b),
        jnp.asarray(eps_a), jnp.asarray(eps_b))
    return np.asarray(E_corr), np.asarray(ok)


def cbs_scan_batchable(calculation, atomic_symbols):
    """EXTRAPOLATE scans batch as two sharded passes (small + large basis)
    plus the per-point two-point CBS formula.  Mean-field HF/UHF, DFT
    without VV10/MPC, and restricted MP2/CC methods qualify."""
    if not getattr(calculation, "extrapolate", False):
        return False
    from .drivers.energy import _NEXT_BASIS
    if _NEXT_BASIS.get(calculation.basis.upper()) is None:
        return False
    if (getattr(calculation, "direct_scf", False)
            or getattr(calculation, "read_checkpoint", False)
            or getattr(calculation, "VV10", False)
            or np.any(calculation.electric_field)
            or np.any(calculation.electric_field_gradient)):
        return False
    name = calculation.method.name
    plain = name in ("HF", "UHF")
    dft = (calculation.DFT_calculation
           and not getattr(calculation, "MPC_prop", 0))
    corr = (mp2_scan_batchable(calculation, atomic_symbols,
                               allow_extrapolate=True)
            or cc_scan_batchable(calculation, atomic_symbols,
                                 allow_extrapolate=True)
            or ump2_scan_batchable(calculation, atomic_symbols,
                                   allow_extrapolate=True)
            or ucc_scan_batchable(calculation, atomic_symbols,
                                  allow_extrapolate=True))
    return plain or dft or corr


def cbs_scan_points_parallel(calculation, atomic_symbols, bond_lengths,
                             mesh: Mesh | None = None):
    """CBS-extrapolated scan: both basis passes run as sharded batches and
    the ORCA-compatible two-point formulas (drivers/common.
    extrapolate_energies) combine them per point.  Mirrors the serial
    calculate_extrapolated_energy (drivers/energy.py): SCF exponential +
    correlation beta-power, dispersion added at the large basis; dipoles
    come from the large-basis SCF densities."""
    from .drivers import common as common_mod
    from .drivers.energy import _NEXT_BASIS, _detect_zeta

    small = calculation.basis.upper()
    large = _NEXT_BASIS[small]
    zeta = _detect_zeta(small)

    E_s, C_s, D_s, conv_s, _P_s, _meta_s = _solve_points_components(
        calculation, atomic_symbols, bond_lengths, mesh,
        allow_extrapolate=True)
    old_basis = calculation.basis
    calculation.basis = large
    try:
        E_l, C_l, D_l, conv_l, P_l, meta_l = _solve_points_components(
            calculation, atomic_symbols, bond_lengths, mesh,
            allow_extrapolate=True)
    finally:
        calculation.basis = old_basis

    totals = []
    for i in range(len(bond_lengths)):
        E_scf_cbs, E_corr_cbs = common_mod.extrapolate_energies(
            small, E_s[i] - D_s[i], E_l[i] - D_l[i], C_s[i], C_l[i], zeta)
        totals.append(E_scf_cbs + E_corr_cbs + D_l[i])

    from . import props
    dipoles = np.array([
        props.calculate_analytical_dipole_moment(
            m["centre_of_mass"], m["charges"], m["coordinates"], P_l[i],
            m["D"])[0]
        for i, m in enumerate(meta_l)])
    return np.array(totals), np.asarray(conv_s) & np.asarray(conv_l), dipoles


def scan_points_parallel(calculation, atomic_symbols, bond_lengths,
                         mesh: Mesh | None = None):
    """Converged energies, convergence flags and analytic dipole moments
    for a batch of bond lengths, data-parallel over the mesh.

    Covers mean-field HF/UHF and DFT (mean_field_batchable) plus restricted
    closed-form MP2/SCS-MP2 (mp2_scan_batchable); each geometry runs the
    full jitted SCF while_loop, vmapped in lockstep and sharded over the
    mesh's first axis, with the MP2 correlation added by a second vmapped
    call.  This is the production fast path of the SCAN driver
    (drivers/energy.scan_coordinate) on multi-device hosts; the reference
    walks scan points serially (tuna_energy.py:975-1085).
    """
    energies, converged, P, meta = _solve_points_correlated(
        calculation, atomic_symbols, bond_lengths, mesh)
    from . import props
    dipoles = np.array([
        props.calculate_analytical_dipole_moment(
            m["centre_of_mass"], m["charges"], m["coordinates"], P[i], m["D"])[0]
        for i, m in enumerate(meta)])
    return energies, converged, dipoles


def stencil_points_parallel(calculation, atomic_symbols, bond_lengths,
                            mesh: Mesh | None = None,
                            include_correlation=False):
    """Finite-difference GEOMETRY stencil fast path: one sharded batched SCF
    solve over the displaced bond lengths of an OPT/FREQ/VPT stencil,
    returning per-point energies, convergence flags, total densities and the
    per-point integrals containers (the dipole-derivative stencils downstream
    need the displaced D matrices).  With include_correlation the restricted
    MP2/CC correlation energy is added per point (energy-only consumers:
    VPT windows, numerical gradients) -- the returned densities stay SCF.
    The reference evaluates every displaced geometry serially
    (tuna_opt.py:87-147, tuna_freq.py:822-959)."""
    if include_correlation:
        return _solve_points_correlated(calculation, atomic_symbols,
                                        bond_lengths, mesh)
    return _solve_points(calculation, atomic_symbols, bond_lengths, mesh)


def field_energies_parallel(calculation, atomic_symbols, coordinates, fields,
                            field_gradients=None, mesh: Mesh | None = None):
    """Finite-FIELD stencil fast path: converged SCF total energies at ONE
    geometry for a batch of uniform electric fields / field gradients,
    sharded over the mesh.

    The field enters the jitted SCF kernel only through two one-electron
    matrices (F = sum_i E_i D_i and the quadrupole contraction G), so the
    whole polarisability / hyperpolarisability / multipole stencil
    (drivers/electric.py) is one vmapped solve with every other operand
    broadcast.  The reference walks the field displacements serially
    (tuna_energy.py:315-759).  Returns (total_energies, converged) over the
    batch; `fields` / `field_gradients` are absolute (already include any
    user-applied base field).
    """
    if mesh is None:
        mesh = device_mesh()

    coords = common.clean_coordinates(np.asarray(coordinates, dtype=float))
    molecule = Molecule(list(atomic_symbols), coords, calculation)
    integrals = common.calculate_analytical_integrals(molecule, calculation, True)
    molecule.process_basis_functions(calculation, int(integrals.n_basis))
    X, _, _ = common.calculate_orthogonalisation_matrix(integrals.S,
                                                        calculation, True)
    V_NN = float(np.prod([float(c) for c in molecule.charges])
                 / np.linalg.norm(coords[1] - coords[0]))
    V_NN += float(common.calculate_additive_dispersion_energy(
        molecule, calculation, True))

    n_f = len(fields) if fields is not None else len(field_gradients)
    if fields is None:
        fields = [np.zeros(3)] * n_f
    if field_gradients is None:
        field_gradients = [np.zeros(3)] * n_f

    n_dev = int(np.prod(mesh.devices.shape))
    n_padded = -(-n_f // n_dev) * n_dev
    fields = list(fields) + [fields[-1]] * (n_padded - n_f)
    field_gradients = (list(field_gradients)
                       + [field_gradients[-1]] * (n_padded - n_f))

    Fld = jnp.stack([common.apply_electric_field(integrals.D, f)
                     for f in fields])
    G = jnp.stack([common.apply_electric_field_gradient(integrals.Q, g)
                   for g in field_gradients])

    # shared field-free core guess, broadcast over the batch
    H = np.asarray(integrals.T) + np.asarray(integrals.V_NE)
    Xn = np.asarray(X)
    _, C0 = np.linalg.eigh(Xn.T @ H @ Xn)
    C0 = Xn @ C0
    P_a = jnp.asarray(C0[:, :molecule.n_alpha] @ C0[:, :molecule.n_alpha].T)
    P_b = jnp.asarray(C0[:, :molecule.n_beta] @ C0[:, :molecule.n_beta].T)

    settings = SCFSettings(
        reference=calculation.reference,
        n_basis=int(integrals.n_basis),
        n_alpha=molecule.n_alpha, n_beta=molecule.n_beta,
        max_iter=calculation.max_iter,
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        use_damping=bool(calculation.damping),
        dynamic_damping=calculation.damping_factor is None,
        partition_0=int(molecule.partition_ranges[0]),
        n_atoms=molecule.n_atoms)
    xc_closure = None
    if calculation.DFT_calculation:
        # One geometry across the whole field batch: the grid binds as
        # trace constants exactly like the serial path.
        from .dft import grid as dft_grid, make_xc_closure
        grid_container = dft_grid.set_up_integration_grid(
            molecule, P_a, P_b, calculation, silent=True)
        xc_closure = make_xc_closure(calculation, grid_container)
    kernel = get_scf_kernel(settings, xc_closure)

    conv = calculation.SCF_conv
    static_damping = calculation.damping_factor or 0.0
    T = jnp.asarray(integrals.T)
    V = jnp.asarray(integrals.V_NE)
    ERI = jnp.asarray(integrals.ERI_AO)
    S = jnp.asarray(integrals.S)
    Xd = jnp.asarray(X)
    coords_dev = jnp.asarray(coords)

    # Correlated finite-field stencils (MP2/CC polarisabilities etc.): the
    # per-field-point orbitals feed the same vmapped correlation helpers the
    # SCAN path uses, with the single AO tensor broadcast over the batch.
    correlated = (mp2_scan_batchable(calculation, [a.symbol for a in molecule.atoms])
                  or cc_scan_batchable(calculation, [a.symbol for a in molecule.atoms]))

    needs_vv10 = calculation.DFT_calculation and _needs_vv10(calculation)

    def solve_one(Fld_b, G_b):
        n_steps, converged, E, P_a_out, P_b_out, _, outs = kernel(
            T, V, ERI, S, Xd, Fld_b, G_b, coords_dev, P_a, P_b, 0.0,
            calculation.HFX_prop, calculation.DFX_prop, calculation.DFC_prop,
            conv["delta_E"], conv["max_DP"], conv["RMS_DP"], conv["commutator"],
            static_damping, calculation.max_damping)
        if correlated:
            return E, converged, outs["mos_a"], outs["eps_a"]
        if needs_vv10:
            return E, converged, P_a_out + P_b_out
        return E, converged

    axis = mesh.axis_names[0]
    shard = NamedSharding(mesh, PartitionSpec(axis))
    n_out = 4 if correlated else (3 if needs_vv10 else 2)
    batched = jax.jit(jax.vmap(solve_one),
                      in_shardings=(shard, shard),
                      out_shardings=(shard,) * n_out)
    out = batched(Fld, G)
    energies, converged = np.asarray(out[0]), np.asarray(out[1])
    if needs_vv10:
        # One shared geometry/grid across the field batch: the per-field
        # VV10 term varies only through the converged density
        from .dft import vv10
        bfs_g, w_g, grads_g, pts_g = grid_container
        energies = energies + vv10.vv10_energies_batch(
            np.asarray(out[2]), bfs_g, grads_g, w_g, pts_g,
            calculation.functional, grid_axes=(None, None, None, None))
    if correlated:
        mos, eps = np.asarray(out[2]), np.asarray(out[3])
        if calculation.method.name in _MPN_SCAN_METHODS:
            energies = energies + _batched_restricted_mp2(
                calculation, molecule, integrals.ERI_AO, mos, eps,
                eri_axis=None)
        else:
            E_corr, cc_ok = _batched_restricted_cc(
                calculation, molecule, integrals.ERI_AO, mos, eps,
                eri_axis=None)
            energies = energies + E_corr
            converged = converged & cc_ok
    return (energies[:n_f] + V_NN,
            converged[:n_f])


def scan_energies_parallel(calculation, atomic_symbols, bond_lengths,
                           mesh: Mesh | None = None):
    """Converged SCF total energies for a batch of bond lengths (see
    scan_points_parallel)."""
    energies, converged, _ = scan_points_parallel(
        calculation, atomic_symbols, bond_lengths, mesh)
    return energies, converged
