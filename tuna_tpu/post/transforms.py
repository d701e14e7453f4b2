"""Orbital-basis transformations for correlated methods.

AO -> spatial-MO and AO -> spin-orbital four-index transforms as sequences of
dot_general contractions (O(N^5)), spin-blocking helpers and energy
denominator tensors.  Mirrors the conventions of the reference
(/root/reference/TUNA/tuna_ci.py:27-420): the AO ERI tensor is stored in
chemists' notation (mn|kl); `ao_to_mo_chemists` returns (pq|rs); physicists'
<pq|rs> = chemists (pr|qs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..output import error, log, timer


@jax.jit
def ao_to_mo_chemists(ERI_AO, C):
    """(mn|kl) -> (pq|rs) over molecular orbitals C."""
    out = ERI_AO
    for _ in range(4):
        out = jnp.moveaxis(jnp.tensordot(C.T, out, axes=(1, 0)), 0, 3)
    return out


def chemists_to_physicists(ERI):
    return ERI.transpose(0, 2, 1, 3)


@jax.jit
def ao_to_so_physicists(ERI_spin_block, C1, C2):
    """Spin-blocked AO ERI (chemists) -> physicists' <pq|rs> in the SO basis.

    Matches transform_ERI_AO_to_SO (tuna_ci.py:143-193): electron 1 carries
    (C2 row, C1 column) and electron 2 carries (C2, C1) interleaved.
    """
    temp = jnp.einsum("mknl,ls->mnks", ERI_spin_block, C1, optimize=True)
    temp = jnp.einsum("mnks,kr->mnrs", temp, C2, optimize=True)
    temp = jnp.einsum("mnrs,nq->mqrs", temp, C1, optimize=True)
    return jnp.einsum("mqrs,mp->pqrs", temp, C2, optimize=True)


def antisymmetrise(ERI_physicists):
    return ERI_physicists - ERI_physicists.transpose(0, 1, 3, 2)


def spin_block_matrix(M):
    return jnp.kron(jnp.eye(2), M)


def spin_block_eri(ERI_AO):
    """Spin-block the chemists' AO ERI (tuna_ci.py:560)."""
    return jnp.kron(jnp.eye(2), jnp.kron(jnp.eye(2), ERI_AO).T)


def spin_block_orbitals(C_alpha, C_beta, epsilons_combined):
    C = np.block([[np.asarray(C_alpha), np.zeros_like(np.asarray(C_beta))],
                  [np.zeros_like(np.asarray(C_alpha)), np.asarray(C_beta)]])
    return jnp.asarray(C[:, np.argsort(np.asarray(epsilons_combined))])


def spin_orbital_fock(H_core_SO, g, o):
    return H_core_SO + jnp.einsum("piqi->pq", g[:, o, :, o], optimize=True)


def transform_matrix_ao_to_so(M, C):
    return C.T @ M @ C


def density_so_to_ao(P_SO, C_spin_block, n_SO):
    C_alpha = C_spin_block[: n_SO // 2, :]
    C_beta = C_spin_block[n_SO // 2:, :]
    P_alpha = C_alpha @ P_SO @ C_alpha.T
    P_beta = C_beta @ P_SO @ C_beta.T
    return P_alpha + P_beta, P_alpha, P_beta


# --- energy denominators ---------------------------------------------------
# Jitted with static slices: these are called eagerly from the host-level
# correlation preambles, and one compiled call replaces several eager
# dispatches.

@partial(jax.jit, static_argnames=("o", "v"))
def singles_epsilons(epsilons, o, v, level_shift=0.0):
    n = jnp.newaxis
    return 1.0 / (epsilons[o, n] - epsilons[n, v] - level_shift)


@partial(jax.jit, static_argnames=("o1", "o2", "v1", "v2"))
def doubles_epsilons(eps1, eps2, o1, o2, v1, v2, level_shift=0.0):
    n = jnp.newaxis
    return 1.0 / (eps1[o1, n, n, n] + eps2[n, o2, n, n]
                  - eps1[n, n, v1, n] - eps2[n, n, n, v2] - 2 * level_shift)


@partial(jax.jit, static_argnames=("o", "v"))
def triples_epsilons(epsilons, o, v, level_shift=0.0):
    n = jnp.newaxis
    return 1.0 / (epsilons[o, n, n, n, n, n] + epsilons[n, o, n, n, n, n]
                  + epsilons[n, n, o, n, n, n] - epsilons[n, n, n, v, n, n]
                  - epsilons[n, n, n, n, v, n] - epsilons[n, n, n, n, n, v]
                  - 3 * level_shift)


@partial(jax.jit, static_argnames=("o", "v"))
def quadruples_epsilons(epsilons, o, v, level_shift=0.0):
    n = jnp.newaxis
    return 1.0 / (epsilons[o, n, n, n, n, n, n, n] + epsilons[n, o, n, n, n, n, n, n]
                  + epsilons[n, n, o, n, n, n, n, n] + epsilons[n, n, n, o, n, n, n, n]
                  - epsilons[n, n, n, n, v, n, n, n] - epsilons[n, n, n, n, n, v, n, n]
                  - epsilons[n, n, n, n, n, n, v, n] - epsilons[n, n, n, n, n, n, n, v]
                  - 4 * level_shift)


# --- calculation preambles --------------------------------------------------

def transform_direct_mo_chemists(molecule, SCF_output, calculation):
    """Chemists' MO tensor straight from the packed pair sweep -- the
    integral-direct correlation path (DIRECT keyword): the dense N^4 AO
    tensor (Cartesian OR spherical) is never materialised.  The reference
    must store the full Cartesian tensor in host RAM before transforming
    (tuna_kernel.py:392-406: ~3 GB at cc-pV5Z, ~32 GB at cc-pV6Z)."""
    from ..drivers import common as _common
    from ..ops import motransform

    plan = _common.get_integral_plan(molecule)
    coords = jnp.asarray(molecule.coordinates)
    C = jnp.asarray(SCF_output.molecular_orbitals)
    if calculation.cartesian_harmonics:
        W = C
    else:
        W = jnp.asarray(molecule.spherical_transformation).T @ C
    n_mo = int(C.shape[1])

    G_pair = plan.eri_pair_packed(coords)

    # Tensor-parallel routing: the transform's biggest arrays are the
    # (ao_pairs, mo_pairs) half-transform intermediate and the dense MO
    # result; when either exceeds the per-device HBM budget and a mesh is
    # available, shard the pair matrix's row axis over the mesh, run the
    # two-phase sharded transform (one all_to_all reshard), and leave the
    # expanded tensor sharded over its first MO axis (SURVEY.md section
    # 2.3 TP mapping; cc-pV6Z ERI = 32 GB, reference Manual section 7.2).
    from .. import parallel as _par
    n_mo_pairs = n_mo * (n_mo + 1) // 2
    biggest = 8.0 * max(plan.n_pairs * n_mo_pairs, float(n_mo) ** 4)
    tp_mesh = _par.auto_tp_mesh(biggest)
    if tp_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        axis = tp_mesh.axis_names[0]
        n_dev = len(tp_mesh.devices.flat)
        pad = (-G_pair.shape[0]) % n_dev   # device_put needs divisibility
        if pad:
            G_pair = jnp.pad(G_pair, ((0, pad), (0, 0)))
        G_pair = jax.device_put(G_pair,
                                NamedSharding(tp_mesh, PartitionSpec(axis)))
        G_mo = motransform.pair_packed_to_mo_sharded(
            G_pair, plan.pair_index, W, n_mo, tp_mesh)
        # Expand straight into a tensor sharded over its first MO axis when
        # the mesh divides it (NamedSharding requires divisibility), so each
        # device builds only its own slice and the n_mo^4 tensor is never
        # replicated; otherwise the expansion's own placement stands.
        if n_mo % n_dev == 0:
            expand = jax.jit(motransform.expand_mo_chemists,
                             static_argnums=1,
                             out_shardings=NamedSharding(
                                 tp_mesh, PartitionSpec(axis)))
            return expand(G_mo, n_mo)
        return motransform.expand_mo_chemists(G_mo, n_mo)

    G_mo = motransform.pair_packed_to_mo(G_pair, jnp.asarray(plan.pair_index),
                                         W, n_mo)
    return motransform.expand_mo_chemists(G_mo, n_mo)


@jax.jit
def _assemble_so_physicists(blk_aa, blk_ab, blk_bb, is_alpha, sp):
    """Sorted-basis spin-orbital <pq|rs> from spatial chemists' spin blocks.

    blk_aa/blk_ab/blk_bb are the spatial chemists' tensors (a_s b_s|c_t d_t)
    for (s,t) = (alpha,alpha)/(alpha,beta)/(beta,beta); is_alpha/sp map each
    energy-sorted spin orbital to its spin and spatial index.  Chemists'
    (PQ|RS) is non-zero only for same-spin bra and ket pairs, so the full
    tensor is four masked gathers; physicists' interleaved <pq|rs> = (pr|qs)
    matches `ao_to_so_physicists`.
    """
    w_a = is_alpha.astype(blk_aa.dtype)
    w_b = 1.0 - w_a
    i_a = jnp.where(is_alpha, sp, 0)
    i_b = jnp.where(is_alpha, 0, sp)

    def term(blk, i1, i2, i3, i4, w1, w2, w3, w4):
        t = blk[i1][:, i2][:, :, i3][:, :, :, i4]
        return (t * w1[:, None, None, None] * w2[None, :, None, None]
                * w3[None, None, :, None] * w4[None, None, None, :])

    blk_ba = blk_ab.transpose(2, 3, 0, 1)
    E = (term(blk_aa, i_a, i_a, i_a, i_a, w_a, w_a, w_a, w_a)
         + term(blk_ab, i_a, i_a, i_b, i_b, w_a, w_a, w_b, w_b)
         + term(blk_ba, i_b, i_b, i_a, i_a, w_b, w_b, w_a, w_a)
         + term(blk_bb, i_b, i_b, i_b, i_b, w_b, w_b, w_b, w_b))
    return E.transpose(0, 2, 1, 3)


def transform_direct_so_physicists(molecule, SCF_output, calculation):
    """Spin-orbital <pq|rs> straight from the packed pair sweep (DIRECT).

    The stored-tensor route spin-blocks the AO tensor to (2N)^4 before
    transforming (`spin_block_eri`, 16x the N^4 AO tensor the reference
    already has to hold, tuna_kernel.py:392-406); here the three distinct
    spatial spin blocks transform straight off the packed pair matrix and
    the only (2N)^4 array ever built is the MO-basis result itself.
    """
    from ..drivers import common as _common
    from ..ops import motransform

    plan = _common.get_integral_plan(molecule)
    coords = jnp.asarray(molecule.coordinates)
    C_a = jnp.asarray(SCF_output.molecular_orbitals_alpha)
    C_b = jnp.asarray(SCF_output.molecular_orbitals_beta)
    if calculation.cartesian_harmonics:
        W_a, W_b = C_a, C_b
    else:
        T_sph = jnp.asarray(molecule.spherical_transformation)
        W_a, W_b = T_sph.T @ C_a, T_sph.T @ C_b
    n_mo = int(C_a.shape[1])
    pair_index = jnp.asarray(plan.pair_index)

    G_pair = plan.eri_pair_packed(coords)
    blk_aa = motransform.expand_mo_chemists(
        motransform.pair_packed_to_mo(G_pair, pair_index, W_a, n_mo), n_mo)
    blk_bb = motransform.expand_mo_chemists(
        motransform.pair_packed_to_mo(G_pair, pair_index, W_b, n_mo), n_mo)
    blk_ab = motransform.expand_mo_chemists(
        motransform.pair_packed_to_mo_mixed(G_pair, pair_index, W_a, W_b,
                                            n_mo), n_mo)

    eps_combined = np.asarray(SCF_output.epsilons_combined)
    order = np.argsort(eps_combined)
    is_alpha = order < n_mo
    sp = np.where(is_alpha, order, order - n_mo)
    return _assemble_so_physicists(blk_aa, blk_ab, blk_bb,
                                   jnp.asarray(is_alpha), jnp.asarray(sp))


def begin_spatial_orbital_calculation(molecule, ERI_AO, SCF_output, calculation,
                                      silent=False):
    """Spatial-orbital setup: chemists' MO integrals + occupied/virtual slices."""
    minimum_orbital = molecule.n_core_orbitals if calculation.freeze_core else 0
    if molecule.n_core_orbitals * 2 > molecule.n_electrons:
        error("Not enough spatial orbitals to freeze!")
    if molecule.n_core_orbitals < 0:
        error("Cannot freeze a negative number of orbitals!")

    o = slice(minimum_orbital, molecule.n_doubly_occ)
    v = slice(molecule.n_doubly_occ, None)

    log("\n Preparing transformation to spatial orbital basis...", calculation, 1,
        silent=silent)
    timer("Molecular orbital transformation", 0)
    if ERI_AO is None:
        # Integral-direct SCF deferred the stored tensor; transform straight
        # from the packed pair sweep.
        ERI_MO = transform_direct_mo_chemists(molecule, SCF_output, calculation)
    else:
        ERI_MO = ao_to_mo_chemists(jnp.asarray(ERI_AO),
                                   jnp.asarray(SCF_output.molecular_orbitals))
    timer("Molecular orbital transformation", 1)

    if calculation.freeze_core and molecule.n_core_orbitals != 0:
        log(f"\n The {molecule.n_core_orbitals} lowest energy orbitals will be "
            "frozen.", calculation, 1, silent=silent)
    else:
        log("\n All electrons will be correlated.", calculation, 1, silent=silent)

    return ERI_MO, SCF_output.molecular_orbitals, jnp.asarray(SCF_output.epsilons), o, v


def begin_spin_orbital_calculation(molecule, ERI_AO, SCF_output, calculation,
                                   silent=False):
    """Spin-orbital setup: antisymmetrised physicists' integrals + slices."""
    minimum_orbital = molecule.n_core_spin_orbitals if calculation.freeze_core else 0
    if molecule.n_core_spin_orbitals > molecule.n_electrons:
        error("Not enough spin orbitals to freeze!")
    if molecule.n_core_orbitals < 0:
        error("Cannot freeze a negative number of orbitals!")

    o = slice(minimum_orbital, molecule.n_occ)
    v = slice(molecule.n_occ, None)

    epsilons_combined = SCF_output.epsilons_combined

    log("\n Preparing transformation to spin orbital basis...", calculation, 1,
        silent=silent)
    timer("Molecular orbital transformation", 0)
    C_spin_block = spin_block_orbitals(SCF_output.molecular_orbitals_alpha,
                                       SCF_output.molecular_orbitals_beta,
                                       epsilons_combined)
    if ERI_AO is None:
        # Integral-direct SCF deferred the stored tensor: build <pq|rs>
        # straight from the packed pair sweep.  No spin-blocked AO tensor
        # exists on this path; the DIRECT gate (drivers/energy.py) admits
        # only consumers that never touch it.
        ERI_spin_block = None
        ERI_SO = transform_direct_so_physicists(molecule, SCF_output,
                                                calculation)
    else:
        ERI_spin_block = spin_block_eri(jnp.asarray(ERI_AO))
        ERI_SO = ao_to_so_physicists(ERI_spin_block, C_spin_block,
                                     C_spin_block)
    g = antisymmetrise(ERI_SO)
    timer("Molecular orbital transformation", 1)

    epsilons_sorted = jnp.sort(jnp.asarray(epsilons_combined))

    n_alpha_mos = np.asarray(SCF_output.molecular_orbitals_alpha).shape[1]
    n_beta_mos = np.asarray(SCF_output.molecular_orbitals_beta).shape[1]
    spin_labels = ["a"] * n_alpha_mos + ["b"] * n_beta_mos
    order = np.argsort(np.asarray(epsilons_combined))
    spin_labels_sorted = [spin_labels[i] for i in order]

    counts: dict = {}
    spin_orbital_labels_sorted = []
    for x in spin_labels_sorted:
        counts[x] = counts.get(x, 0) + 1
        spin_orbital_labels_sorted.append(f"{counts[x]}{x}")

    if calculation.freeze_core and molecule.n_core_spin_orbitals != 0:
        log(f"\n The {molecule.n_core_spin_orbitals} lowest energy spin orbitals "
            "will be frozen.", calculation, 1, silent=silent)
    else:
        log("\n All electrons will be correlated.", calculation, 1, silent=silent)

    return (g, C_spin_block, epsilons_sorted, ERI_spin_block, o, v,
            spin_labels_sorted, spin_orbital_labels_sorted, ERI_SO)
