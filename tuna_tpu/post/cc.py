"""Coupled cluster and iterative configuration interaction, on device.

Every iterative method compiles to ONE jax.lax.while_loop that lives on
device: amplitude update, correlation energy, convergence test, amplitude
DIIS (fixed-size ring buffer) and damping all happen inside the loop, and a
statistics buffer is printed after it finishes -- no per-iteration host
round-trips (contrast the reference, /root/reference/TUNA/tuna_cc.py, which
dispatches every contraction eagerly from a Python loop).

Restricted (closed-shell) methods use spin-adapted spatial-orbital equations
in a tau-based formulation with occupied-leading integral blocks
(goovv, govov, ...) and L = 2<pq|rs> - <pq|sr>; shared ladder / ring-term
helpers are reused across LCCD/CCD/CID/CISD/QCISD/CCSD.  CCD is the CCSD
residual with the singles frozen at zero.  Unrestricted methods use the
standard antisymmetrised spin-orbital equations.  Capability parity targets
tuna_cc.py:830-2687 (iteration kernels), :2688-2949 ((T)/(Q)), :3179-3317
(driver).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import os

from ..ops import linalg
from ..output import error, log, log_spacer, timer
from . import transforms


# ---------------------------------------------------------------------------
# Small tensor helpers
# ---------------------------------------------------------------------------

def _sym_pair(r):
    """Symmetrise a doubles residual over simultaneous (ij)(ab) exchange."""
    return r + r.transpose(1, 0, 3, 2)


def permute(array, idx_1, idx_2):
    """Antisymmetric permutation P-(idx_1, idx_2)."""
    return array - array.swapaxes(idx_1, idx_2)


def permute_symmetric(array, pair1, pair2):
    return array + array.swapaxes(*pair1).swapaxes(*pair2)


def _u_of(t2):
    """Spin-adapted contravariant combination 2 t2[ijab] - t2[ijba]."""
    return 2.0 * t2 - t2.swapaxes(2, 3)


def _tau_of(t1, t2):
    """tau[ijab] = t2[ijab] + t1[ia] t1[jb]."""
    return t2 + jnp.einsum("ia,jb->ijab", t1, t1, optimize=True)


# ---------------------------------------------------------------------------
# Integral block containers
# ---------------------------------------------------------------------------

def _restricted_blocks(g, o, v):
    """Occupied-leading blocks of <pq|rs> and L = 2<pq|rs> - <pq|sr>.

    All reference contractions over virtual-leading blocks (g[v,v,o,o] etc.)
    are re-expressed through <pq|rs> = <rs|pq> = <qp|sr> so only these eight
    slices are ever materialised.
    """
    L = 2.0 * g - g.swapaxes(2, 3)
    B = {
        "oooo": g[o, o, o, o], "ooov": g[o, o, o, v], "oovo": g[o, o, v, o],
        "oovv": g[o, o, v, v], "ovoo": g[o, v, o, o], "ovov": g[o, v, o, v],
        "ovvo": g[o, v, v, o], "ovvv": g[o, v, v, v], "vvvv": g[v, v, v, v],
        "Loovv": L[o, o, v, v], "Lovoo": L[o, v, o, o], "Lovvo": L[o, v, v, o],
        "Lovvv": L[o, v, v, v],
    }
    # Loop-invariant concatenated operands for the fused CCSD/CCD residual
    # (_r_ccsd); unused entries are dead-code-eliminated by XLA for
    # the methods that never touch them.
    B.update(_ccsd_fused_cats(B))
    return B


_U_KEYS = ("oooo", "ooov", "oovo", "oovv", "ovoo", "ovov", "ovvo", "ovvv",
           "vooo", "vovo", "vvoo", "vvov", "vvvo", "vvvv", "voov", "ovvv")


def _unrestricted_blocks(g, o, v):
    """Spin-orbital antisymmetrised blocks <pq||rs>."""
    return {
        "oooo": g[o, o, o, o], "ooov": g[o, o, o, v], "oovo": g[o, o, v, o],
        "oovv": g[o, o, v, v], "ovoo": g[o, v, o, o], "ovov": g[o, v, o, v],
        "ovvo": g[o, v, v, o], "ovvv": g[o, v, v, v],
        "vovv": g[v, o, v, v], "vvvo": g[v, v, v, o], "vvvv": g[v, v, v, v],
    }


# ---------------------------------------------------------------------------
# Correlation energy (device scalars)
# ---------------------------------------------------------------------------

_NO_DISCONNECTED = ("LCCD", "LCCSD", "QCISD", "QCISD[T]", "QCISD(T)", "CISD",
                    "CID", "CISDT")


def _restricted_energy(B, F_ov, t1, t2, keep_disconnected: bool):
    E_singles = jnp.einsum("ia,ia->", F_ov, t1, optimize=True)
    E_conn = jnp.einsum("ijab,ijab->", B["Loovv"], t2, optimize=True)
    if keep_disconnected:
        E_disc = jnp.einsum("ijab,ia,jb->", B["Loovv"], t1, t1, optimize=True)
    else:
        E_disc = jnp.zeros_like(E_conn)
    return E_singles + E_conn + E_disc, E_singles, E_conn, E_disc


def _unrestricted_energy(B, F_ov, t1, t2, keep_disconnected: bool):
    E_singles = jnp.einsum("ia,ia->", F_ov, t1, optimize=True)
    E_conn = 0.25 * jnp.einsum("ijab,ijab->", B["oovv"], t2, optimize=True)
    if keep_disconnected:
        E_disc = 0.5 * jnp.einsum("ijab,ia,jb->", B["oovv"], t1, t1, optimize=True)
    else:
        E_disc = jnp.zeros_like(E_conn)
    return E_singles + E_conn + E_disc, E_singles, E_conn, E_disc


# ---------------------------------------------------------------------------
# Shared restricted term builders
# ---------------------------------------------------------------------------

def _r_pair_ladder(Aoooo, Avvvv, t2_hh, t2_pp):
    """Hole-hole + particle-particle ladder: <ab|cd> = <cd|ab> lets the
    particle ladder contract the vvvv block in natural order."""
    return 0.5 * (jnp.einsum("ijkl,klab->ijab", Aoooo, t2_hh, optimize=True)
                  + jnp.einsum("abcd,ijcd->ijab", Avvvv, t2_pp, optimize=True))


def _r_rings(Aovvo, Aovov, t2):
    """The four spin-adapted ring contractions (direct + two exchanges).

    All four contract the same (k,c) pair, so they are blocked into ONE
    (2 ov, ov) @ (ov, 2 ov) matmul whose four output blocks are the four
    terms (fewer, larger dots)."""
    no, nv = t2.shape[0], t2.shape[2]
    ia = no * nv
    A1 = Aovvo.transpose(0, 2, 3, 1).reshape(ia, ia)   # (i,a),(k,c)
    A2 = Aovov.transpose(0, 3, 2, 1).reshape(ia, ia)   # (i,a)/(i,b),(k,c)
    Bp = t2.transpose(0, 2, 1, 3).reshape(ia, ia)      # (k,c),(j,b)
    Bq = t2.transpose(0, 3, 1, 2).reshape(ia, ia)      # (k,c),(j,b)/(j,a)
    C = jnp.einsum("xk,ky->xy", jnp.concatenate([A1, A2]),
            jnp.concatenate([Bp, Bq], axis=1), optimize=True)
    C = C.reshape(2, no, nv, 2, no, nv)
    c11, c12 = C[0, :, :, 0], C[0, :, :, 1]            # (i,a,j,b)
    c21, c22 = C[1, :, :, 0], C[1, :, :, 1]            # (i,a,j,b)/(i,b,j,a)
    return ((2.0 * c11 - c21 - c12).transpose(0, 2, 1, 3)
            - c22.transpose(0, 2, 3, 1))


def _r_singles_linear(B, t1, t2):
    """Singles terms common to LCCSD / CISD (and, with tau, CCSD/QCISD)."""
    return (jnp.einsum("icak,kc->ia", B["Lovvo"], t1, optimize=True)
            + jnp.einsum("kadc,ikcd->ia", B["Lovvv"], t2, optimize=True)
            - jnp.einsum("ickl,klac->ia", B["Lovoo"], t2, optimize=True))


def _r_doubles_singles_driven(B, t1):
    """t1-driven doubles terms shared by LCCSD / CISD / QCISD."""
    return (jnp.einsum("icab,jc->ijab", B["ovvv"], t1, optimize=True)
            - jnp.einsum("ijak,kb->ijab", B["oovo"], t1, optimize=True))


def _r_dressed_mosaic(B, t1, t2, with_t1: bool):
    """Fock-dressed and ring-dressed intermediates for CCD/QCISD/CCSD.

    with_t1 = False gives the t2-only (CCD / QCISD) dressing; True gives the
    fully tau-dressed CCSD set.
    """
    tau = _tau_of(t1, t2) if with_t1 else t2
    dFoo = jnp.einsum("klcd,ilcd->ik", B["Loovv"], tau, optimize=True)
    dFvv = -jnp.einsum("klcd,klad->ca", B["Loovv"], tau, optimize=True)
    Fov = jnp.einsum("klcd,ld->kc", B["Loovv"], t1, optimize=True)

    Woooo = B["oooo"] + jnp.einsum("klcd,ijcd->ijkl", B["oovv"], tau, optimize=True)
    half = 0.5 * t2
    if with_t1:
        Woooo = Woooo + _sym_pair(
            jnp.einsum("klic,jc->ijkl", B["ooov"], t1, optimize=True))
        half = half + jnp.einsum("id,la->ilda", t1, t1, optimize=True)

    Wovvo = (B["ovvo"]
             - jnp.einsum("lkdc,ilda->icak", B["oovv"], half, optimize=True)
             + 0.5 * jnp.einsum("lkdc,ilad->icak", B["Loovv"], t2, optimize=True))
    Wovov = (B["ovov"]
             - jnp.einsum("lkcd,ilda->icka", B["oovv"], half, optimize=True))
    if with_t1:
        Wovvo = (Wovvo
                 - jnp.einsum("iclk,la->icak", B["ovoo"], t1, optimize=True)
                 + jnp.einsum("kacd,id->icak", B["ovvv"], t1, optimize=True))
        Wovov = (Wovov
                 - jnp.einsum("ickl,la->icka", B["ovoo"], t1, optimize=True)
                 + jnp.einsum("kadc,id->icka", B["ovvv"], t1, optimize=True))
    return tau, dFoo, dFvv, Fov, Woooo, Wovvo, Wovov


# ---------------------------------------------------------------------------
# Restricted residual -> new-amplitude maps
# ---------------------------------------------------------------------------
# Each update has signature (B, F_ov, d1, d2, t1, t2, aux) -> (t1_new, t2_new)

def _r_lccd(B, F_ov, d1, d2, t1, t2, aux):
    r2 = (0.5 * B["oovv"] + _r_pair_ladder(B["oooo"], B["vvvv"], t2, t2)
          + _r_rings(B["ovvo"], B["ovov"], t2))
    return t1, d2 * _sym_pair(r2)


def _r_cid(B, F_ov, d1, d2, t1, t2, aux):
    r2 = _sym_pair(0.5 * B["oovv"] + _r_pair_ladder(B["oooo"], B["vvvv"], t2, t2)
                   + _r_rings(B["ovvo"], B["ovov"], t2))
    E_corr = jnp.einsum("ijab,ijab->", B["oovv"], _u_of(t2), optimize=True)
    return t1, d2 * (r2 - E_corr * t2)


def _r_lccsd(B, F_ov, d1, d2, t1, t2, aux):
    r1 = _r_singles_linear(B, t1, t2)
    r2 = (0.5 * B["oovv"] + _r_pair_ladder(B["oooo"], B["vvvv"], t2, t2)
          + _r_doubles_singles_driven(B, t1)
          + _r_rings(B["ovvo"], B["ovov"], t2))
    return d1 * r1, d2 * _sym_pair(r2)


def _r_cisd(B, F_ov, d1, d2, t1, t2, aux):
    r1 = _r_singles_linear(B, t1, t2)
    r2 = _sym_pair(0.5 * B["oovv"] + _r_doubles_singles_driven(B, t1)
                   + _r_pair_ladder(B["oooo"], B["vvvv"], t2, t2)
                   + _r_rings(B["ovvo"], B["ovov"], t2))
    E_corr = jnp.einsum("ijab,ijab->", B["oovv"], _u_of(t2), optimize=True)
    return d1 * (r1 - E_corr * t1), d2 * (r2 - E_corr * t2)


def _r_qcisd(B, F_ov, d1, d2, t1, t2, aux):
    _, dFoo, dFvv, Fov, Woooo, Wovvo, Wovov = _r_dressed_mosaic(B, t1, t2, False)
    r1 = (jnp.einsum("ca,ic->ia", dFvv, t1, optimize=True)
          - jnp.einsum("ik,ka->ia", dFoo, t1, optimize=True)
          + jnp.einsum("kc,kica->ia", Fov, _u_of(t2), optimize=True)
          + _r_singles_linear(B, t1, t2))
    r2 = (0.5 * B["oovv"] + _r_pair_ladder(Woooo, B["vvvv"], t2, t2)
          + jnp.einsum("ca,ijcb->ijab", dFvv, t2, optimize=True)
          - jnp.einsum("ik,kjab->ijab", dFoo, t2, optimize=True)
          + _r_doubles_singles_driven(B, t1)
          + _r_rings(Wovvo, Wovov, t2))
    return d1 * r1, d2 * _sym_pair(r2)


def _r_ccsd_unfused(B, F_ov, d1, d2, t1, t2, aux, freeze_singles: bool = False):
    """Reference (one-einsum-per-term) CCSD residual; kept as the
    equivalence oracle for the fused production residual
    (tests/test_cc.py::test_fused_residual_matches_unfused)."""
    tau, dFoo, dFvv, Fov, Woooo, Wovvo, Wovov = _r_dressed_mosaic(B, t1, t2,
                                                                  not freeze_singles)
    dLoo = dFoo + jnp.einsum("ickl,lc->ik", B["Lovoo"], t1, optimize=True)
    dLvv = dFvv + jnp.einsum("kadc,kd->ca", B["Lovvv"], t1, optimize=True)

    ladder = _r_pair_ladder(Woooo, B["vvvv"], tau, tau)
    if not freeze_singles:
        # T1-dressing of the particle ladder WITHOUT materialising the dressed
        # (v,v,v,v) tensor: contracting tau into ovvv first turns two v^4
        # tensor builds (awkward abcd output permutations of 8v^4 bytes)
        # into one o^2v^3 intermediate
        # and two O(o^3 v^2) contractions.  Uses tau_ijcd = tau_jidc.
        Y = jnp.einsum("kacd,ijcd->kaij", B["ovvv"], tau, optimize=True)
        ladder = ladder - 0.5 * (
            jnp.einsum("kaji,kb->ijab", Y, t1, optimize=True)
            + jnp.einsum("kbij,ka->ijab", Y, t1, optimize=True))

    r1 = (jnp.einsum("ca,ic->ia", dFvv, t1, optimize=True)
          - jnp.einsum("ik,ka->ia", dFoo, t1, optimize=True)
          - jnp.einsum("ickl,klac->ia", B["Lovoo"], tau, optimize=True)
          + jnp.einsum("kc,kica->ia", Fov, _u_of(t2), optimize=True)
          + jnp.einsum("kc,ic,ka->ia", Fov, t1, t1, optimize=True)
          + jnp.einsum("icak,kc->ia", B["Lovvo"], t1, optimize=True)
          + jnp.einsum("kadc,ikcd->ia", B["Lovvv"], tau, optimize=True))

    r2 = (0.5 * B["oovv"] + ladder
          + jnp.einsum("ca,ijcb->ijab", dLvv, t2, optimize=True)
          - jnp.einsum("ik,kjab->ijab", dLoo, t2, optimize=True)
          + jnp.einsum("icab,jc->ijab", B["ovvv"], t1, optimize=True)
          - jnp.einsum("ickb,ka,jc->ijab", B["ovov"], t1, t1, optimize=True)
          - jnp.einsum("ijak,kb->ijab", B["oovo"], t1, optimize=True)
          - jnp.einsum("icak,jc,kb->ijab", B["ovvo"], t1, t1, optimize=True)
          + _r_rings(Wovvo, Wovov, t2))

    t1_new = t1 if freeze_singles else d1 * r1
    return t1_new, d2 * _sym_pair(r2)


def _r_ccd(B, F_ov, d1, d2, t1, t2, aux):
    """CCD = CCSD with the singles channel frozen at zero."""
    return _r_ccsd(B, F_ov, d1, d2, jnp.zeros_like(t1), t2, aux,
                   freeze_singles=True)


# ---------------------------------------------------------------------------
# Fused restricted CCSD residual
# ---------------------------------------------------------------------------
# Contractions that share a contracted index pattern and a right-hand operand
# are BLOCKED into one matmul: rows = the concatenated left operands,
# columns = the (possibly concatenated) right operand; output blocks are
# sliced back out.  This is a pure restructuring -- bit-identical
# contractions, fewer and larger dots (41 -> ~23 dot_generals at o=7,
# v=19).  The loop-invariant concatenations are built once per solver call
# in _ccsd_fused_cats (outside the while_loop, so XLA hoists them).

def _ccsd_fused_cats(B):
    """Loop-invariant concatenated left operands for _r_ccsd's fused groups,
    keyed into the block dict as cat_*."""
    no, nv = B["ooov"].shape[0], B["ooov"].shape[3]
    o2, v2, ov = no * no, nv * nv, no * nv
    cat = {}
    # group CD (K = v^2, right operand tau[(cd),(ij)]):
    #   Woooo build "klcd,ijcd", particle ladder "abcd,ijcd", Y "kacd,ijcd"
    cat["cat_cd"] = jnp.concatenate([
        B["oovv"].reshape(o2, v2),
        B["vvvv"].reshape(v2, v2),
        B["ovvv"].reshape(ov, v2)])
    # group KLC (K = o^2 v, right operand tau[(kld),(a)]):
    #   dFvv "klcd,klad->ca" and the singles term "ickl,klac->ia"
    cat["cat_klc"] = jnp.concatenate([
        B["Loovv"].transpose(2, 0, 1, 3).reshape(nv, o2 * nv),
        B["Lovoo"].transpose(0, 2, 3, 1).reshape(no, o2 * nv)])
    # group KCD (K = o v^2, right operand tau[(lcd),(i)]):
    #   dFoo "klcd,ilcd->ik" and the singles term "kadc,ikcd->ia"
    cat["cat_kcd"] = jnp.concatenate([
        B["Loovv"].reshape(no, no * v2),
        B["Lovvv"].transpose(1, 0, 3, 2).reshape(nv, no * v2)])
    # group V_T1 (K = v, right operand t1^T):
    #   Woooo "klic,jc", r2 "icab,jc", Wovvo "kacd,id", Wovov "kadc,id"
    cat["cat_v_t1"] = jnp.concatenate([
        B["ooov"].reshape(no * o2, nv),
        B["ovvv"].transpose(0, 2, 3, 1).reshape(no * v2, nv),
        B["ovvv"].reshape(ov * nv, nv),
        B["ovvv"].transpose(0, 1, 3, 2).reshape(ov * nv, nv)])
    # group O_T1 (K = o, right operand t1):
    #   r2 "ijak,kb", Wovvo "iclk,la", Wovov "ickl,la"
    cat["cat_o_t1"] = jnp.concatenate([
        B["oovo"].reshape(o2 * nv, no),
        B["ovoo"].transpose(0, 1, 3, 2).reshape(ov * no, no),
        B["ovoo"].reshape(ov * no, no)])
    # group OV_T1 (K = ov, right operand t1.ravel()):
    #   Fov "klcd,ld->kc", dLoo "ickl,lc->ik", dLvv "kadc,kd->ca",
    #   r1 "icak,kc->ia"
    cat["cat_ov_t1"] = jnp.concatenate([
        B["Loovv"].transpose(0, 2, 1, 3).reshape(ov, ov),
        B["Lovoo"].transpose(0, 2, 3, 1).reshape(o2, ov),
        B["Lovvv"].transpose(3, 1, 0, 2).reshape(v2, ov),
        B["Lovvo"].transpose(0, 2, 3, 1).reshape(ov, ov)])
    # group LD (K = ov, right operands [half | t2] columns):
    #   Wovvo "lkdc,ilda", Wovvo "lkdc,ilad" (Loovv), Wovov "lkcd,ilda"
    cat["cat_ld"] = jnp.concatenate([
        B["oovv"].transpose(1, 3, 0, 2).reshape(ov, ov),
        B["Loovv"].transpose(1, 3, 0, 2).reshape(ov, ov),
        B["oovv"].transpose(1, 2, 0, 3).reshape(ov, ov)])
    return cat


def _r_ccsd(B, F_ov, d1, d2, t1, t2, aux, freeze_singles: bool = False):
    """Fused-contraction CCSD residual; numerically identical to
    _r_ccsd_unfused (tests/test_cc.py::test_fused_residual_matches_unfused).  For CCD
    (freeze_singles, t1 = 0) every t1-driven block is exactly zero, so the
    same full evaluation serves both."""
    no, nv = t2.shape[0], t2.shape[2]
    o2, v2, ov = no * no, nv * nv, no * nv

    tau = _tau_of(t1, t2) if not freeze_singles else t2
    u_t2 = _u_of(t2)

    # --- group CD: Woooo build + particle ladder + Y in ONE matmul -------
    tau_cd = tau.transpose(2, 3, 0, 1).reshape(v2, o2)
    CD = jnp.einsum("xk,ky->xy", B["cat_cd"], tau_cd, optimize=True)
    Woooo_tau = CD[:o2].reshape(no, no, no, no).transpose(2, 3, 0, 1)
    ladder_pp = CD[o2:o2 + v2].reshape(nv, nv, no, no).transpose(2, 3, 0, 1)
    Y = CD[o2 + v2:].reshape(no, nv, no, no)                       # kaij

    # --- group KLC: dFvv + Lovoo singles term -----------------------------
    tau_klc = tau.transpose(0, 1, 3, 2).reshape(o2 * nv, nv)
    KLC = jnp.einsum("xk,ky->xy", B["cat_klc"], tau_klc, optimize=True)
    dFvv = -KLC[:nv]                                               # (c,a)
    r1_lovoo = KLC[nv:]                                            # (i,a)

    # --- group KCD: dFoo + Lovvv singles term -----------------------------
    tau_kcd = tau.transpose(1, 2, 3, 0).reshape(no * v2, no)
    KCD = jnp.einsum("xk,ky->xy", B["cat_kcd"], tau_kcd, optimize=True)
    dFoo = KCD[:no].T                                              # (i,k)
    r1_lovvv = KCD[no:].T                                          # (i,a)

    # --- group V_T1 --------------------------------------------------------
    V1 = jnp.einsum("xk,ky->xy", B["cat_v_t1"], t1.T, optimize=True)
    n0 = no * o2
    woooo_t1 = V1[:n0].reshape(no, no, no, no).transpose(2, 3, 0, 1)
    r2_ovvv = V1[n0:n0 + no * v2].reshape(no, nv, nv, no).transpose(0, 3, 1, 2)
    wovvo_v = V1[n0 + no * v2:n0 + no * v2 + ov * nv].reshape(
        no, nv, nv, no).transpose(3, 2, 1, 0)                      # icak
    wovov_v = V1[n0 + no * v2 + ov * nv:].reshape(
        no, nv, nv, no).transpose(3, 2, 0, 1)                      # icka

    # --- group O_T1 --------------------------------------------------------
    O1 = jnp.einsum("xk,ky->xy", B["cat_o_t1"], t1, optimize=True)
    r2_oovo = O1[:o2 * nv].reshape(no, no, nv, nv)                 # ijab
    wovvo_o = O1[o2 * nv:o2 * nv + ov * no].reshape(
        no, nv, no, nv).transpose(0, 1, 3, 2)                      # icak
    wovov_o = O1[o2 * nv + ov * no:].reshape(no, nv, no, nv)       # icka

    # --- group OV_T1 (matvec) ----------------------------------------------
    OV1 = jnp.einsum("xk,k->x", B["cat_ov_t1"], t1.ravel(), optimize=True)
    Fov = OV1[:ov].reshape(no, nv)
    dLoo_t1 = OV1[ov:ov + o2].reshape(no, no)
    dLvv_t1 = OV1[ov + o2:ov + o2 + v2].reshape(nv, nv)
    r1_lovvo = OV1[ov + o2 + v2:].reshape(no, nv)

    # --- group LD: the three ring-dressing contractions ---------------------
    half = 0.5 * t2
    if not freeze_singles:
        half = half + jnp.einsum("id,la->ilda", t1, t1, optimize=True)
    half_ld = half.transpose(1, 2, 0, 3).reshape(ov, ov)
    t2_ld = t2.transpose(1, 3, 0, 2).reshape(ov, ov)
    LD = jnp.einsum("xk,ky->xy", B["cat_ld"],
             jnp.concatenate([half_ld, t2_ld], axis=1), optimize=True)
    w_oovv_half = LD[:ov, :ov].reshape(no, nv, no, nv).transpose(2, 1, 3, 0)
    w_loovv_t2 = LD[ov:2 * ov, ov:].reshape(no, nv, no, nv).transpose(2, 1, 3, 0)
    w_oovv_half_x = LD[2 * ov:, :ov].reshape(no, nv, no, nv).transpose(2, 1, 0, 3)

    # --- assemble the dressed intermediates ---------------------------------
    Woooo = B["oooo"] + Woooo_tau
    if not freeze_singles:
        Woooo = Woooo + _sym_pair(woooo_t1)
    Wovvo = B["ovvo"] - w_oovv_half + 0.5 * w_loovv_t2
    Wovov = B["ovov"] - w_oovv_half_x
    if not freeze_singles:
        Wovvo = Wovvo - wovvo_o + wovvo_v
        Wovov = Wovov - wovov_o + wovov_v

    dLoo = dFoo + dLoo_t1
    dLvv = dFvv + dLvv_t1

    # --- ladder --------------------------------------------------------------
    ladder = 0.5 * (jnp.einsum("ijkl,klab->ijab", Woooo, tau, optimize=True)
                    + ladder_pp)
    if not freeze_singles:
        # Y-driven T1 dressing of the particle ladder: both terms are the
        # SAME physical product C[x,y,z,w] = sum_k Y[k,x,y,z] t1[k,w], read
        # out under two different index assignments -- one matmul, two
        # output transposes.
        C = jnp.einsum("xk,ky->xy", Y.transpose(1, 2, 3, 0).reshape(nv * o2, no),
                t1, optimize=True).reshape(nv, no, no, nv)
        y1 = C.transpose(2, 1, 0, 3)   # term "kaji,kb->ijab": C[a,j,i,b]
        y2 = C.transpose(1, 2, 3, 0)   # term "kbij,ka->ijab": C[b,i,j,a]
        ladder = ladder - 0.5 * (y1 + y2)

    # --- residuals -------------------------------------------------------------
    r1 = (jnp.einsum("ca,ic->ia", dFvv, t1, optimize=True)
          - jnp.einsum("ik,ka->ia", dFoo, t1, optimize=True)
          - r1_lovoo
          + jnp.einsum("kc,kica->ia", Fov, u_t2, optimize=True)
          + jnp.einsum("kc,ic,ka->ia", Fov, t1, t1, optimize=True)
          + r1_lovvo
          + r1_lovvv)

    r2 = (0.5 * B["oovv"] + ladder
          + jnp.einsum("ca,ijcb->ijab", dLvv, t2, optimize=True)
          - jnp.einsum("ik,kjab->ijab", dLoo, t2, optimize=True)
          + r2_ovvv
          - jnp.einsum("ickb,ka,jc->ijab", B["ovov"], t1, t1, optimize=True)
          - r2_oovo
          - jnp.einsum("icak,jc,kb->ijab", B["ovvo"], t1, t1, optimize=True)
          + _r_rings(Wovvo, Wovov, t2))

    t1_new = t1 if freeze_singles else d1 * r1
    return t1_new, d2 * _sym_pair(r2)


# ---------------------------------------------------------------------------
# T1-dressed restricted CC2 / CC3 (rebuild MO integrals every iteration)
# ---------------------------------------------------------------------------

def _t1_dressed_orbitals(C, t1, o, v):
    X = C.at[:, v].add(-C[:, o] @ t1)
    Y = C.at[:, o].add(C[:, v] @ t1.T)
    return X, Y


def _t1_dressed_mo_tensor(G, t1, o, v):
    """T1-dressed chemists' tensor from the UNDRESSED full-space MO tensor.

    X = C A with A = I - (ov block) t1, Y = C B with B = I + (vo block)
    t1^T, so the dressed tensor is four sequential one-index updates of the
    loop-invariant MO tensor, each contracting the small t1 block:
    O(o v n^4) total instead of the O(n^5) AO-basis rebuild per iteration
    (`_dressed_block`); bra indices (1, 3) carry A, ket indices (2, 4) B.
    """
    G = G.at[v].add(jnp.einsum("ip,iqrs->pqrs", -t1, G[o], optimize=True))
    G = G.at[:, o].add(jnp.einsum("qb,pbrs->pqrs", t1, G[:, v], optimize=True))
    G = G.at[:, :, v].add(jnp.einsum("ir,pqis->pqrs", -t1, G[:, :, o],
                                     optimize=True))
    G = G.at[:, :, :, o].add(jnp.einsum("sd,pqrd->pqrs", t1, G[:, :, :, v],
                                        optimize=True))
    return G


def _t1_dressed_mo_oneelectron(H_MO, t1, o, v):
    """h_hat = A^T H_MO B with the same low-rank A/B as the tensor dressing."""
    H = H_MO.at[v].add(jnp.einsum("ip,iq->pq", -t1, H_MO[o], optimize=True))
    H = H.at[:, o].add(jnp.einsum("qb,pb->pq", t1, H[:, v], optimize=True))
    return H


def _dressed_block(ERI_AO, X, Y, s1, s2, s3, s4):
    """(X_s1 Y_s2 | X_s3 Y_s4)-transformed chemists' block of the AO ERI."""
    out = jnp.tensordot(X[:, s1], ERI_AO, axes=(0, 0))
    out = jnp.tensordot(Y[:, s2], out, axes=(0, 1)).transpose(1, 0, 2, 3)
    out = jnp.tensordot(X[:, s3], out, axes=(0, 2)).transpose(1, 2, 0, 3)
    return jnp.tensordot(Y[:, s4], out, axes=(0, 3)).transpose(1, 2, 3, 0)


def _r_cc2(B, F_ov, d1, d2, t1, t2_unused, aux):
    """CC2: exact singles, first-order doubles in the T1-dressed basis."""
    o, v = aux["o"], aux["v"]
    ERI_AO, C, H = aux["ERI_AO"], aux["C"], aux["H_core"]
    X, Y = _t1_dressed_orbitals(C, t1, o, v)
    h_hat = X.T @ H @ Y

    g_vovo = _dressed_block(ERI_AO, X, Y, v, o, v, o)
    g_ovvv = _dressed_block(ERI_AO, X, Y, o, v, v, v)
    g_ooov = _dressed_block(ERI_AO, X, Y, o, o, o, v)
    g_oovo = _dressed_block(ERI_AO, X, Y, o, o, v, o)
    g_ovoo = _dressed_block(ERI_AO, X, Y, o, v, o, o)

    F_vo = (h_hat[v, o] + 2.0 * jnp.einsum("kkai->ai", g_oovo, optimize=True)
            - jnp.einsum("kiak->ai", g_oovo, optimize=True))
    F_ov_hat = (h_hat[o, v] + 2.0 * jnp.einsum("kkia->ia", g_ooov, optimize=True)
                - jnp.einsum("kaik->ia", g_ovoo, optimize=True))

    t2 = g_vovo.transpose(1, 3, 0, 2) * d2
    u2 = _u_of(t2)

    r1 = (F_vo.T
          + jnp.einsum("kicd,kcad->ia", u2, g_ovvv, optimize=True)
          - jnp.einsum("klac,kilc->ia", u2, g_ooov, optimize=True)
          + jnp.einsum("kc,ikac->ia", F_ov_hat, u2, optimize=True))
    return t1 + d1 * r1, t2


def _r_cc3(B, F_ov, d1, d2, t1, t2, aux):
    """CC3: CCSD-like doubles plus approximate triples, T1-dressed."""
    from .mp import second_order_triples_amplitudes

    o, v = aux["o"], aux["v"]
    ERI_AO, C, H, d3 = aux["ERI_AO"], aux["C"], aux["H_core"], aux["d3"]
    X, Y = _t1_dressed_orbitals(C, t1, o, v)
    all_idx = slice(None)
    g_hat = _dressed_block(ERI_AO, X, Y, all_idx, all_idx, all_idx, all_idx)
    h_hat = X.T @ H @ Y

    l_hat = 2.0 * g_hat - g_hat.swapaxes(1, 3)
    u2 = _u_of(t2)
    occ_all = slice(0, o.stop)
    F_hat = h_hat + jnp.einsum("kkpq->pq", l_hat[occ_all, occ_all, :, :],
                               optimize=True)

    A_ia = jnp.einsum("kicd,kcad->ia", u2, g_hat[o, v, v, v], optimize=True)
    B_ia = -jnp.einsum("klac,kilc->ia", u2, g_hat[o, o, o, v], optimize=True)
    C_ia = jnp.einsum("kc,ikac->ia", F_hat[o, v], u2, optimize=True)

    beta = (g_hat[o, o, o, o].transpose(1, 3, 0, 2)
            + jnp.einsum("ijcd,kcld->ijkl", t2, g_hat[o, v, o, v], optimize=True))
    gamma = (g_hat[o, o, v, v]
             - 0.5 * jnp.einsum("liad,kdlc->kiac", t2, g_hat[o, v, o, v], optimize=True))
    delta = 2.0 * g_hat[v, o, o, v] - g_hat[o, o, v, v].transpose(2, 1, 0, 3)
    delta = delta + 0.5 * jnp.einsum(
        "ilad,ldkc->aikc", u2,
        2.0 * g_hat[o, v, o, v] - g_hat[o, v, o, v].swapaxes(1, 3), optimize=True)
    Fvv_tt = F_hat[v, v] - jnp.einsum("klbd,ldkc->bc", u2, g_hat[o, v, o, v],
                                      optimize=True)
    Foo_tt = F_hat[o, o] + jnp.einsum("ljcd,kdlc->kj", u2, g_hat[o, v, o, v],
                                      optimize=True)

    A2 = jnp.einsum("ijcd,acbd->ijab", t2, g_hat[v, v, v, v], optimize=True)
    B2 = jnp.einsum("klab,ijkl->ijab", t2, beta, optimize=True)
    C2 = -jnp.einsum("kjbc,kiac->ijab", t2, gamma, optimize=True)
    D2 = 0.5 * jnp.einsum("jkbc,aikc->ijab", u2, delta, optimize=True)
    E2 = jnp.einsum("ijac,bc->ijab", t2, Fvv_tt, optimize=True)
    G2 = -jnp.einsum("ikab,kj->ijab", t2, Foo_tt, optimize=True)

    t3 = second_order_triples_amplitudes(d3, t2, g_hat, o, v)
    u3 = 2.0 * t3 - t3.swapaxes(3, 4) - t3.swapaxes(3, 5)

    trip2 = jnp.einsum("kc,ijkabc->ijab", F_hat[o, v],
                       t3 - t3.swapaxes(4, 5), optimize=True)
    trip2 = trip2 + jnp.einsum(
        "ackd,ijkcbd->ijab", g_hat[v, v, o, v],
        2.0 * t3 - t3.swapaxes(4, 5) - t3.swapaxes(3, 5), optimize=True)
    trip2 = trip2 - jnp.einsum("kilc,ljkcba->ijab", g_hat[o, o, o, v], u3,
                               optimize=True)

    r1 = F_hat[v, o].T + A_ia + B_ia + C_ia
    r1 = r1 + jnp.einsum("jbkc,ijkabc->ia", l_hat[o, v, o, v],
                         t3 - t3.swapaxes(3, 4), optimize=True)
    r2 = g_hat[v, o, v, o].transpose(1, 3, 0, 2) + A2 + B2
    r2 = r2 + permute_symmetric(0.5 * C2 + C2.swapaxes(0, 1) + D2 + E2 + G2,
                                (0, 1), (2, 3))
    r2 = r2 + permute_symmetric(trip2, (0, 1), (2, 3))

    return t1 + d1 * r1, t2 + d2 * r2


# ---------------------------------------------------------------------------
# Unrestricted (spin-orbital) residual maps
# ---------------------------------------------------------------------------

def _u_so_tau(t1, t2, factor):
    pair = jnp.einsum("ia,jb->ijab", t1, t1, optimize=True)
    return t2 + factor * (pair - pair.swapaxes(2, 3))


def _u_linear_doubles(B, F_oo_off, F_vv_off, t1, t2, with_fock: bool):
    """Linear doubles terms shared by every spin-orbital method."""
    r = (B["oovv"]
         + 0.5 * jnp.einsum("abcd,ijcd->ijab", B["vvvv"], t2, optimize=True)
         + 0.5 * jnp.einsum("ijkl,klab->ijab", B["oooo"], t2, optimize=True)
         + permute(permute(jnp.einsum("icak,jkbc->ijab", B["ovvo"], t2,
                                      optimize=True), 2, 3), 0, 1))
    if with_fock:
        r = r + permute(jnp.einsum("ijae,be->ijab", t2, F_vv_off, optimize=True), 2, 3)
        r = r - permute(jnp.einsum("imab,mj->ijab", t2, F_oo_off, optimize=True), 0, 1)
    return r


def _u_singles_driven(B, t1):
    return (permute(jnp.einsum("abcj,ic->ijab", B["vvvo"], t1, optimize=True), 0, 1)
            - permute(jnp.einsum("kbij,ka->ijab", B["ovoo"], t1, optimize=True), 2, 3))


def _u_linear_singles(B, F, o, v, t1, t2):
    return (F[o, v]
            + jnp.einsum("ie,ae->ia", t1, F[v, v] - jnp.diag(jnp.diagonal(F))[v, v],
                         optimize=True)
            - jnp.einsum("ma,mi->ia", t1, F[o, o] - jnp.diag(jnp.diagonal(F))[o, o],
                         optimize=True)
            + jnp.einsum("imae,me->ia", t2, F[o, v], optimize=True)
            - jnp.einsum("nf,naif->ia", t1, B["ovov"], optimize=True)
            - 0.5 * jnp.einsum("imef,maef->ia", t2, B["ovvv"], optimize=True)
            - 0.5 * jnp.einsum("mnae,nmei->ia", t2, B["oovo"], optimize=True))


def _u_lccd(B, F, o, v, d1, d2, t1, t2, aux):
    return t1, d2 * _u_linear_doubles(B, None, None, t1, t2, False)


def _u_ccd(B, F, o, v, d1, d2, t1, t2, aux):
    r = _u_linear_doubles(B, None, None, t1, t2, False)
    r = r - 0.5 * permute(jnp.einsum("cdkl,ijac,klbd->ijab", B["oovv"].transpose(2, 3, 0, 1),
                                     t2, t2, optimize=True), 2, 3)
    r = r - 0.5 * permute(jnp.einsum("cdkl,ikab,jlcd->ijab", B["oovv"].transpose(2, 3, 0, 1),
                                     t2, t2, optimize=True), 0, 1)
    r = r + 0.25 * jnp.einsum("cdkl,ijcd,klab->ijab", B["oovv"].transpose(2, 3, 0, 1),
                              t2, t2, optimize=True)
    r = r + permute(jnp.einsum("cdkl,ikac,jlbd->ijab", B["oovv"].transpose(2, 3, 0, 1),
                               t2, t2, optimize=True), 0, 1)
    return t1, d2 * r


def _u_lccsd(B, F, o, v, d1, d2, t1, t2, aux):
    """Incremental update (the reference quirk, tuna_cc.py:1118-1119): the
    fixed point satisfies residual = 0 either way."""
    r1 = (F[o, v] + jnp.einsum("ac,ic->ia", F[v, v], t1, optimize=True)
          + jnp.einsum("kc,ikac->ia", F[o, v], t2, optimize=True)
          - jnp.einsum("ki,ka->ia", F[o, o], t1, optimize=True)
          + jnp.einsum("kaci,kc->ia", B["ovvo"], t1, optimize=True)
          + 0.5 * jnp.einsum("kacd,kicd->ia", B["ovvv"], t2, optimize=True)
          - 0.5 * jnp.einsum("klci,klca->ia", B["oovo"], t2, optimize=True))
    r2 = (_u_linear_doubles(B, F[o, o], F[v, v], t1, t2, False)
          + permute(jnp.einsum("bc,ijac->ijab", F[v, v], t2, optimize=True), 2, 3)
          - permute(jnp.einsum("kj,ikab->ijab", F[o, o], t2, optimize=True), 0, 1)
          + _u_singles_driven(B, t1))
    return t1 + d1 * r1, t2 + d2 * r2


def _u_cid(B, F, o, v, d1, d2, t1, t2, aux):
    off_vv = F[v, v] - jnp.diag(jnp.diagonal(F))[v, v]
    r = _u_linear_doubles(B, jnp.zeros_like(F[o, o]), off_vv, t1, t2, False)
    r = r + permute(jnp.einsum("ijae,be->ijab", t2, off_vv, optimize=True), 2, 3)
    E_corr = 0.25 * jnp.einsum("ijab,ijab->", B["oovv"], t2, optimize=True)
    return t1, d2 * (r - E_corr * t2)


def _u_cisd(B, F, o, v, d1, d2, t1, t2, aux):
    off_vv = F[v, v] - jnp.diag(jnp.diagonal(F))[v, v]
    off_oo = F[o, o] - jnp.diag(jnp.diagonal(F))[o, o]
    r1 = _u_linear_singles(B, F, o, v, t1, t2)
    r2 = (_u_linear_doubles(B, off_oo, off_vv, t1, t2, True)
          + _u_singles_driven(B, t1))
    E_corr = 0.25 * jnp.einsum("ijab,ijab->", B["oovv"], t2, optimize=True)
    return d1 * (r1 - E_corr * t1), d2 * (r2 - E_corr * t2)


def _u_qcisd(B, F, o, v, d1, d2, t1, t2, aux):
    off = jnp.diag(jnp.diagonal(F))
    Pvv = (F[v, v] - off[v, v]
           - 0.5 * jnp.einsum("mnaf,mnef->ae", t2, B["oovv"], optimize=True))
    Poo = (F[o, o] - off[o, o]
           + 0.5 * jnp.einsum("inef,mnef->mi", t2, B["oovv"], optimize=True))
    Pov = F[o, v] + jnp.einsum("nf,mnef->me", t1, B["oovv"], optimize=True)

    Hoooo = B["oooo"] + 0.25 * jnp.einsum("ijef,mnef->mnij", t2, B["oovv"],
                                          optimize=True)
    Hvvvv = B["vvvv"] + 0.25 * jnp.einsum("mnab,mnef->abef", t2, B["oovv"],
                                          optimize=True)
    Hovvo = B["ovvo"] - 0.5 * jnp.einsum("jnfb,mnef->mbej", t2, B["oovv"],
                                         optimize=True)

    r1 = (F[o, v] + jnp.einsum("ie,ae->ia", t1, Pvv, optimize=True)
          - jnp.einsum("ma,mi->ia", t1, Poo, optimize=True)
          + jnp.einsum("imae,me->ia", t2, Pov, optimize=True)
          - jnp.einsum("nf,naif->ia", t1, B["ovov"], optimize=True)
          - 0.5 * jnp.einsum("imef,maef->ia", t2, B["ovvv"], optimize=True)
          - 0.5 * jnp.einsum("mnae,nmei->ia", t2, B["oovo"], optimize=True))

    r2 = (B["oovv"]
          + permute(jnp.einsum("ijae,be->ijab", t2, Pvv, optimize=True), 2, 3)
          - permute(jnp.einsum("imab,mj->ijab", t2, Poo, optimize=True), 0, 1)
          + 0.5 * jnp.einsum("mnab,mnij->ijab", t2, Hoooo, optimize=True)
          + 0.5 * jnp.einsum("ijef,abef->ijab", t2, Hvvvv, optimize=True)
          + permute(permute(jnp.einsum("imae,mbej->ijab", t2, Hovvo,
                                       optimize=True), 2, 3), 0, 1)
          + _u_singles_driven(B, t1))
    return d1 * r1, d2 * r2


def _u_ccsd(B, F, o, v, d1, d2, t1, t2, aux):
    """Spin-orbital CCSD in the standard DPD intermediate form."""
    off = jnp.diag(jnp.diagonal(F))
    tau_h = _u_so_tau(t1, t2, 0.5)
    tau = _u_so_tau(t1, t2, 1.0)

    Pvv = (F[v, v] - off[v, v]
           - 0.5 * jnp.einsum("me,ma->ae", F[o, v], t1, optimize=True)
           + jnp.einsum("mf,mafe->ae", t1, B["ovvv"], optimize=True)
           - 0.5 * jnp.einsum("mnaf,mnef->ae", tau_h, B["oovv"], optimize=True))
    Poo = (F[o, o] - off[o, o]
           + 0.5 * jnp.einsum("ie,me->mi", t1, F[o, v], optimize=True)
           + jnp.einsum("ne,mnie->mi", t1, B["ooov"], optimize=True)
           + 0.5 * jnp.einsum("inef,mnef->mi", tau_h, B["oovv"], optimize=True))
    Pov = F[o, v] + jnp.einsum("nf,mnef->me", t1, B["oovv"], optimize=True)

    Hoooo = (B["oooo"]
             + permute(jnp.einsum("je,mnie->mnij", t1, B["ooov"], optimize=True), 2, 3)
             + 0.25 * jnp.einsum("ijef,mnef->mnij", tau, B["oovv"], optimize=True))
    Hvvvv = (B["vvvv"]
             - permute(jnp.einsum("mb,amef->abef", t1, B["vovv"], optimize=True), 0, 1)
             + 0.25 * jnp.einsum("mnab,mnef->abef", tau, B["oovv"], optimize=True))
    Hovvo = (B["ovvo"]
             + jnp.einsum("jf,mbef->mbej", t1, B["ovvv"], optimize=True)
             - jnp.einsum("nb,mnej->mbej", t1, B["oovo"], optimize=True)
             - jnp.einsum("jnfb,mnef->mbej",
                          0.5 * t2 + jnp.einsum("jf,nb->jnfb", t1, t1, optimize=True),
                          B["oovv"], optimize=True))

    r1 = (F[o, v] + jnp.einsum("ie,ae->ia", t1, Pvv, optimize=True)
          - jnp.einsum("ma,mi->ia", t1, Poo, optimize=True)
          + jnp.einsum("imae,me->ia", t2, Pov, optimize=True)
          - jnp.einsum("nf,naif->ia", t1, B["ovov"], optimize=True)
          - 0.5 * jnp.einsum("imef,maef->ia", t2, B["ovvv"], optimize=True)
          - 0.5 * jnp.einsum("mnae,nmei->ia", t2, B["oovo"], optimize=True))

    r2 = (B["oovv"]
          + permute(jnp.einsum(
              "ijae,be->ijab", t2,
              Pvv - 0.5 * jnp.einsum("mb,me->be", t1, Pov, optimize=True),
              optimize=True), 2, 3)
          - permute(jnp.einsum(
              "imab,mj->ijab", t2,
              Poo + 0.5 * jnp.einsum("je,me->mj", t1, Pov, optimize=True),
              optimize=True), 0, 1)
          + 0.5 * jnp.einsum("mnab,mnij->ijab", tau, Hoooo, optimize=True)
          + 0.5 * jnp.einsum("ijef,abef->ijab", tau, Hvvvv, optimize=True)
          + permute(permute(
              jnp.einsum("imae,mbej->ijab", t2, Hovvo, optimize=True)
              - jnp.einsum("ie,ma,mbej->ijab", t1, t1, B["ovvo"], optimize=True),
              2, 3), 0, 1)
          + _u_singles_driven(B, t1))
    return d1 * r1, d2 * r2


_RESTRICTED_UPDATES = {
    "LCCD": _r_lccd, "CCD": _r_ccd, "LCCSD": _r_lccsd, "CID": _r_cid,
    "CISD": _r_cisd, "QCISD": _r_qcisd, "CCSD": _r_ccsd, "CC2": _r_cc2,
    "CC3": _r_cc3,
}

_UNRESTRICTED_UPDATES = {
    "LCCD": _u_lccd, "CCD": _u_ccd, "LCCSD": _u_lccsd, "CID": _u_cid,
    "CISD": _u_cisd, "QCISD": _u_qcisd, "CCSD": _u_ccsd,
}


# ---------------------------------------------------------------------------
# The jitted while_loop solver
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CCSettings:
    method: str            # base iterative method name ("CCSD", "CID", ...)
    restricted: bool
    update_singles: bool
    keep_disconnected: bool
    n_occ: int
    n_virt: int
    max_iter: int
    use_diis: bool
    max_diis: int
    damping: float
    o_start: int = 0       # global index of the first correlated orbital
                           # (nonzero under FREEZECORE; used by CC2/CC3)


def _push_ring(buf, entry, n_valid, max_n):
    """Shift-down ring push: the newest entry always lands at the LAST slot.

    Only static indices are used (a contiguous roll + static-index write);
    validity is tracked by n_valid counting back from the end.
    """
    shifted = jnp.roll(buf, -1, axis=0)
    return shifted.at[max_n - 1].set(entry), jnp.minimum(n_valid + 1, max_n)


def _diis_coefficients(err_buf, n_valid, M):
    valid = jnp.arange(M) >= (M - n_valid)
    errs = jnp.where(valid[:, None], err_buf, 0.0)
    G = errs @ errs.T
    return _diis_coefficients_from_gram(G, n_valid, M)


def _diis_coefficients_from_gram(G, n_valid, M):
    """Bordered DIIS solve from a precomputed Gram block.  The solver body
    maintains G incrementally (only the newest error vector's inner products
    change per push), replacing the full (M,N)@(N,M) Gram."""
    dtype = G.dtype
    valid = jnp.arange(M) >= (M - n_valid)
    vv = valid[:, None] & valid[None, :]
    G = jnp.where(vv, G, 0.0)
    # Scale the Gram block to O(1): the bordered system's solution c is
    # invariant under G -> G/s (only the Lagrange multiplier rescales), and
    # an O(1) block keeps the f32 elimination inside the refined solver
    # accurate (late-iteration G entries are squared residuals ~1e-16).
    s = jnp.maximum(jnp.max(jnp.abs(G)), 1e-30)
    G = jnp.where(vv, G / s, 0.0) + jnp.where(
        jnp.eye(M, dtype=bool) & ~valid[:, None], 1.0, 0.0)
    A = jnp.zeros((M + 1, M + 1), dtype=dtype)
    A = A.at[:M, :M].set(G)
    A = A.at[:M, M].set(jnp.where(valid, -1.0, 0.0))
    A = A.at[M, :M].set(jnp.where(valid, -1.0, 0.0))
    rhs = jnp.zeros(M + 1, dtype=dtype).at[M].set(-1.0)
    coeffs, ok = linalg.solve_linear_small_refined(A, rhs)
    coeffs = jnp.where(valid, coeffs[:M], 0.0)
    # Exact sum-to-one: coefficient-solve error then only multiplies the
    # SPREAD of the stored amplitudes (~residual-sized), not their magnitude.
    csum = jnp.sum(coeffs)
    coeffs = coeffs / jnp.where(jnp.abs(csum) > 1e-3, csum, 1.0)
    ok = ok & (jnp.abs(csum) > 1e-3)
    return ok & jnp.all(jnp.isfinite(coeffs)), coeffs



def _guess_mp2_energy(settings: CCSettings, g, F, t1_0, t2_0):
    """Energy of the MP2 guess amplitudes (t1 = 0), traced INSIDE the solver
    programs so the CLI's "Guess t-amplitude MP2 energy" print costs no
    separate device call."""
    o, v = slice(0, settings.n_occ), slice(settings.n_occ, None)
    blocks = _restricted_blocks if settings.restricted else _unrestricted_blocks
    B = blocks(g, o, v)
    energy_fn = partial(
        _restricted_energy if settings.restricted else _unrestricted_energy,
        B, F[o, v], keep_disconnected=settings.keep_disconnected)
    return energy_fn(t1=jnp.zeros_like(t1_0), t2=t2_0)[0]


def _build_cc_solver_fn(settings: CCSettings):
    """The full iteration (update + energy + DIIS + damping + convergence)
    as one on-device while_loop (unjitted; see get_cc_solver)."""
    restricted = settings.restricted
    method = settings.method
    M = settings.max_diis
    no, nv = settings.n_occ, settings.n_virt
    update = (_RESTRICTED_UPDATES if restricted else _UNRESTRICTED_UPDATES)[method]

    def solver(g, F, d1, d2, t1_0, t2_0, ERI_AO, C, H_core, d3,
               energy_conv, amp_conv):
        dtype = t2_0.dtype
        o, v = slice(0, no), slice(no, None)
        if restricted:
            B = _restricted_blocks(g, o, v)
            energy_fn = partial(_restricted_energy, B, F[o, v],
                                keep_disconnected=settings.keep_disconnected)
        else:
            B = _unrestricted_blocks(g, o, v)
            energy_fn = partial(_unrestricted_energy, B, F[o, v],
                                keep_disconnected=settings.keep_disconnected)
        # CC2/CC3 rebuild T1-dressed MO integrals from the AO tensor each
        # iteration, indexed in the GLOBAL orbital space.
        aux = {"ERI_AO": ERI_AO, "C": C, "H_core": H_core, "d3": d3,
               "o": slice(settings.o_start, settings.o_start + no),
               "v": slice(settings.o_start + no, None)}

        def apply_update_energy(t1, t2):
            if restricted:
                t1n, t2n = update(B, F[o, v], d1, d2, t1, t2, aux)
            else:
                t1n, t2n = update(B, F, o, v, d1, d2, t1, t2, aux)
            return t1n, t2n, energy_fn(t1=t1n, t2=t2n)[0]

        n1 = t1_0.size

        def body(carry):
            # Amplitudes ride ONE flat ring (one push + one extrapolation
            # matvec instead of two of each) and the convergence norms are
            # f32 (threshold compares tolerate 1e-7 relative error).  The
            # DIIS error ring stays in the working dtype: an f32 ring was
            # measured to DOUBLE the iteration count at N2/STO-3G (23 vs 13
            # to the same thresholds) and to stall ~1e-10 short of the fixed
            # point -- the 1e-7 Gram noise wrecks the late-stage
            # extrapolation.
            (step, E, t1, t2, amp_buf, err_buf, gram, n_valid, conv, failed,
             stats) = carry

            t1n, t2n, En = apply_update_energy(t1, t2)
            dE = En - E

            tn_flat = jnp.concatenate([t1n.ravel(), t2n.ravel()])
            t_flat = jnp.concatenate([t1.ravel(), t2.ravel()])
            r = tn_flat - t_flat
            r32 = r.astype(jnp.float32)
            amp_ok = jnp.linalg.norm(r32[n1:]) < amp_conv
            if settings.update_singles:
                amp_ok = amp_ok & (jnp.linalg.norm(r32[:n1]) < amp_conv)
            is_conv = (jnp.abs(dE) < energy_conv) & amp_ok
            is_failed = (~jnp.all(jnp.isfinite(t2n))) | (En > 1000.0)

            amp_buf2, _ = _push_ring(amp_buf, tn_flat, n_valid, M)
            err_buf2, n_valid2 = _push_ring(err_buf, r, n_valid, M)

            tx = tn_flat
            gram2 = gram
            if settings.use_diis:
                # Incremental Gram: the push shifts rows down one slot, so
                # the surviving inner products shift diagonally; only the
                # newest vector's row/column is computed -- one (M,N)@(N,)
                # matvec in place of the full (M,N)@(N,M) product (exact
                # f64; every valid entry is recomputed when its row enters,
                # and invalid slots are masked inside the solve).
                g_new = jnp.einsum("ml,l->m", err_buf2, r)
                gram2 = jnp.roll(jnp.roll(gram, -1, axis=0), -1, axis=1)
                gram2 = gram2.at[M - 1, :].set(g_new).at[:, M - 1].set(g_new)
                ok, coeffs = _diis_coefficients_from_gram(gram2, n_valid2, M)
                use = (step > 2) & ok & ~is_conv
                # Extrapolate as tn + sum_m c_m (amp_m - tn): identical math
                # (the coefficients sum to one exactly), but the spread
                # terms are residual-sized, so the matvec runs in f32 --
                # injected noise ~1e-7 * |spread|, far below the path's
                # working precision (the certifying iterate is
                # un-extrapolated).
                spread = (amp_buf2 - tn_flat[None, :]).astype(jnp.float32)
                delta = jnp.einsum("m,ml->l", coeffs.astype(jnp.float32),
                                   spread)
                tx = jnp.where(use, tn_flat + delta.astype(dtype), tn_flat)
                n_valid2 = jnp.where((step > 2) & ~ok, 0, n_valid2)

            if settings.damping != 0.0:
                f = settings.damping
                tx = jnp.where(is_conv, tx, f * t_flat + (1.0 - f) * tx)

            t1x = tx[:n1].reshape(t1_0.shape)
            t2x = tx[n1:].reshape(t2_0.shape)

            # Shift-down history (static-index write; see _push_ring)
            stats = jnp.roll(stats, -1, axis=0).at[-1].set(jnp.stack([En, dE]))
            return (step + 1, En, t1x, t2x, amp_buf2, err_buf2, gram2,
                    n_valid2, is_conv, is_failed, stats)

        def cond(carry):
            step, conv, failed = carry[0], carry[-3], carry[-2]
            return (step <= settings.max_iter) & ~conv & ~failed

        carry0 = (jnp.asarray(1), jnp.asarray(0.0, dtype=dtype), t1_0, t2_0,
                  jnp.zeros((M, t1_0.size + t2_0.size), dtype=dtype),
                  jnp.zeros((M, t1_0.size + t2_0.size), dtype=dtype),
                  jnp.zeros((M, M), dtype=dtype),
                  jnp.asarray(0), jnp.asarray(False), jnp.asarray(False),
                  jnp.zeros((settings.max_iter, 2), dtype=dtype))

        final = jax.lax.while_loop(cond, body, carry0)
        step, E, t1, t2 = final[0], final[1], final[2], final[3]
        conv, failed, stats = final[-3], final[-2], final[-1]
        # Undo the shift-down storage: iteration i lands at row i
        stats = jnp.roll(stats, step - 1, axis=0)
        E_total, E_s, E_c, E_d = energy_fn(t1=t1, t2=t2)
        e_guess = energy_fn(t1=jnp.zeros_like(t1_0), t2=t2_0)[0]
        return (step - 1, conv, failed, E, t1, t2, stats,
                jnp.stack([E_s, E_c, E_d]), e_guess)

    return solver


_SOLVER_CACHE: dict = {}


def get_cc_solver(settings: CCSettings):
    if settings not in _SOLVER_CACHE:
        _SOLVER_CACHE[settings] = jax.jit(_build_cc_solver_fn(settings))
    return _SOLVER_CACHE[settings]


# ---------------------------------------------------------------------------
# Mixed-precision Newton--Krylov finisher
# ---------------------------------------------------------------------------
# Starting from the f32 fixed point, each Newton step evaluates ONE f64
# residual r = Phi(t) - t and solves the correction equation
# (I - Phi'(t)) s = r by GMRES, applying the Jacobian with f32 jax.jvp
# (absolute error ~|s|*1e-6, far below the step's quadratic gain).  Two f64
# residuals typically replace the ~13 f64 iterations of the plain loop.
# This path is not routed by the driver: with native f64 the plain
# while_loop converges sooner (PERF.md); it is kept, reached by its tests,
# until its removal is decided.  (No reference counterpart: tuna_cc.py
# iterates everything eagerly in f64 NumPy.)

_NEWTON_MAX_STEPS = 6
_GMRES_KRYLOV = 10
# Quadratic-remainder cancellation inside each advancing Newton step: after
# the GMRES solve J s = r (J = I - Phi'), the post-update residual is
# r(t+s) = L + (1/2) Phi''[s,s] + O(s^3), where L is the linear-solve
# leftover.  Both terms are computable in f32 -- the curvature via a NESTED
# jvp (a derivative, not a difference: no cancellation against the O(1)
# amplitudes), L from the Krylov basis -- so a short second solve
# J s2 = L + q pushes the post-step residual from ~C|r|^2 (4e-8 at the
# 6-311G gate, just above AMPCONV=1e-8) to ~1e-9, letting the NEXT f64
# residual certify convergence: two f64 evaluations instead of three.
_NEWTON_QUAD = os.environ.get("TUNA_TPU_NEWTON_QUAD", "1") != "0"
_GMRES_QUAD_KRYLOV = int(os.environ.get("TUNA_TPU_GMRES_M2", "6"))

# How deep the production path's f32 DIIS warm phase iterates before handing
# to the Newton finisher.  With the quadratic-remainder refinement and the
# solved-correction certification below, TWO Newton steps certify from any
# warm start at or below r ~ 1e-4, so the warm phase stops at moderate
# thresholds instead of running to its cap.
_WARM_ENERGY_CONV = float(os.environ.get("TUNA_TPU_WARM_ECONV", 1e-8))
_WARM_AMP_CONV = float(os.environ.get("TUNA_TPU_WARM_AMPCONV", 1e-5))
_WARM_MAX_ITER = int(os.environ.get("TUNA_TPU_WARM_MAXITER", 30))


def _gmres_static(matvec, rhs, m=_GMRES_KRYLOV, return_residual=False):
    """Statically-unrolled GMRES (no restarts): m matvecs, least squares in
    the Krylov basis via the unrolled Gauss-Jordan solve.  All indices are
    static -- inside a jitted while_loop body, dynamic scatters cost more
    than the arithmetic they index."""
    dtype = rhs.dtype
    beta = jnp.linalg.norm(rhs)
    safe_beta = jnp.where(beta > 0, beta, 1.0)
    Q = [rhs / safe_beta]
    H = jnp.zeros((m + 1, m), dtype=dtype)
    for k in range(m):
        w = matvec(Q[k])
        for j in range(k + 1):
            hjk = jnp.vdot(Q[j], w)
            w = w - hjk * Q[j]
            H = H.at[j, k].set(hjk)
        hk1 = jnp.linalg.norm(w)
        H = H.at[k + 1, k].set(hk1)
        Q.append(w / jnp.where(hk1 > 1e-30, hk1, 1.0))
    e1 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
    # Normal equations on the (m+1, m) Hessenberg least-squares problem,
    # solved in f64 (tiny system; f32 normal equations square the condition
    # number and cap the Newton step at ~3 digits).  The small ridge keeps a
    # rank-deficient basis (early breakdown) solvable.
    from ..ops import linalg as _linalg
    H64 = H.astype(jnp.float64)
    A = H64.T @ H64 + 1e-24 * jnp.eye(m, dtype=jnp.float64)
    # Full-f64 elimination, NOT the f32-refined solver: the normal equations
    # square kappa(H), and near the residual noise floor the Krylov basis is
    # close to rank-deficient, so kappa(A) can exceed the refined solver's
    # ~1e6 range -- a degraded y here costs a whole extra Newton step.
    y, _ = _linalg.solve_linear_small(A, H64.T @ e1.astype(jnp.float64))
    y = y.astype(dtype)
    s = Q[0] * y[0]
    for k in range(1, m):
        s = s + Q[k] * y[k]
    if not return_residual:
        return s
    # Linear-solve leftover L = rhs - J s, reconstructed from the Krylov
    # basis: L = Q_{m+1} (beta e1 - H y) -- m+1 axpys, no extra matvec.
    resid = (e1 - H @ y).astype(dtype)
    L = Q[0] * resid[0]
    for k in range(1, m + 1):
        L = L + Q[k] * resid[k]
    return s, L


def _build_newton_fn(settings: CCSettings):
    restricted = settings.restricted
    update = (_RESTRICTED_UPDATES if restricted else _UNRESTRICTED_UPDATES)[settings.method]
    no, nv = settings.n_occ, settings.n_virt
    with_singles = settings.update_singles

    def finisher(g, F, d1, d2, t1_0, t2_0, ERI_AO, C, H_core, d3,
                 energy_conv, amp_conv):
        """t*_0: amplitudes at (or near) the f32 fixed point, f64 dtype.
        ERI_AO/C/H_core/d3 are dummies except for CC2/CC3, which rebuild
        T1-dressed MO integrals inside the residual.  Returns
        (n_newton_steps, converged, failed, E, t1, t2, E_history,
        energy parts)."""
        f64 = t2_0.dtype
        f32 = jnp.float32
        o, v = slice(0, no), slice(no, None)

        blocks = _restricted_blocks if restricted else _unrestricted_blocks
        B64 = blocks(g, o, v)
        g32 = jnp.asarray(g, dtype=f32)
        B32 = blocks(g32, o, v)
        F32 = jnp.asarray(F, dtype=f32)
        d132, d232 = jnp.asarray(d1, dtype=f32), jnp.asarray(d2, dtype=f32)

        aux_slices = {"o": slice(settings.o_start, settings.o_start + no),
                      "v": slice(settings.o_start + no, None)}
        aux64 = {"ERI_AO": ERI_AO, "C": C, "H_core": H_core, "d3": d3,
                 **aux_slices}
        aux32 = {"ERI_AO": jnp.asarray(ERI_AO, dtype=f32),
                 "C": jnp.asarray(C, dtype=f32),
                 "H_core": jnp.asarray(H_core, dtype=f32),
                 "d3": jnp.asarray(d3, dtype=f32), **aux_slices}

        def phi(Bx, Fx, d1x, d2x, t1, t2, auxx):
            if restricted:
                return update(Bx, Fx[o, v], d1x, d2x, t1, t2, auxx)
            return update(Bx, Fx, o, v, d1x, d2x, t1, t2, auxx)

        energy_fn = partial(_restricted_energy if restricted else _unrestricted_energy,
                            B64, F[o, v] if restricted else F[o, v],
                            keep_disconnected=settings.keep_disconnected)
        energy32_fn = partial(_restricted_energy if restricted else _unrestricted_energy,
                              B32, F32[o, v],
                              keep_disconnected=settings.keep_disconnected)

        n1 = t1_0.size

        def pack(s1, s2):
            if with_singles:
                return jnp.concatenate([s1.ravel(), s2.ravel()])
            return s2.ravel()

        def unpack(u):
            if with_singles:
                return u[:n1].reshape(t1_0.shape), u[n1:].reshape(t2_0.shape)
            return jnp.zeros(t1_0.shape, dtype=u.dtype), u.reshape(t2_0.shape)

        def body(carry):
            step, E, t1, t2, conv, failed, hist = carry

            # ONE f64 residual (the only f64 work per Newton step)
            p1, p2 = phi(B64, F, d1, d2, t1, t2, aux64)
            r1 = p1 - t1
            r2 = p2 - t2
            En = energy_fn(t1=t1, t2=t2)[0]
            r_norm = jnp.linalg.norm(r2.ravel())
            if with_singles:
                r_norm = jnp.maximum(r_norm, jnp.linalg.norm(r1.ravel()))
            is_failed = ~jnp.all(jnp.isfinite(r2)) | (jnp.abs(En) > 1000.0)

            # Correction equation in f32: (I - Phi') s = r, solved EVERY
            # step (no certify-only skip): convergence is certified on the
            # energy the SOLVED correction would move, |<dE/dt, s>| with
            # s = J^-1 r -- the properly (I-Phi')^-1-amplified estimate.
            # (Certifying on <dE/dt, r> under-estimated that error by the
            # Jacobian inverse, which forced an extra full f64 residual
            # pass.)
            t1_32 = jnp.asarray(t1, dtype=f32)
            t2_32 = jnp.asarray(t2, dtype=f32)

            def matvec(u):
                s1, s2 = unpack(u)
                _, (j1, j2) = jax.jvp(
                    lambda a, b: phi(B32, F32, d132, d232, a, b, aux32),
                    (t1_32, t2_32), (s1, s2))
                return u - pack(j1, j2)

            rhs = pack(jnp.asarray(r1, dtype=f32),
                       jnp.asarray(r2, dtype=f32))
            s_u, L = _gmres_static(matvec, rhs, return_residual=True)
            if _NEWTON_QUAD:
                # Post-update residual estimate r(t+s) = L + q with
                # q = (1/2) Phi''(t)[s,s] via nested f32 jvp; one short
                # second solve J s2 = L + q cancels it (see the
                # _NEWTON_QUAD note above).
                c1, c2 = unpack(s_u)

                def dphi(a, b):
                    return jax.jvp(
                        lambda x, y: phi(B32, F32, d132, d232, x, y,
                                         aux32),
                        (a, b), (c1, c2))[1]

                q1, q2 = jax.jvp(dphi, (t1_32, t2_32), (c1, c2))[1]
                r_next = L + 0.5 * pack(q1, q2)
                s_u = s_u + _gmres_static(matvec, r_next,
                                          m=_GMRES_QUAD_KRYLOV)
            s1_32, s2_32 = unpack(s_u)

            # Energy certification in f32: e_lin = <dE/dt, s> is a
            # DERIVATIVE evaluated at the f32 iterate, not a difference of
            # O(1) energies -- its f32 round-off is ~sqrt(K) eps |dE/dt||s|
            # ~ 1e-14 Ha at |s| ~ amp_conv, far below the 1e-9 contract.
            _, e_lin32 = jax.jvp(
                lambda a, b: energy32_fn(t1=a, t2=b)[0],
                (t1_32, t2_32), (s1_32, s2_32))
            # A non-finite GMRES correction or energy estimate means the f32
            # solve diverged: route to the pure-f64 fallback solver instead
            # of masking it to zero (which would let the 'e_err < tol'
            # convergence branch certify NaN amplitudes).
            corr_finite = jnp.all(jnp.isfinite(s_u)) & jnp.isfinite(e_lin32)
            is_failed = is_failed | ~corr_finite
            e_lin = jnp.where(corr_finite, e_lin32, 0.0).astype(f64)
            En_corr = En + jnp.where(is_failed, 0.0, e_lin)
            dE = En_corr - E
            e_err = jnp.abs(e_lin)
            is_conv = (r_norm < amp_conv) & ((jnp.abs(dE) < energy_conv)
                                             | (r_norm < 0.1 * energy_conv)
                                             | (e_err < 0.5 * energy_conv))

            # APPLY the correction unless the step failed, or this is a
            # certifying step whose predicted energy move e_err exceeds the
            # tolerance (an inaccurate f32 GMRES step on an ill-conditioned
            # I-Phi' must not move the certified iterate by more than
            # energy_conv after certification).  In the normal certifying
            # case s ~ J^-1 r with r ~ amp_conv only moves the amplitudes
            # toward the fixed point, so the post-loop f64 energy is
            # evaluated at a strictly better iterate.
            ok = ~is_failed & (~is_conv | (e_err < energy_conv))
            if with_singles:
                t1n = jnp.where(ok, t1 + s1_32.astype(f64), t1)
            else:
                t1n = t1
            t2n = jnp.where(ok, t2 + s2_32.astype(f64), t2)
            En_out = En + jnp.where(ok, e_lin, 0.0)

            hist = jnp.roll(hist, -1, axis=0).at[-1].set(
                jnp.stack([En_out, dE, r_norm.astype(f64)]))
            return step + 1, En_out, t1n, t2n, is_conv, is_failed, hist

        def cond(carry):
            step, conv, failed = carry[0], carry[4], carry[5]
            return (step <= _NEWTON_MAX_STEPS) & ~conv & ~failed

        hist0 = jnp.zeros((_NEWTON_MAX_STEPS, 3), dtype=f64)
        carry0 = (jnp.asarray(1), jnp.asarray(0.0, dtype=f64), t1_0, t2_0,
                  jnp.asarray(False), jnp.asarray(False), hist0)
        step, E, t1, t2, conv, failed, hist = jax.lax.while_loop(cond, body, carry0)
        hist = jnp.roll(hist, step - 1, axis=0)
        E_total, E_s, E_c, E_d = energy_fn(t1=t1, t2=t2)
        return (step - 1, conv, failed, E_total, t1, t2, hist,
                jnp.stack([E_s, E_c, E_d]))

    return finisher


_FINISHER_CACHE: dict = {}


def get_newton_finisher(settings: CCSettings):
    if settings not in _FINISHER_CACHE:
        _FINISHER_CACHE[settings] = jax.jit(_build_newton_fn(settings))
    return _FINISHER_CACHE[settings]


def _build_production_fn(settings: CCSettings):
    """f32 DIIS warm solve + Newton--Krylov f64 refinement fused into ONE
    jittable call: a single device call and no intermediate host transfers
    of the warm amplitudes."""
    # The warm phase converges to the f32 noise floor or stalls -- either
    # way its amplitudes are accepted below -- so its iteration budget is
    # capped independently of the production max_iter (a stalled f32 phase
    # must not spin to max_iter before Newton takes over).
    from dataclasses import replace as _replace
    solve_fn = _build_cc_solver_fn(
        _replace(settings, max_iter=min(settings.max_iter, _WARM_MAX_ITER)))
    finish_fn = _build_newton_fn(settings)

    def production(g, F, d1, d2, t1_0, t2_0, ERI_AO, C, H_core, d3,
                   energy_conv, amp_conv,
                   warm_energy_conv=_WARM_ENERGY_CONV,
                   warm_amp_conv=_WARM_AMP_CONV):
        f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
        f64 = t2_0.dtype
        # The warm thresholds are runtime scalars (not trace constants), so
        # one compiled executable serves any warm-depth setting.
        warm = solve_fn(f32(g), f32(F), f32(d1), f32(d2), f32(t1_0),
                        f32(t2_0), f32(ERI_AO), f32(C), f32(H_core), f32(d3),
                        jnp.float32(warm_energy_conv),
                        jnp.float32(warm_amp_conv))
        n_warm, warm_conv, warm_failed = warm[0], warm[1], warm[2]
        # Accept the warm amplitudes whenever the phase stayed finite, even
        # if it stalled short of its thresholds: a stalled-but-finite f32
        # iterate is still a far better Newton start than the MP2 guess
        # (each Newton step saved is one f64 residual + GMRES).
        warm_ok = ~warm_failed & jnp.all(jnp.isfinite(warm[5]))
        t1w = jnp.where(warm_ok, warm[4].astype(f64), t1_0)
        t2w = jnp.where(warm_ok, warm[5].astype(f64), t2_0)
        n_warm = jnp.where(warm_ok, n_warm, 0)
        out = finish_fn(g, F, d1, d2, t1w, t2w, ERI_AO, C, H_core, d3,
                        energy_conv, amp_conv)
        # f64 guess energy for the CLI print, traced into the same program
        # (the warm solver's trailing e_guess is f32; recompute in f64).
        e_guess = _guess_mp2_energy(settings, g, F, t1_0, t2_0)
        return (n_warm, warm_ok, warm[6]) + out + (e_guess,)

    return production


_PRODUCTION_CACHE: dict = {}


def get_production_solver(settings: CCSettings):
    """(n_warm_f32, warm_ok, warm_stats, n_newton, converged, failed, E,
    t1, t2, newton_hist, energy_parts) in one jitted call."""
    if settings not in _PRODUCTION_CACHE:
        _PRODUCTION_CACHE[settings] = jax.jit(_build_production_fn(settings))
    return _PRODUCTION_CACHE[settings]


# ---------------------------------------------------------------------------
# Host-level iteration driver
# ---------------------------------------------------------------------------

_NO_SINGLES = ("LCCD", "CCD", "CID")


def _initial_print(E_MP2, method, calculation, silent):
    """Pre-iteration banner.  E_MP2 (the guess-amplitude energy) is computed
    INSIDE the solver's jitted program and passed in here as a plain float."""
    log_spacer(calculation, silent=silent, start="\n")
    log(f"              {method.name:>5} Energy and Density ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log(f"  Energy convergence tolerance:        {calculation.energy_convergence:.10f}", calculation, 1, silent=silent)
    log(f"  Amplitude convergence tolerance:     {calculation.amp_conv:.10f}", calculation, 1, silent=silent)

    log(f"\n  Guess t-amplitude MP2 energy:       {E_MP2:.10f}\n", calculation, 1, silent=silent)
    if calculation.correlated_damping_parameter != 0:
        log(f"  Using damping parameter of {calculation.correlated_damping_parameter:.2f} for convergence.", calculation, 1, silent=silent)
    if calculation.DIIS:
        log(f"  Using DIIS, storing {calculation.max_DIIS_matrices} matrices, for convergence.", calculation, 1, silent=silent)
    log(f"\n  Starting {method.name} iterations...\n", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Step          Correlation E               DE", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)


def calculate_coupled_cluster_energy(g, o, v, t_amplitudes, e_denominators, F,
                                     method, calculation, silent, SCF_output,
                                     integrals):
    """Solve the amplitude equations for one iterative method on device."""
    original_name = method.name
    base_name = method.name
    # Both bracket and parenthesis spellings dispatch to the same iterative
    # base + Lee-formulation correction (the reference registers CCSD(T) etc.
    # at tuna_util.py:1355 but its substring dispatch crashes on them with a
    # TypeError in apply_damping; here they simply work).
    for tag in ("[T]", "[Q]", "(T)", "(Q)"):
        base_name = base_name.split(tag)[0]

    if base_name in ("CCSDT", "CISDT", "CCSDTQ"):
        from .cc_triples import solve_triples_method
        return solve_triples_method(g, o, v, t_amplitudes, e_denominators, F,
                                    method, base_name, calculation, silent,
                                    SCF_output, integrals)

    t_ia, t_ijab, _, _ = t_amplitudes
    d1, d2 = e_denominators[0], e_denominators[1]
    restricted = calculation.reference == "RHF"

    if base_name not in (_RESTRICTED_UPDATES if restricted else _UNRESTRICTED_UPDATES):
        error(f"The {base_name} method is not yet available in TUNA-TPU!")

    dummy = jnp.zeros((1, 1))
    ERI_AO = C = H_core = dummy
    d3 = jnp.zeros((1,))
    if base_name in ("CC2", "CC3"):
        ERI_AO = jnp.asarray(integrals.ERI_AO)
        C = jnp.asarray(SCF_output.molecular_orbitals)
        H_core = jnp.asarray(integrals.H_core)
        if base_name == "CC3":
            d3 = e_denominators[2]

    settings = CCSettings(
        method=base_name,
        restricted=restricted,
        update_singles=base_name not in _NO_SINGLES,
        keep_disconnected=base_name not in _NO_DISCONNECTED,
        n_occ=o.stop - (o.start or 0),
        n_virt=int(t_ijab.shape[-1]),
        max_iter=int(calculation.correlated_max_iter),
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        damping=float(calculation.correlated_damping_parameter),
        o_start=int(o.start or 0),
    )

    # Frozen-core slices start at o.start; shift to local indexing for the
    # solver, which slices g itself.
    if (o.start or 0) != 0:
        g = g[o.start:, o.start:, o.start:, o.start:]
        F = F[o.start:, o.start:]

    solver = get_cc_solver(settings)

    # The plain f64 while_loop on every backend: on the GPU it converges
    # sooner than the mixed f32-warm + Newton--Krylov solve (PERF.md).
    (n_steps, converged, failed, E_CC, t1, t2, stats, parts,
     e_guess) = solver(
        g, F, d1, d2, t_ia, t_ijab, ERI_AO, C, H_core, d3,
        calculation.energy_convergence, calculation.amp_conv)
    _initial_print(float(e_guess), method, calculation, silent)

    n_steps = int(n_steps)
    stats = np.asarray(stats)
    for i in range(n_steps):
        log(f"  {i + 1:3.0f}           {stats[i, 0]:13.10f}         {stats[i, 1]:13.10f}",
            calculation, 1, silent=silent)

    if bool(failed):
        error(f'Non-finite encountered in {base_name} iteration. Try stronger '
              'damping with the "CORRDAMP" keyword?.')
    if not bool(converged):
        error(f"The {base_name} iterations failed to converge! Try increasing "
              "the maximum iterations with CORRMAXITER?")

    E_CC = float(E_CC)
    E_singles, E_connected, E_disconnected = [float(x) for x in np.asarray(parts)]

    log_spacer(calculation, silent=silent)
    log(f"\n  Singles contribution:               {E_singles:13.10f}", calculation, 1, silent=silent)
    log(f"  Connected doubles contribution:     {E_connected:13.10f}", calculation, 1, silent=silent)
    log(f"  Disconnected doubles contribution:  {E_disconnected:13.10f}", calculation, 1, silent=silent)
    log(f"\n  {base_name} correlation energy:  {' ' * (10 - len(base_name))}    {E_CC:.10f}",
        calculation, 1, silent=silent)
    method.name = original_name

    t3 = t_amplitudes[2]
    t4 = t_amplitudes[3]
    return E_CC, (t1, t2, t3, t4)


# ---------------------------------------------------------------------------
# Perturbative triples and quadruples (one-shot jitted contractions)
# ---------------------------------------------------------------------------

@jax.jit
def _restricted_T_tensors(g_oovv, g_ovvv, g_oovo, t1, t2, d3):
    """Spin-adapted (T): disconnected V, connected W and its weighted form."""
    V = (jnp.einsum("jkbc,ia->ijkabc", g_oovv, t1, optimize=True)
         + jnp.einsum("ikac,jb->ijkabc", g_oovv, t1, optimize=True)
         + jnp.einsum("ijab,kc->ijkabc", g_oovv, t1, optimize=True))

    raw = (jnp.einsum("ibaf,kjcf->ijkabc", g_ovvv, t2, optimize=True)
           - jnp.einsum("ijam,mkbc->ijkabc", g_oovo, t2, optimize=True))
    W = (raw + raw.transpose(1, 0, 2, 4, 3, 5) + raw.transpose(2, 1, 0, 5, 4, 3)
         + raw.transpose(0, 2, 1, 3, 5, 4) + raw.transpose(2, 0, 1, 5, 3, 4)
         + raw.transpose(1, 2, 0, 4, 5, 3))
    W_weighted = (4.0 * W + W.transpose(2, 0, 1, 3, 4, 5) + W.transpose(1, 2, 0, 3, 4, 5)
                  - 4.0 * W.transpose(2, 1, 0, 3, 4, 5) - W.transpose(0, 2, 1, 3, 4, 5)
                  - W.transpose(1, 0, 2, 3, 4, 5))
    return V, W, W_weighted


def restricted_CCSD_T(g, e_ijkabc, t_ia, t_ijab, o, v, method, calculation, silent):
    """(T) via the spin-adapted Lee formulation (ref: tuna_cc.py:2688-2758)."""
    method.name = method.name.replace("[", "(").replace("]", ")")
    log_spacer(calculation, silent=silent, start="\n")
    log(f"                    {method.name} Energy ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    space = "" if "QCISD" in method.name else " "
    log("  Forming disconnected amplitudes...         ", calculation, 1, end="", silent=silent)
    V, W, W_weighted = _restricted_T_tensors(g[o, o, v, v], g[o, v, v, v],
                                             g[o, o, v, o], t_ia, t_ijab, e_ijkabc)
    if "QCISD" in method.name:
        V = V * 2.0
    log("[Done]", calculation, 1, silent=silent)
    log("  Forming connected amplitudes...            ", calculation, 1, silent=silent)

    log(f"\n  Calculating {method.name} correlation energy... {space}", calculation, 1, end="", silent=silent)
    E_T = (1.0 / 3.0) * float(jnp.einsum("ijkabc,ijkabc,ijkabc->", W + V,
                                         W_weighted, e_ijkabc, optimize=True))
    log(f"[Done]\n\n  {method.name} correlation energy:       {space} {E_T:13.10f}",
        calculation, 1, silent=silent)
    return E_T


@jax.jit
def _unrestricted_T_tensors(g_oovv, g_vovv, g_ovoo, t1, t2, d3):
    def antisym3(x):
        x = x - x.swapaxes(3, 4) - x.swapaxes(3, 5)
        return x - x.swapaxes(0, 1) - x.swapaxes(0, 2)

    disc = jnp.einsum("ia,jkbc->ijkabc", t1, g_oovv, optimize=True)
    t_d = d3 * antisym3(disc)
    conn = (jnp.einsum("jkae,eibc->ijkabc", t2, g_vovv, optimize=True)
            - jnp.einsum("imbc,majk->ijkabc", t2, g_ovoo, optimize=True))
    t_c = d3 * antisym3(conn)
    E = (1.0 / 36.0) * jnp.einsum("ijkabc,ijkabc->", t_c / d3, t_c + t_d,
                                  optimize=True)
    return E, t_c, t_d


def unrestricted_CCSD_T(g, e_ijkabc, t_ia, t_ijab, o, v, method, calculation, silent):
    """(T) via the spin-orbital formulation (ref: tuna_cc.py:2769-2837)."""
    method.name = method.name.replace("[", "(").replace("]", ")")
    log_spacer(calculation, silent=silent, start="\n")
    log(f"                   {method.name} Energy  ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    space = "" if "QCISD" in method.name else " "
    log("  Forming disconnected amplitudes...         ", calculation, 1, silent=silent)
    log("  Forming connected amplitudes...            ", calculation, 1, silent=silent)
    E_T, t_c, t_d = _unrestricted_T_tensors(g[o, o, v, v], g[v, o, v, v],
                                            g[o, v, o, o], t_ia, t_ijab, e_ijkabc)
    if "QCISD" in method.name:
        E_T = (1.0 / 36.0) * jnp.einsum("ijkabc,ijkabc->", t_c / e_ijkabc,
                                        t_c + 2.0 * t_d, optimize=True)
    E_T = float(E_T)
    log(f"\n  Calculating {method.name} correlation energy... {space}[Done]",
        calculation, 1, silent=silent)
    log(f"\n  {method.name} correlation energy:       {space} {E_T:13.10f}",
        calculation, 1, silent=silent)
    return E_T


def restricted_CCSDT_Q(g, e_ijklabcd, t_ijab, t_ijkabc, o, v, calculation, silent):
    """Perturbative quadruples, MP5+MP6 form (ref: tuna_cc.py:2848-2939)."""
    log_spacer(calculation, silent=silent, start="\n")
    log("                   CCSDT(Q) Energy ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Forming quadruples amplitudes...           ", calculation, 1, end="", silent=silent)

    g = g.swapaxes(1, 2)  # <pq|rs> -> (pq|rs)
    u_ijab = _u_of(t_ijab)
    K_ijab = g[o, v, o, v].transpose(0, 2, 1, 3)
    L_ijab = 2 * K_ijab - K_ijab.swapaxes(2, 3)

    def permute_four_columns(array):
        array = (array + array.swapaxes(0, 3).swapaxes(4, 7)
                 + array.swapaxes(1, 3).swapaxes(5, 7) + array.swapaxes(2, 3).swapaxes(6, 7))
        array = array + array.swapaxes(0, 2).swapaxes(4, 6) + array.swapaxes(1, 2).swapaxes(5, 6)
        return array + array.swapaxes(0, 1).swapaxes(4, 5)

    G = jnp.einsum("iabe,jklecd->ijklabcd", g[o, v, v, v], t_ijkabc, optimize=True)
    G += -jnp.einsum("iamj,mklbcd->ijklabcd", g[o, v, o, o], t_ijkabc, optimize=True)
    G += jnp.einsum("minj,mkac,nlbd->ijklabcd", g[o, o, o, o], t_ijab, t_ijab, optimize=True)
    G += -2 * jnp.einsum("iame,kjeb,mlcd->ijklabcd", g[o, v, o, v], t_ijab, t_ijab, optimize=True)
    G += jnp.einsum("cfae,ijeb,klfd->ijklabcd", g[v, v, v, v], t_ijab, t_ijab, optimize=True)
    G += -2 * jnp.einsum("bemi,kjce,mlad->ijklabcd", g[v, v, o, o], t_ijab, t_ijab, optimize=True)
    G = 0.5 * permute_four_columns(G)
    t_ijklabcd = G * e_ijklabcd
    log("[Done]", calculation, 1, silent=silent)

    log("\n  Calculating MP5 contribution to energy...  ", calculation, 1, end="", silent=silent)
    E_MP5 = float(jnp.einsum("ijklcdab,klcd,ijab->", t_ijklabcd, u_ijab, K_ijab, optimize=True))
    E_MP5 += -2 * float(jnp.einsum("ijklbdac,kldc,ijba->", t_ijklabcd, u_ijab, L_ijab, optimize=True))
    E_MP5 += float(jnp.einsum("ijklabcd,klcd,ijab->", t_ijklabcd, u_ijab, L_ijab, optimize=True))
    log("[Done]", calculation, 1, silent=silent)

    log("  Calculating MP6 contribution to energy...  ", calculation, 1, end="", silent=silent)
    t_bar = -2 * t_ijklabcd - t_ijklabcd.swapaxes(4, 6).swapaxes(5, 7) + t_ijklabcd.swapaxes(4, 5)
    t_tilde = (2 * t_ijklabcd.transpose(0, 1, 2, 3, 7, 5, 4, 6)
               - t_ijklabcd.transpose(0, 1, 2, 3, 5, 7, 4, 6))
    t_tilde = t_tilde + t_tilde.swapaxes(2, 3).swapaxes(6, 7)

    term = jnp.einsum("mjicba,ldkm->ijklabcd", t_ijkabc, g[o, v, o, o], optimize=True)
    term2 = jnp.einsum("kjieba,ldce->ijklabcd", t_ijkabc, g[o, v, v, v], optimize=True)
    alpha = 2 * term - term.swapaxes(6, 7) - 2 * term2 + term2.swapaxes(2, 3)
    term = jnp.einsum("mjicba,kdlm->ijklabcd", t_ijkabc, g[o, v, o, o], optimize=True)
    term2 = jnp.einsum("ljieba,kdce->ijklabcd", t_ijkabc, g[o, v, v, v], optimize=True)
    beta = 2 * term - term.swapaxes(6, 7) - 2 * term2 + term2.swapaxes(2, 3)

    E_MP6 = 2 * float(jnp.einsum("ijklabcd,ijklabcd->", alpha, t_bar, optimize=True))
    E_MP6 += 2 * float(jnp.einsum("ijklabcd,ijklabcd->", beta, t_tilde, optimize=True))
    E_Q = E_MP5 + E_MP6
    log("[Done]", calculation, 1, silent=silent)

    log(f"\n  Contribution from MP5:              {E_MP5:13.10f}", calculation, 2, silent=silent)
    log(f"  Contribution from MP6:              {E_MP6:13.10f}", calculation, 2, silent=silent)
    log(f"\n  CCSDT(Q) correlation energy:        {E_Q:13.10f}", calculation, 1, silent=silent)
    return E_Q


# ---------------------------------------------------------------------------
# Post-processing
# ---------------------------------------------------------------------------

@partial(jax.jit,
         static_argnames=("n_orbitals", "n_occ", "o_start", "o_stop", "rhf"))
def _linearised_density_mo(t_ia, t_ijab, n_orbitals, n_occ, o_start, o_stop,
                           rhf):
    # o/v address the CORRELATED window of the full orbital space (o_start
    # is nonzero under FREEZECORE); P_ref fills every occupied orbital.
    o, v = slice(o_start, o_stop), slice(o_stop, None)
    P_CC = jnp.zeros((n_orbitals, n_orbitals))
    if rhf:
        u_ijab = _u_of(t_ijab)
        P_CC = P_CC.at[v, v].add(jnp.einsum("ijbc,ijac->ab", t_ijab, u_ijab))
        P_CC = P_CC.at[o, o].add(-jnp.einsum("ikab,jkab->ij", t_ijab, u_ijab))
        P_CC = P_CC.at[o, v].add(t_ia + jnp.einsum("ijab,jb->ia", u_ijab, t_ia))
    else:
        P_CC = P_CC.at[v, v].add(0.5 * jnp.einsum("ijbc,ijac->ab", t_ijab, t_ijab))
        P_CC = P_CC.at[o, o].add(-0.5 * jnp.einsum("ikab,jkab->ij", t_ijab, t_ijab))
        P_CC = P_CC.at[o, v].add(t_ia + jnp.einsum("ijab,jb->ia", t_ijab, t_ia))

    P_CC = P_CC.at[v, o].set(P_CC[o, v].T)
    P_CC = P_CC.at[v, v].add(jnp.einsum("ia,ib->ab", t_ia, t_ia))
    P_CC = P_CC.at[o, o].add(-jnp.einsum("ia,ja->ij", t_ia, t_ia))

    P_ref = jnp.zeros((n_orbitals, n_orbitals)).at[:n_occ, :n_occ].set(jnp.eye(n_occ))
    return P_ref + P_CC


@jax.jit
def _density_mo_to_ao_rhf(P, C):
    P = 2 * P
    return C @ P @ C.T


def linearised_density(t_ia, t_ijab, n_orbitals, n_occ, o, v, calculation,
                       molecular_orbitals, silent):
    """One jitted call for the MO-basis density plus one for the AO back-
    transform."""
    log("\n  Constructing linearised density...    ", calculation, 1, end="", silent=silent)
    P = _linearised_density_mo(t_ia, t_ijab, int(n_orbitals), int(n_occ),
                               int(o.start or 0), int(o.stop),
                               calculation.reference == "RHF")

    if calculation.reference == "UHF":
        P, P_alpha, P_beta = transforms.density_so_to_ao(
            P, jnp.asarray(molecular_orbitals), n_orbitals)
    else:
        P = _density_mo_to_ao_rhf(P, jnp.asarray(molecular_orbitals))
        P_alpha = P_beta = P / 2
    log("     [Done]", calculation, 1, silent=silent)
    return P, P_alpha, P_beta


def T1_diagnostic(molecule, t_ia, spin_labels_sorted, n_occ, n_alpha, n_beta,
                  calculation, silent):
    t_ia = np.asarray(t_ia)
    if calculation.reference == "UHF":
        alpha_idx = [i for i, s in enumerate(spin_labels_sorted) if s == "a" and i < n_occ]
        beta_idx = [i for i, s in enumerate(spin_labels_sorted) if s == "b" and i < n_occ]
        alpha_idx = np.array(alpha_idx[molecule.n_core_alpha_electrons:]) - molecule.n_core_spin_orbitals
        beta_idx = np.array(beta_idx[molecule.n_core_beta_electrons:]) - molecule.n_core_spin_orbitals
        t_alpha = np.array([t_ia[i] for i in alpha_idx]) if len(alpha_idx) else np.zeros((0,))
        t_beta = np.array([t_ia[i] for i in beta_idx]) if len(beta_idx) else np.zeros((0,))
        n_alpha -= molecule.n_core_alpha_electrons
        n_beta -= molecule.n_core_beta_electrons
        n_occ -= molecule.n_core_alpha_electrons + molecule.n_core_beta_electrons
        t_norm = (n_alpha / n_occ * np.linalg.norm(t_alpha)
                  + n_beta / n_occ * np.linalg.norm(t_beta))
    else:
        n_occ -= molecule.n_core_orbitals
        n_occ *= 2
        t_norm = np.linalg.norm(t_ia)

    T1 = t_norm / np.sqrt(n_occ)
    log(f"\n  Norm of singles amplitudes:         {t_norm:13.10f}", calculation, 1, silent=silent)
    log(f"  Value of T1 diagnostic:             {T1:13.10f}", calculation, 1, silent=silent)
    return T1


def print_largest_amplitudes(t_ia, t_ijab, n_occ, calculation, spin_orbital_labels,
                             silent):
    log("\n  Searching for largest amplitudes...        ", calculation, 2, end="", silent=silent)
    t_ia, t_ijab = np.asarray(t_ia), np.asarray(t_ijab)
    t_ijab_flat = np.abs(t_ijab).ravel()
    t_ia_flat = np.abs(t_ia).ravel()
    idx_ijab = np.vstack(np.unravel_index(np.arange(t_ijab_flat.size), t_ijab.shape)).T
    idx_ia = np.vstack(np.unravel_index(np.arange(t_ia_flat.size), t_ia.shape)).T
    idx_ijab[:, 2:] += n_occ
    idx_ia[:, 1] += n_occ
    singles = np.full((idx_ia.shape[0], 4), -1, dtype=int)
    singles[:, 0] = idx_ia[:, 0]
    singles[:, 2] = idx_ia[:, 1]
    amplitudes = np.concatenate([t_ijab_flat, t_ia_flat])
    indices = np.vstack([idx_ijab, singles])
    order = np.argsort(-amplitudes)
    values = amplitudes[order]
    indices = indices[order]

    if calculation.reference == "UHF":
        labels = list(spin_orbital_labels) + ["ERR"] * n_occ
        labels = np.array(labels)
        mapped = labels[indices]
        mask = np.array([row[1][-1] == row[3][-1] and row[0][-1] == row[2][-1] for row in mapped])
        mapped, values = mapped[mask], values[mask]

        def fix_row(row):
            if row[1].endswith("a") or row[0].endswith("b"):
                row[0], row[1] = row[1], row[0]
                row[2], row[3] = row[3], row[2]
            return row

        mapped = np.array([fix_row(r) for r in mapped])
        _, unique_idx = np.unique(mapped, axis=0, return_index=True)
        mapped = mapped[np.sort(unique_idx)]
        values = values[np.sort(unique_idx)]
        indices = mapped
    else:
        indices = indices + 1

    log("[Done]", calculation, 2, silent=silent)
    log("\n  Largest amplitudes:\n", calculation, 2, silent=silent)

    n_print = min(calculation.print_n_amplitudes, len(indices))
    for i in range(n_print):
        a1, b1, a2, b2 = [f"{indices[i][j]:<3}" for j in (0, 1, 2, 3)]
        value = values[i]
        stars = "~~~~~~~~  "
        space, antispace = (" ", "") if calculation.reference == "RHF" else ("", " ")
        left = f"{a1}-> {space}{a2}{antispace}" if a1 != a2 else stars
        right = f"{b1}-> {space}{b2}{antispace}" if b1 != b2 else stars
        if value > 1e-6:
            log(f"    {left}   {right}  :    {value:6f}", calculation, 2, silent=silent)


# ---------------------------------------------------------------------------
# Top-level driver
# ---------------------------------------------------------------------------

def begin_coupled_cluster_calculation(method, molecule, SCF_output, integrals, X,
                                      calculation, silent):
    timer("Coupled cluster", 0)
    E_CC = E_perturbative = 0.0
    occupancies = natural_orbitals = None

    calculate_triples = method.name in ("CCSDT", "CCSD[T]", "CCSD(T)", "QCISD[T]",
                                        "QCISD(T)", "CCSDT[Q]", "CCSDT(Q)",
                                        "CCSDTQ", "CC3", "CISDT")
    calculate_quadruples = method.name in ("CCSDT[Q]", "CCSDT(Q)", "CCSDTQ")

    if calculation.reference == "RHF":
        n_occ = molecule.n_doubly_occ
        g, molecular_orbitals, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
            molecule, integrals.ERI_AO, SCF_output, calculation, silent=silent)
        # All CC uses non-interleaved physicists' notation: (pr|qs) -> <pq|rs>
        g = g.swapaxes(1, 2)
        F = jnp.diag(jnp.asarray(epsilons))
        spin_labels_sorted, spin_orbital_labels_sorted = None, None
    else:
        n_occ = molecule.n_occ
        (g, molecular_orbitals, epsilons, _, o, v, spin_labels_sorted,
         spin_orbital_labels_sorted, _) = transforms.begin_spin_orbital_calculation(
            molecule, integrals.ERI_AO, SCF_output, calculation, silent=silent)
        H_core_sb = transforms.spin_block_matrix(jnp.asarray(integrals.H_core))
        H_core_SO = transforms.transform_matrix_ao_to_so(H_core_sb, molecular_orbitals)
        F = transforms.spin_orbital_fock(H_core_SO, g, slice(0, n_occ))

    log("\n Preparing arrays for coupled cluster...     ", calculation, 1, end="", silent=silent)
    epsilons = jnp.asarray(epsilons)
    e_ia = transforms.singles_epsilons(epsilons, o, v)
    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    e_ijkabc = (transforms.triples_epsilons(epsilons, o, v)
                if calculate_triples else None)
    e_ijklabcd = (transforms.quadruples_epsilons(epsilons, o, v)
                  if calculate_quadruples else None)

    t_ia = e_ia * F[o, v]
    t_ijab = g[o, o, v, v] * e_ijab
    if getattr(calculation, "read_checkpoint", False):
        from .. import checkpoint
        stage = checkpoint.load_stage(calculation, "cc")
        if (stage is not None and stage.get("t2") is not None
                and tuple(stage["t2"].shape) == tuple(t_ijab.shape)):
            t_ia = jnp.asarray(stage["t1"])
            t_ijab = jnp.asarray(stage["t2"])
            log("\n Restarting amplitudes from checkpoint.", calculation, 1,
                silent=silent)
    t_ijkabc = jnp.zeros_like(e_ijkabc) if e_ijkabc is not None else None
    t_ijklabcd = jnp.zeros_like(e_ijklabcd) if e_ijklabcd is not None else None

    t_amplitudes = (t_ia, t_ijab, t_ijkabc, t_ijklabcd)
    e_denominators = (e_ia, e_ijab, e_ijkabc, e_ijklabcd)
    log("[Done]", calculation, 1, silent=silent)

    E_CC, t_amplitudes = calculate_coupled_cluster_energy(
        g, o, v, t_amplitudes, e_denominators, F, method, calculation, silent,
        SCF_output, integrals)

    t_ia, t_ijab, t_ijkabc, t_ijklabcd = t_amplitudes
    t_ia = jnp.zeros_like(e_ia) if t_ia is None else t_ia

    if getattr(calculation, "checkpoint", False):
        from .. import checkpoint
        checkpoint.save_stage(calculation, "cc",
                              {"t1": t_ia, "t2": t_ijab, "E_CC": E_CC})

    T1_diagnostic(molecule, t_ia, spin_labels_sorted, n_occ, molecule.n_alpha,
                  molecule.n_beta, calculation, silent)
    print_largest_amplitudes(t_ia, t_ijab, n_occ, calculation,
                             spin_orbital_labels_sorted, silent)

    density_matrices = linearised_density(t_ia, t_ijab, molecule.n_orbitals, n_occ,
                                          o, v, calculation, molecular_orbitals,
                                          silent=silent)
    if calculation.natural_orbitals:
        from .mp import print_natural_orbitals
        occupancies, natural_orbitals = print_natural_orbitals(
            density_matrices[0], X, SCF_output.S, calculation, silent)

    timer("Coupled cluster", 1)
    timer("Perturbative correction", 0)
    if "[T]" in method.name or "(T)" in method.name:
        if calculation.reference == "UHF":
            E_perturbative = unrestricted_CCSD_T(g, e_ijkabc, t_ia, t_ijab, o, v,
                                                 method, calculation, silent)
        else:
            E_perturbative = restricted_CCSD_T(g, e_ijkabc, t_ia, t_ijab, o, v,
                                               method, calculation, silent)
    elif "[Q]" in method.name or "(Q)" in method.name:
        E_perturbative = restricted_CCSDT_Q(g, e_ijklabcd, t_ijab, t_ijkabc, o, v,
                                            calculation, silent)
    timer("Perturbative correction", 1)

    log_spacer(calculation, silent=silent)
    return E_CC, E_perturbative, density_matrices, occupancies, natural_orbitals
