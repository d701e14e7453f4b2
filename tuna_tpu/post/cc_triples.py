"""Iterative triples and quadruples methods: CCSDT, CISDT, CCSDTQ.

Restricted CCSDT follows the T1-dressed spin-adapted formulation
(10.26434/chemrxiv-2024-xbnmh via -cvs8h), with the null-space projection of
the pair-symmetric triples onto the singlet-CSF subspace that makes the
redundant spin-free representation converge (reference: tuna_cc.py:2003-2036).
CCSDTQ adds the quadruples coupling on top of the CCSDT residuals
(tuna_cc.py:2500-2687); CISDT is the unrestricted spin-orbital expansion
(tuna_cc.py:1389-1500).  As in post.cc, the whole iteration (update, energy,
convergence, amplitude-DIIS ring buffer, damping) compiles to one on-device
jax.lax.while_loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..output import error, log, log_spacer
from . import transforms
from .cc import (_diis_coefficients, _push_ring, _restricted_blocks,
                 _restricted_energy, _sym_pair, _t1_dressed_orbitals,
                 _u_of, _unrestricted_blocks, _unrestricted_energy,
                 _initial_print, permute, permute_symmetric)


def _p3(array):
    """Simultaneous three-column permutation symmetriser (tuna_mp.py:57-88)."""
    return (array + array.transpose(0, 2, 1, 3, 5, 4) + array.transpose(1, 0, 2, 4, 3, 5)
            + array.transpose(1, 2, 0, 4, 5, 3) + array.transpose(2, 0, 1, 5, 3, 4)
            + array.transpose(2, 1, 0, 5, 4, 3))


def _p4(array):
    array = (array + array.swapaxes(0, 3).swapaxes(4, 7)
             + array.swapaxes(1, 3).swapaxes(5, 7) + array.swapaxes(2, 3).swapaxes(6, 7))
    array = array + array.swapaxes(0, 2).swapaxes(4, 6) + array.swapaxes(1, 2).swapaxes(5, 6)
    return array + array.swapaxes(0, 1).swapaxes(4, 5)


def project_triples(t3):
    """Project pair-symmetric triples onto the physical singlet-CSF subspace."""
    projected = (5.0 / 6.0) * t3
    projected = projected + (-1.0 / 6.0) * (
        t3.transpose(0, 2, 1, 3, 4, 5) + t3.transpose(1, 0, 2, 3, 4, 5)
        + t3.transpose(2, 1, 0, 3, 4, 5) + t3.transpose(1, 2, 0, 3, 4, 5)
        + t3.transpose(2, 0, 1, 3, 4, 5))
    return projected


def project_quadruples(t4):
    out = (7.0 / 12.0) * t4
    out = out + (-1.0 / 6.0) * (
        t4.transpose(0, 1, 3, 2, 4, 5, 6, 7) + t4.transpose(0, 2, 1, 3, 4, 5, 6, 7)
        + t4.transpose(0, 3, 2, 1, 4, 5, 6, 7) + t4.transpose(1, 0, 2, 3, 4, 5, 6, 7)
        + t4.transpose(2, 1, 0, 3, 4, 5, 6, 7) + t4.transpose(3, 1, 2, 0, 4, 5, 6, 7))
    out = out + (-1.0 / 24.0) * (
        t4.transpose(0, 2, 3, 1, 4, 5, 6, 7) + t4.transpose(0, 3, 1, 2, 4, 5, 6, 7)
        + t4.transpose(1, 2, 0, 3, 4, 5, 6, 7) + t4.transpose(1, 3, 2, 0, 4, 5, 6, 7)
        + t4.transpose(2, 0, 1, 3, 4, 5, 6, 7) + t4.transpose(2, 1, 3, 0, 4, 5, 6, 7)
        + t4.transpose(3, 0, 2, 1, 4, 5, 6, 7) + t4.transpose(3, 1, 0, 2, 4, 5, 6, 7))
    out = out + (1.0 / 12.0) * (
        t4.transpose(1, 0, 3, 2, 4, 5, 6, 7) + t4.transpose(2, 3, 0, 1, 4, 5, 6, 7)
        + t4.transpose(3, 2, 1, 0, 4, 5, 6, 7) + t4.transpose(1, 2, 3, 0, 4, 5, 6, 7)
        + t4.transpose(1, 3, 0, 2, 4, 5, 6, 7) + t4.transpose(2, 0, 3, 1, 4, 5, 6, 7)
        + t4.transpose(2, 3, 1, 0, 4, 5, 6, 7) + t4.transpose(3, 0, 1, 2, 4, 5, 6, 7)
        + t4.transpose(3, 2, 0, 1, 4, 5, 6, 7))
    return out


# ---------------------------------------------------------------------------
# Restricted CCSDT (T1-dressed)
# ---------------------------------------------------------------------------

def _restricted_ccsdt_residuals(o, v, t1, t2, t3, ERI_AO, H_core, C,
                                G_MO=None, H_MO=None):
    """T1-dressed CCSDT residuals (r1, r2, r3) plus (g_hat, F_hat, u2).

    When the loop-invariant full-space chemists' MO tensor G_MO (and MO-basis
    H_MO) are given, the per-iteration T1 dressing is four low-rank index
    updates of G_MO -- O(o v n^4) -- instead of rebuilding from the AO
    tensor, the O(n^5) transform the reference pays every iteration
    (tuna_cc.py:2003-2036 vicinity).  Only valid with an unfrozen occupied
    block (t1 spans the full occupied space)."""
    E = jnp.einsum  # local alias keeps the long contraction list readable

    if G_MO is not None:
        from .cc import _t1_dressed_mo_tensor, _t1_dressed_mo_oneelectron
        g_hat = _t1_dressed_mo_tensor(G_MO, t1, o, v)
        h_hat = _t1_dressed_mo_oneelectron(H_MO, t1, o, v)
    else:
        X, Y = _t1_dressed_orbitals(C, t1, o, v)
        g_hat = E("ap,bq,gr,ds,abgd->pqrs", X, Y, X, Y, ERI_AO, optimize=True)
        h_hat = X.T @ H_core @ Y
    l_hat = 2 * g_hat - g_hat.swapaxes(1, 3)
    u2 = _u_of(t2)
    u3 = 2 * t3 - t3.swapaxes(3, 4) - t3.swapaxes(3, 5)
    occ_all = slice(0, o.stop)
    F_hat = h_hat + E("kkpq->pq", l_hat[occ_all, occ_all, :, :], optimize=True)

    A1 = E("kicd,kcad->ia", u2, g_hat[o, v, v, v], optimize=True)
    B1 = -E("klac,kilc->ia", u2, g_hat[o, o, o, v], optimize=True)
    C1 = E("kc,ikac->ia", F_hat[o, v], u2, optimize=True)

    beta = (g_hat[o, o, o, o].transpose(1, 3, 0, 2)
            + E("ijcd,kcld->ijkl", t2, g_hat[o, v, o, v], optimize=True))
    gamma = g_hat[o, o, v, v] - 0.5 * E("liad,kdlc->kiac", t2, g_hat[o, v, o, v], optimize=True)
    delta = 2 * g_hat[v, o, o, v] - g_hat[o, o, v, v].transpose(2, 1, 0, 3)
    delta = delta + 0.5 * E("ilad,ldkc->aikc", u2,
                            2 * g_hat[o, v, o, v] - g_hat[o, v, o, v].swapaxes(1, 3),
                            optimize=True)
    Fvv_tt = F_hat[v, v] - E("klbd,ldkc->bc", u2, g_hat[o, v, o, v], optimize=True)
    Foo_tt = F_hat[o, o] + E("ljcd,kdlc->kj", u2, g_hat[o, v, o, v], optimize=True)

    A2 = E("ijcd,acbd->ijab", t2, g_hat[v, v, v, v], optimize=True)
    B2 = E("klab,ijkl->ijab", t2, beta, optimize=True)
    C2 = -E("kjbc,kiac->ijab", t2, gamma, optimize=True)
    D2 = 0.5 * E("jkbc,aikc->ijab", u2, delta, optimize=True)
    E2 = E("ijac,bc->ijab", t2, Fvv_tt, optimize=True)
    G2 = -E("ikab,kj->ijab", t2, Foo_tt, optimize=True)

    # triples intermediates
    Xoo = F_hat[o, o] + E("meld,imde->li", g_hat[o, v, o, v], u2, optimize=True)
    Xvv = F_hat[v, v] - E("meld,lmae->ad", g_hat[o, v, o, v], u2, optimize=True)
    Xoooo = g_hat[o, o, o, o] + E("ldme,jkde->ljmk", g_hat[o, v, o, v], t2, optimize=True)
    Xvvvv = g_hat[v, v, v, v] + E("ldme,lmbc->bdce", g_hat[o, v, o, v], t2, optimize=True)
    Xvvoo = g_hat[v, v, o, o] - E("lemd,miae->adli", g_hat[o, v, o, v], t2, optimize=True)
    Xvoov = g_hat[v, o, o, v] - E("lemd,imae->aild", g_hat[o, v, o, v], t2, optimize=True)
    Xvoov = Xvoov + E("ldme,imae->aild", g_hat[o, v, o, v], u2, optimize=True)

    Yvooo = g_hat[v, o, o, o] + E("ljmd,mkdc->cklj", g_hat[o, o, o, v], u2, optimize=True)
    Yvooo = Yvooo - E("ldmj,mkdc->cklj", g_hat[o, v, o, o], t2, optimize=True)
    Yvooo = Yvooo + E("cdle,kjde->cklj", g_hat[v, v, o, v], t2, optimize=True)
    Yvooo = Yvooo - E("ldmk,mjcd->cklj", g_hat[o, v, o, o], t2, optimize=True)
    Yvooo = Yvooo + E("ldme,mkjecd->cklj", g_hat[o, v, o, v], u3, optimize=True)

    Yvovv = g_hat[v, o, v, v] - E("ld,lkbc->ckbd", F_hat[o, v], t2, optimize=True)
    Yvovv = Yvovv + E("lkmd,lmcb->ckbd", g_hat[o, o, o, v], t2, optimize=True)
    Yvovv = Yvovv - E("beld,lkec->ckbd", g_hat[v, v, o, v], t2, optimize=True)
    Yvovv = Yvovv + E("bdle,lkec->ckbd", g_hat[v, v, o, v], u2, optimize=True)
    Yvovv = Yvovv - E("celd,lkbe->ckbd", g_hat[v, v, o, v], t2, optimize=True)
    Yvovv = Yvovv - E("ldme,mklecb->ckbd", g_hat[o, v, o, v], u3, optimize=True)

    trip2 = E("kc,ijkabc->ijab", F_hat[o, v], t3 - t3.swapaxes(4, 5), optimize=True)
    trip2 = trip2 + E("ackd,ijkcbd->ijab", g_hat[v, v, o, v],
                      2 * t3 - t3.swapaxes(4, 5) - t3.swapaxes(3, 5), optimize=True)
    trip2 = trip2 - E("kilc,ljkcba->ijab", g_hat[o, o, o, v], u3, optimize=True)

    trip3 = E("ad,ijkdbc->ijkabc", Xvv, t3, optimize=True)
    trip3 = trip3 - E("li,ljkabc->ijkabc", Xoo, t3, optimize=True)
    trip3 = trip3 + E("ljmk,ilmabc->ijkabc", Xoooo, t3, optimize=True)
    trip3 = trip3 - E("adli,ljkdbc->ijkabc", Xvvoo, t3, optimize=True)
    trip3 = trip3 + E("bdce,ijkade->ijkabc", Xvvvv, t3, optimize=True)
    trip3 = trip3 - E("bdli,ljkadc->ijkabc", Xvvoo, t3, optimize=True)
    trip3 = trip3 - E("cdli,ljkabd->ijkabc", Xvvoo, t3, optimize=True)
    trip3 = trip3 + E("aild,ljkdbc->ijkabc", Xvoov, u3, optimize=True)

    r1 = F_hat[v, o].T + A1 + B1 + C1
    r1 = r1 + E("jbkc,ijkabc->ia", l_hat[o, v, o, v], t3 - t3.swapaxes(3, 4),
                optimize=True)
    r2 = g_hat[v, o, v, o].transpose(1, 3, 0, 2) + A2 + B2
    r2 = r2 + permute_symmetric(0.5 * C2 + C2.swapaxes(0, 1) + D2 + E2 + G2,
                                (0, 1), (2, 3))
    r2 = r2 + permute_symmetric(trip2, (0, 1), (2, 3))

    def permute_short(array):
        return (array + array.transpose(1, 0, 2, 4, 3, 5)
                + array.transpose(2, 1, 0, 5, 4, 3))

    r3 = _p3(E("ijad,ckbd->ijkabc", t2, Yvovv, optimize=True)
             - E("ilab,cklj->ijkabc", t2, Yvooo, optimize=True))
    r3 = r3 + permute_short(trip3)
    return r1, r2, r3, g_hat, F_hat, u2


def _restricted_ccsdt_update(o, v, d1, d2, d3, t1, t2, t3, ERI_AO, H_core, C,
                             G_MO=None, H_MO=None):
    r1, r2, r3, _, _, _ = _restricted_ccsdt_residuals(o, v, t1, t2, t3,
                                                      ERI_AO, H_core, C,
                                                      G_MO, H_MO)
    t1n = t1 + d1 * r1
    t2n = t2 + d2 * r2
    t3n = project_triples(t3 + d3 * r3)
    return t1n, t2n, t3n


# ---------------------------------------------------------------------------
# Restricted CCSDTQ
# ---------------------------------------------------------------------------

def _restricted_ccsdtq_update(o, v, d1, d2, d3, d4, t1, t2, t3, t4,
                              ERI_AO, H_core, C, G_MO=None, H_MO=None):
    E = jnp.einsum
    r1, r2, r3, g_hat, F_hat, u2 = _restricted_ccsdt_residuals(
        o, v, t1, t2, t3, ERI_AO, H_core, C, G_MO, H_MO)

    alpha = (2 * t4 - t4.swapaxes(4, 5) - t4.swapaxes(4, 6)
             - t4.transpose(0, 1, 2, 3, 7, 5, 6, 4))
    beta4 = 2 * alpha - alpha.swapaxes(5, 6) - alpha.swapaxes(5, 7)
    z3 = 2 * t3 - t3.swapaxes(3, 4) - t3.swapaxes(3, 5)

    A_q = g_hat[v, v, v, o] + E("menj,mnab->aebj", g_hat[o, v, o, o], t2, optimize=True)
    A_q = A_q + 0.5 * (E("mfae,mjfb->aebj", 2 * g_hat[o, v, v, v], u2, optimize=True)
                       - E("afme,mjfb->aebj", g_hat[v, v, o, v], u2, optimize=True))
    mid = E("meaf,jmfb->aebj", g_hat[o, v, v, v], t2, optimize=True)
    A_q = A_q - 0.5 * mid - mid.swapaxes(0, 2)
    A_q = A_q - E("menf,nmjfab->aebj", g_hat[o, v, o, v], z3, optimize=True)
    A_q = A_q - E("me,mjab->aebj", F_hat[o, v], t2, optimize=True)

    B_q = g_hat[v, o, o, o] + E("aemf,ijef->aimj", g_hat[v, v, o, v], t2, optimize=True)
    B_q = B_q + 0.5 * (E("nemj,niea->aimj", 2 * g_hat[o, v, o, o], u2, optimize=True)
                       - E("njme,niea->aimj", g_hat[o, o, o, v], u2, optimize=True))
    mid = E("njme,inea->aimj", g_hat[o, o, o, v], t2, optimize=True)
    B_q = B_q - 0.5 * mid - mid.swapaxes(1, 3)
    B_q = B_q + E("me,ijae->aimj", F_hat[o, v], t2, optimize=True)
    B_q = B_q + E("menf,nijfae->aimj", g_hat[o, v, o, v], z3, optimize=True)

    Fq_vv = (F_hat[v, v] - E("nfme,nmfa->ae", 2 * g_hat[o, v, o, v], t2, optimize=True)
             + E("nemf,nmfa->ae", g_hat[o, v, o, v], t2, optimize=True))
    Fq_oo = (F_hat[o, o] + E("nfme,nife->mi", 2 * g_hat[o, v, o, v], t2, optimize=True)
             - E("nemf,nife->mi", g_hat[o, v, o, v], t2, optimize=True))
    E_q = 2 * g_hat[o, v, v, o] - g_hat[o, o, v, v].swapaxes(1, 3)
    E_q = E_q + (E("nfme,nifa->meai", 2 * g_hat[o, v, o, v], u2, optimize=True)
                 - E("nemf,nifa->meai", g_hat[o, v, o, v], u2, optimize=True))
    F_q = g_hat[o, o, v, v] - E("nemf,infa->miae", g_hat[o, v, o, v], t2, optimize=True)
    G_q = g_hat[o, o, o, o] + E("menf,ijef->minj", g_hat[o, v, o, v], t2, optimize=True)
    H_q = g_hat[v, v, v, v] + E("menf,mnab->aebf", g_hat[o, v, o, v], t2, optimize=True)

    I_q = 2 * E("meaf,jibf->ejimba", g_hat[o, v, v, v], t2, optimize=True)
    I_q = I_q - E("mfae,jibf->ejimba", g_hat[o, v, v, v], t2, optimize=True)
    I_q = I_q - 2 * E("meni,njab->ejimba", g_hat[o, v, o, o], t2, optimize=True)
    I_q = I_q + E("mine,njab->ejimba", g_hat[o, o, o, v], t2, optimize=True)
    I_q = I_q + 0.5 * E("nfme,nijfab->ejimba", g_hat[o, v, o, v], z3, optimize=True)
    I_q = I_q - 0.25 * E("nemf,nijfab->ejimba", g_hat[o, v, o, v], z3, optimize=True)
    I_q = I_q + I_q.swapaxes(1, 2).swapaxes(4, 5)

    J_q = E("mfae,jibf->iejmab", g_hat[o, v, v, v], t2, optimize=True)
    J_q = J_q - E("mine,njab->iejmab", g_hat[o, o, o, v], t2, optimize=True)
    J_q = J_q - 0.5 * E("nemf,injfab->iejmab", g_hat[o, v, o, v], t3, optimize=True)

    K_q = (E("menk,ijae->ikjanm", g_hat[o, v, o, o], t2, optimize=True)
           + 0.5 * E("menf,ijkaef->ikjanm", g_hat[o, v, o, v], t3, optimize=True))
    K_q = K_q + K_q.swapaxes(1, 2).swapaxes(4, 5)

    L_q = E("aemf,ijkebf->jikbam", g_hat[v, v, o, v], t3, optimize=True)
    L_q = L_q + 0.5 * E("meai,jkbe->jikbam", E_q, t2, optimize=True)
    L_q = L_q + 0.5 * E("miae,jkbe->jikbam", F_q, t2, optimize=True)
    L_q = L_q + E("mkae,jibe->jikbam", F_q, t2, optimize=True)
    L_q = L_q - 0.5 * E("mkni,njab->jikbam", G_q, t2, optimize=True)
    L_q = L_q + 0.5 * E("menf,nijkfabe->jikbam", g_hat[o, v, o, v], alpha, optimize=True)
    L_q = L_q + L_q.swapaxes(0, 1).swapaxes(3, 4)

    M_q = (0.5 * E("aebf,jkfc->ekjacb", H_q, t2, optimize=True)
           - 0.5 * E("menf,nmjkfabc->ekjacb", g_hat[o, v, o, v], alpha, optimize=True))
    M_q = M_q + M_q.swapaxes(1, 2).swapaxes(4, 5)

    r2 = r2 + permute_symmetric(
        0.25 * E("menf,mnijefab->ijab", g_hat[o, v, o, v], beta4, optimize=True),
        (0, 1), (2, 3))
    r3 = r3 + _p3((1 / 6) * E("me,mijkeabc->ijkabc", F_hat[o, v], alpha, optimize=True)
                  + 0.5 * E("aemf,mijkfebc->ijkabc", g_hat[v, v, o, v], alpha, optimize=True)
                  - 0.5 * E("menj,minkeabc->ijkabc", g_hat[o, v, o, o], alpha, optimize=True))

    r4 = 0.5 * E("aebj,iklecd->ijklabcd", A_q, t3, optimize=True)
    r4 = r4 - 0.5 * E("aimj,mklbcd->ijklabcd", B_q, t3, optimize=True)
    r4 = r4 + (1 / 6) * E("ae,ijklebcd->ijklabcd", Fq_vv, t4, optimize=True)
    r4 = r4 - (1 / 6) * E("mi,mjklabcd->ijklabcd", Fq_oo, t4, optimize=True)
    r4 = r4 + (1 / 12) * E("meai,mjklebcd->ijklabcd", E_q, alpha, optimize=True)
    mid = E("miae,jmklebcd->ijklabcd", F_q, t4, optimize=True)
    r4 = r4 - 0.25 * mid - 0.5 * mid.swapaxes(4, 5)
    r4 = r4 + 0.25 * E("minj,mnklabcd->ijklabcd", G_q, t4, optimize=True)
    r4 = r4 + 0.25 * E("aebf,ijklefcd->ijklabcd", H_q, t4, optimize=True)
    r4 = r4 + 0.125 * E("eijmab,mklecd->ijklabcd", I_q, z3, optimize=True)
    mid = E("iejmab,kmlecd->ijklabcd", J_q, t3, optimize=True)
    r4 = r4 - 0.5 * mid - mid.swapaxes(4, 6)
    r4 = r4 + 0.5 * E("ijkamn,mnlbcd->ijklabcd", K_q, t3, optimize=True)
    r4 = r4 - 0.5 * E("ijkabm,mlcd->ijklabcd", L_q, t2, optimize=True)
    r4 = r4 + 0.5 * E("ejkabc,iled->ijklabcd", M_q, t2, optimize=True)
    r4 = _p4(r4)

    t1n = t1 + d1 * r1
    t2n = t2 + d2 * r2
    t3n = project_triples(t3 + d3 * r3)
    t4n = project_quadruples(t4 + d4 * r4)
    return t1n, t2n, t3n, t4n


# ---------------------------------------------------------------------------
# Unrestricted CCSDT (declarative term table)
# ---------------------------------------------------------------------------

def _term_operands(g, F, o, v, t1, t2, t3):
    slices = {"o": o, "v": v}
    operands = {"F_ov": F[o, v], "F_vv": F[v, v], "F_oo": F[o, o],
                "t1": t1, "t2": t2, "t3": t3}

    def lookup(name):
        if name not in operands:
            idx = tuple(slices[c] for c in name[2:])
            operands[name] = g[idx]
        return operands[name]

    return lookup


def _evaluate_terms(terms, lookup):
    total = None
    for factor, perms, subscripts, ops in terms:
        term = factor * jnp.einsum(subscripts, *[lookup(k) for k in ops],
                                   optimize=True)
        for i, j in perms:
            term = term - term.swapaxes(i, j)
        total = term if total is None else total + term
    return total


def _unrestricted_ccsdt_update(g, F, o, v, d1, d2, d3, t1, t2, t3):
    """Spin-orbital CCSDT via the term table in _uccsdt_terms (incremental
    update against the full Fock matrix)."""
    from ._uccsdt_terms import TERMS_T1, TERMS_T2, TERMS_T3
    lookup = _term_operands(g, F, o, v, t1, t2, t3)
    r1 = _evaluate_terms(TERMS_T1, lookup)
    r2 = _evaluate_terms(TERMS_T2, lookup)
    r3 = _evaluate_terms(TERMS_T3, lookup)
    return t1 + d1 * r1, t2 + d2 * r2, t3 + d3 * r3


# ---------------------------------------------------------------------------
# Unrestricted CISDT
# ---------------------------------------------------------------------------

def _unrestricted_cisdt_update(B, F, o, v, d1, d2, d3, t1, t2, t3):
    """Spin-orbital CISDT (tuna_cc.py:1389-1500)."""
    E = jnp.einsum
    off = jnp.diag(jnp.diagonal(F))
    r1 = (F[o, v]
          + E("ab,ib->ia", F[v, v] - off[v, v], t1, optimize=True)
          - E("ji,ja->ia", F[o, o] - off[o, o], t1, optimize=True)
          + E("ajib,jb->ia", B["voov"], t1, optimize=True)
          + E("jb,ijab->ia", F[o, v], t2, optimize=True)
          + 0.5 * E("ajbc,ijbc->ia", B["vovv"], t2, optimize=True)
          - 0.5 * E("jkib,jkab->ia", B["ooov"], t2, optimize=True)
          + 0.25 * E("jkbc,ijkabc->ia", B["oovv"], t3, optimize=True))

    r2 = (B["oovv"]
          + permute(E("abic,jc->ijab", B["vvov"], t1, optimize=True), 1, 0)
          - permute(E("akij,kb->ijab", B["vooo"], t1, optimize=True), 3, 2)
          + 0.5 * E("klij,klab->ijab", B["oooo"], t2, optimize=True)
          + 0.5 * E("abcd,ijcd->ijab", B["vvvv"], t2, optimize=True)
          + permute(E("ki,jkab->ijab", F[o, o] - off[o, o], t2, optimize=True), 1, 0)
          - permute(E("ac,ijbc->ijab", F[v, v] - off[v, v], t2, optimize=True), 3, 2)
          + permute(permute(E("akic,jkbc->ijab", B["voov"], t2, optimize=True), 0, 1), 3, 2)
          + E("kc,ijkabc->ijab", F[o, v], t3, optimize=True)
          + permute(0.5 * E("klic,jklabc->ijab", B["ooov"], t3, optimize=True), 1, 0)
          - permute(0.5 * E("akcd,ijkbcd->ijab", B["vovv"], t3, optimize=True), 3, 2))

    r3 = permute(E("ackd,ijbd->ijkabc", B["vvov"], t2, optimize=True), 4, 3)
    r3 = r3 + permute(E("alij,klbc->ijkabc", B["vooo"], t2, optimize=True), 4, 3)
    r3 = r3 - E("abkd,ijcd->ijkabc", B["vvov"], t2, optimize=True)
    r3 = r3 + E("clij,klab->ijkabc", B["vooo"], t2, optimize=True)
    r3 = r3 - permute(E("abid,jkcd->ijkabc", B["vvov"], t2, optimize=True), 1, 0)
    r3 = r3 - permute(E("clik,jlab->ijkabc", B["vooo"], t2, optimize=True), 1, 0)
    r3 = r3 + permute(permute(E("acid,jkbd->ijkabc", B["vvov"], t2, optimize=True), 1, 0), 4, 3)
    r3 = r3 - permute(permute(E("alik,jlbc->ijkabc", B["vooo"], t2, optimize=True), 1, 0), 4, 3)
    r3 = r3 + permute(E("alkd,ijlbcd->ijkabc", B["voov"], t3, optimize=True), 4, 3)
    r3 = r3 + permute(E("clid,jklabd->ijkabc", B["voov"], t3, optimize=True), 1, 0)
    r3 = r3 + permute(E("ad,ijkbcd->ijkabc", F[v, v] - off[v, v], t3, optimize=True), 4, 3)
    r3 = r3 - E("lk,ijlabc->ijkabc", F[o, o] - off[o, o], t3, optimize=True)
    r3 = r3 + 0.5 * E("abde,ijkcde->ijkabc", B["vvvv"], t3, optimize=True)
    r3 = r3 + 0.5 * E("lmij,klmabc->ijkabc", B["oooo"], t3, optimize=True)
    r3 = r3 + E("clkd,ijlabd->ijkabc", B["voov"], t3, optimize=True)
    r3 = r3 + E("cd,ijkabd->ijkabc", F[v, v] - off[v, v], t3, optimize=True)
    r3 = r3 - permute(E("li,jklabc->ijkabc", F[o, o] - off[o, o], t3, optimize=True), 1, 0)
    r3 = r3 - permute(0.5 * E("acde,ijkbde->ijkabc", B["vvvv"], t3, optimize=True), 4, 3)
    r3 = r3 - permute(0.5 * E("lmik,jlmabc->ijkabc", B["oooo"], t3, optimize=True), 1, 0)
    r3 = r3 + permute(permute(E("alid,jklbcd->ijkabc", B["voov"], t3, optimize=True), 1, 0), 4, 3)
    st = E("abij,kc->ijkabc", B["vvoo"], t1, optimize=True)
    st_ijk = st - st.swapaxes(0, 2) - st.swapaxes(1, 2)
    r3 = r3 + st_ijk - st_ijk.swapaxes(3, 5) - st_ijk.swapaxes(4, 5)

    # The reference writes this update incrementally with the FULL Fock
    # matrix (tuna_cc.py:1497-1499); with canonical orbitals the diagonal
    # F contribution equals -t/d, so the equivalent non-incremental form
    # uses off-diagonal F (as above) and no increment.
    E_corr = 0.25 * E("ijab,ijab->", B["oovv"], t2, optimize=True)
    r1 = r1 - E_corr * t1
    r2 = r2 - E_corr * t2
    r3 = r3 - E_corr * t3
    return d1 * r1, d2 * r2, d3 * r3


# ---------------------------------------------------------------------------
# The jitted solver
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TriplesSettings:
    method: str
    restricted: bool
    rank4: bool
    n_occ: int
    max_iter: int
    use_diis: bool
    max_diis: int
    damping: float
    o_start: int


_SOLVER_CACHE: dict = {}


def _make_setup(settings: TriplesSettings):
    """(update, energy_fn) from the solver's array arguments -- shared by
    the pure-f64 while_loop solver, the f32 warm phase and the Newton
    finisher so all three trace the identical iteration math."""
    no = settings.n_occ
    rank4 = settings.rank4

    def setup(g, F, d1, d2, d3, d4, ERI_AO, H_core, C):
        o, v = slice(0, no), slice(no, None)
        o_g = slice(settings.o_start, settings.o_start + no)
        v_g = slice(settings.o_start + no, None)
        UB = None
        if settings.restricted:
            RB = _restricted_blocks(g, o, v)
            energy_fn = lambda t1, t2: _restricted_energy(
                RB, F[o, v], t1, t2, keep_disconnected=settings.method != "CISDT")
        else:
            UB = _unrestricted_blocks(g, o, v)
            UB = dict(UB)
            UB["voov"] = g[v, o, o, v]
            UB["vooo"] = g[v, o, o, o]
            UB["vvov"] = g[v, v, o, v]
            UB["vvoo"] = g[v, v, o, o]
            energy_fn = lambda t1, t2: _unrestricted_energy(
                UB, F[o, v], t1, t2, keep_disconnected=settings.method != "CISDT")

        # T1-dressing hoist: with an unfrozen occupied block the dressed
        # integrals are low-rank updates of the LOOP-INVARIANT chemists' MO
        # tensor (g is physicists' <pq|rs> here) -- O(o v n^4)/iteration
        # instead of the O(n^5) AO-basis rebuild (kept as the frozen-core
        # fallback, where t1 does not span the dressed occupied space).
        G_MO = H_MO = None
        if settings.restricted and settings.o_start == 0:
            G_MO = g.swapaxes(1, 2)
            H_MO = C.T @ H_core @ C

        def update(t1, t2, t3, t4):
            if settings.method == "CISDT":
                t1n, t2n, t3n = _unrestricted_cisdt_update(
                    UB, F, o, v, d1, d2, d3, t1, t2, t3)
                return t1n, t2n, t3n, t4
            if not settings.restricted:
                t1n, t2n, t3n = _unrestricted_ccsdt_update(
                    g, F, o, v, d1, d2, d3, t1, t2, t3)
                return t1n, t2n, t3n, t4
            if not rank4:
                t1n, t2n, t3n = _restricted_ccsdt_update(
                    o_g, v_g, d1, d2, d3, t1, t2, t3, ERI_AO, H_core, C,
                    G_MO, H_MO)
                return t1n, t2n, t3n, t4
            return _restricted_ccsdtq_update(
                o_g, v_g, d1, d2, d3, d4, t1, t2, t3, t4, ERI_AO, H_core, C,
                G_MO, H_MO)

        return update, energy_fn

    return setup


def _make_solver_fn(settings: TriplesSettings):
    no = settings.n_occ
    M = settings.max_diis
    rank4 = settings.rank4
    setup = _make_setup(settings)

    def solver(g, F, d1, d2, d3, d4, t1_0, t2_0, t3_0, t4_0,
               ERI_AO, H_core, C, energy_conv, amp_conv):
        dtype = t2_0.dtype
        update, energy_fn = setup(g, F, d1, d2, d3, d4, ERI_AO, H_core, C)

        def body(carry):
            (step, E_CC, t1, t2, t3, t4, b1, b2, b3, b4, err_buf, n_valid,
             conv, failed, stats) = carry
            t1n, t2n, t3n, t4n = update(t1, t2, t3, t4)
            En = energy_fn(t1n, t2n)[0]
            dE = En - E_CC

            residuals = [(t1n - t1).ravel(), (t2n - t2).ravel(), (t3n - t3).ravel()]
            if rank4:
                residuals.append((t4n - t4).ravel())
            amp_ok = (jnp.linalg.norm(residuals[0]) < amp_conv)
            for res in residuals[1:]:
                amp_ok = amp_ok & (jnp.linalg.norm(res) < amp_conv)
            is_conv = (jnp.abs(dE) < energy_conv) & amp_ok
            is_failed = (~jnp.all(jnp.isfinite(t2n))) | (En > 1000.0)

            b1n, _ = _push_ring(b1, t1n, n_valid, M)
            b2n, _ = _push_ring(b2, t2n, n_valid, M)
            b3n, _ = _push_ring(b3, t3n, n_valid, M)
            b4n = b4
            if rank4:
                b4n, _ = _push_ring(b4, t4n, n_valid, M)
            err_buf2, n_valid2 = _push_ring(err_buf, jnp.concatenate(residuals),
                                            n_valid, M)

            t1x, t2x, t3x, t4x = t1n, t2n, t3n, t4n
            if settings.use_diis:
                ok, coeffs = _diis_coefficients(err_buf2, n_valid2, M)
                use = (step > 2) & ok & ~is_conv
                mix = lambda buf, t: jnp.where(use, jnp.einsum("m,m...->...", coeffs, buf), t)
                t1x, t2x, t3x = mix(b1n, t1n), mix(b2n, t2n), mix(b3n, t3n)
                if rank4:
                    t4x = mix(b4n, t4n)
                n_valid2 = jnp.where((step > 2) & ~ok, 0, n_valid2)

            if settings.damping != 0.0:
                f = settings.damping
                blend = lambda old, new: jnp.where(is_conv, new, f * old + (1 - f) * new)
                t1x, t2x, t3x = blend(t1, t1x), blend(t2, t2x), blend(t3, t3x)
                if rank4:
                    t4x = blend(t4, t4x)

            stats = stats.at[step - 1].set(jnp.stack([En, dE]))
            return (step + 1, En, t1x, t2x, t3x, t4x, b1n, b2n, b3n, b4n,
                    err_buf2, n_valid2, is_conv, is_failed, stats)

        def cond(carry):
            return (carry[0] <= settings.max_iter) & ~carry[-3] & ~carry[-2]

        err_size = t1_0.size + t2_0.size + t3_0.size + (t4_0.size if rank4 else 0)
        carry0 = (jnp.asarray(1), jnp.asarray(0.0, dtype=dtype),
                  t1_0, t2_0, t3_0, t4_0,
                  jnp.zeros((M,) + t1_0.shape, dtype=dtype),
                  jnp.zeros((M,) + t2_0.shape, dtype=dtype),
                  jnp.zeros((M,) + t3_0.shape, dtype=dtype),
                  (jnp.zeros((M,) + t4_0.shape, dtype=dtype) if rank4
                   else jnp.zeros((1, 1), dtype=dtype)),
                  jnp.zeros((M, err_size), dtype=dtype),
                  jnp.asarray(0), jnp.asarray(False), jnp.asarray(False),
                  jnp.zeros((settings.max_iter, 2), dtype=dtype))

        final = jax.lax.while_loop(cond, body, carry0)
        (step, E_CC, t1, t2, t3, t4) = final[:6]
        conv, failed, stats = final[-3], final[-2], final[-1]
        E_total, E_s, E_c, E_d = energy_fn(t1, t2)
        # Guess-amplitude MP2 energy for the CLI banner, traced into the
        # same program so the print costs no separate device dispatch.
        e_guess = energy_fn(jnp.zeros_like(t1_0), t2_0)[0]
        return (step - 1, conv, failed, E_CC, t1, t2, t3, t4, stats,
                jnp.stack([E_s, E_c, E_d]), e_guess)

    return solver


def _make_solver(settings: TriplesSettings):
    return jax.jit(_make_solver_fn(settings))


# ---------------------------------------------------------------------------
# Mixed-precision production path: f32 warm solve + Newton--Krylov finisher
# ---------------------------------------------------------------------------
# Same design as post.cc's production solver (see the rationale there): the
# amplitudes converge at f32 DIIS speed and each quadratic refinement step
# pays for ONE f64 residual (= one update application over the rank-3/4
# tensors) plus an f32 GMRES correction solve.  Not routed by the driver
# (the plain f64 while_loop serves every backend); reached by its tests.

_TRIPLES_NEWTON_MAX = 6
_TRIPLES_GMRES_M = 10


def _make_newton_fn(settings: TriplesSettings):
    from .cc import _gmres_static

    rank4 = settings.rank4
    setup = _make_setup(settings)

    def finisher(g, F, d1, d2, d3, d4, t1_0, t2_0, t3_0, t4_0,
                 ERI_AO, H_core, C, energy_conv, amp_conv):
        f64 = t2_0.dtype
        f32 = jnp.float32
        upd64, efn64 = setup(g, F, d1, d2, d3, d4, ERI_AO, H_core, C)
        c32 = lambda x: jnp.asarray(x, dtype=f32)
        upd32, efn32 = setup(c32(g), c32(F), c32(d1), c32(d2), c32(d3),
                             c32(d4), c32(ERI_AO), c32(H_core), c32(C))

        shapes = [t1_0.shape, t2_0.shape, t3_0.shape]
        if rank4:
            shapes.append(t4_0.shape)
        sizes = [int(np.prod(s)) for s in shapes]
        offsets = np.cumsum([0] + sizes)

        def pack(ts):
            return jnp.concatenate([t.ravel() for t in ts[:len(shapes)]])

        def unpack(u):
            ts = [u[offsets[k]:offsets[k + 1]].reshape(shapes[k])
                  for k in range(len(shapes))]
            if not rank4:
                ts.append(jnp.zeros(t4_0.shape, dtype=u.dtype))
            return tuple(ts)

        def body(carry):
            step, E, ts, conv, failed, hist = carry

            # ONE f64 residual: the update application over all ranks
            tn = upd64(*ts)
            r = pack(tn) - pack(ts)
            En = efn64(ts[0], ts[1])[0]
            r_norm = jnp.linalg.norm(r.astype(f32))
            is_failed = ~jnp.all(jnp.isfinite(r)) | (jnp.abs(En) > 1000.0)

            # f32 GMRES on (I - Phi') s = r with the Jacobian applied by jvp
            ts32 = tuple(jnp.asarray(t, dtype=f32) for t in ts)

            def matvec(u):
                s = unpack(u)
                _, jt = jax.jvp(lambda *a: pack(upd32(*a)), ts32, s)
                return u - jt

            s_u = _gmres_static(matvec, r.astype(f32), m=_TRIPLES_GMRES_M)
            s = unpack(s_u)

            # energy certification on the solved correction (see post.cc)
            _, e_lin32 = jax.jvp(lambda a, b: efn32(a, b)[0],
                                 (ts32[0], ts32[1]), (s[0], s[1]))
            corr_finite = jnp.all(jnp.isfinite(s_u)) & jnp.isfinite(e_lin32)
            is_failed = is_failed | ~corr_finite
            e_lin = jnp.where(corr_finite, e_lin32, 0.0).astype(f64)
            En_corr = En + jnp.where(is_failed, 0.0, e_lin)
            dE = En_corr - E
            e_err = jnp.abs(e_lin)
            is_conv = (r_norm < amp_conv) & ((jnp.abs(dE) < energy_conv)
                                             | (r_norm < 0.1 * energy_conv)
                                             | (e_err < 0.5 * energy_conv))

            ok = ~is_failed & (~is_conv | (e_err < energy_conv))
            tsn = tuple(jnp.where(ok, t + si.astype(f64), t)
                        for t, si in zip(ts, s))
            En_out = En + jnp.where(ok, e_lin, 0.0)

            hist = jnp.roll(hist, -1, axis=0).at[-1].set(
                jnp.stack([En_out, dE]))
            return step + 1, En_out, tsn, is_conv, is_failed, hist

        def cond(carry):
            step, conv, failed = carry[0], carry[3], carry[4]
            return (step <= _TRIPLES_NEWTON_MAX) & ~conv & ~failed

        hist0 = jnp.zeros((_TRIPLES_NEWTON_MAX, 2), dtype=f64)
        ts0 = (t1_0, t2_0, t3_0, t4_0)
        carry0 = (jnp.asarray(1), jnp.asarray(0.0, dtype=f64), ts0,
                  jnp.asarray(False), jnp.asarray(False), hist0)
        step, E, ts, conv, failed, hist = jax.lax.while_loop(cond, body,
                                                             carry0)
        hist = jnp.roll(hist, step - 1, axis=0)
        E_total, E_s, E_c, E_d = efn64(ts[0], ts[1])
        e_guess = efn64(jnp.zeros_like(t1_0), t2_0)[0]
        return (step - 1, conv, failed, E_total, ts[0], ts[1], ts[2], ts[3],
                hist, jnp.stack([E_s, E_c, E_d]), e_guess)

    return finisher


def _make_production_fn(settings: TriplesSettings):
    from dataclasses import replace as _replace
    from .cc import _WARM_MAX_ITER, _WARM_ENERGY_CONV, _WARM_AMP_CONV

    warm_fn = _make_solver_fn(
        _replace(settings, max_iter=min(settings.max_iter, _WARM_MAX_ITER)))
    finish_fn = _make_newton_fn(settings)

    def production(g, F, d1, d2, d3, d4, t1_0, t2_0, t3_0, t4_0,
                   ERI_AO, H_core, C, energy_conv, amp_conv):
        f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
        f64 = t2_0.dtype
        warm = warm_fn(f32(g), f32(F), f32(d1), f32(d2), f32(d3), f32(d4),
                       f32(t1_0), f32(t2_0), f32(t3_0), f32(t4_0),
                       f32(ERI_AO), f32(H_core), f32(C),
                       jnp.float32(_WARM_ENERGY_CONV),
                       jnp.float32(_WARM_AMP_CONV))
        n_warm, warm_failed = warm[0], warm[2]
        warm_amps = warm[4:8]
        warm_ok = ~warm_failed
        for t in warm_amps[:3]:
            warm_ok = warm_ok & jnp.all(jnp.isfinite(t))
        pick = lambda w, t0: jnp.where(warm_ok, w.astype(f64), t0)
        t1w, t2w, t3w = (pick(warm_amps[0], t1_0), pick(warm_amps[1], t2_0),
                         pick(warm_amps[2], t3_0))
        t4w = pick(warm_amps[3], t4_0) if settings.rank4 else t4_0
        n_warm = jnp.where(warm_ok, n_warm, 0)
        out = finish_fn(g, F, d1, d2, d3, d4, t1w, t2w, t3w, t4w,
                        ERI_AO, H_core, C, energy_conv, amp_conv)
        return (n_warm, warm_ok) + out

    return production


def solve_triples_method(g, o, v, t_amplitudes, e_denominators, F, method,
                         base_name, calculation, silent, SCF_output, integrals):
    """Host driver for CISDT / CCSDT / CCSDTQ (reference dispatch:
    tuna_cc.py:3059-3066, 3109-3113)."""
    restricted = calculation.reference == "RHF"
    if base_name == "CISDT" and restricted:
        error("CISDT is only available for unrestricted references in TUNA-TPU "
              "(as in the reference) - use UCISDT!")
    if base_name == "CCSDTQ" and not restricted:
        error("Unrestricted CCSDTQ is not yet available in TUNA-TPU!")

    t1_0, t2_0, t3_0, t4_0 = t_amplitudes
    d1, d2, d3, d4 = e_denominators
    rank4 = base_name == "CCSDTQ"
    if not rank4:
        d4 = jnp.zeros((1, 1))
        t4_0 = jnp.zeros((1, 1))

    settings = TriplesSettings(
        method=base_name, restricted=restricted, rank4=rank4,
        n_occ=o.stop - (o.start or 0),
        max_iter=int(calculation.correlated_max_iter),
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        damping=float(calculation.correlated_damping_parameter),
        o_start=int(o.start or 0))

    if (o.start or 0) != 0:
        g = g[o.start:, o.start:, o.start:, o.start:]
        F = F[o.start:, o.start:]

    ERI_AO = C = H_core = jnp.zeros((1, 1))
    if base_name in ("CCSDT", "CCSDTQ"):
        ERI_AO = jnp.asarray(integrals.ERI_AO)
        C = jnp.asarray(SCF_output.molecular_orbitals)
        H_core = jnp.asarray(integrals.H_core)

    if settings not in _SOLVER_CACHE:
        _SOLVER_CACHE[settings] = _make_solver(settings)
    solver = _SOLVER_CACHE[settings]
    (n_steps, conv, failed, E_CC, t1, t2, t3, t4, stats, parts,
     e_guess) = solver(
        g, F, d1, d2, d3, d4, t1_0, t2_0, t3_0, t4_0, ERI_AO, H_core, C,
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
    if not bool(conv):
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
    return E_CC, (t1, t2, t3, t4 if rank4 else t_amplitudes[3])
