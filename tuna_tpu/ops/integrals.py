"""Molecular integrals on the accelerator: batched McMurchie-Davidson with
the diatomic z-axis specialisation.

Accelerator-native rebuild of the reference Cython/OpenMP engine
(/root/reference/TUNA/tuna_integrals/tuna_integral.pyx).  The reference loops
over AO pairs / pair-quartets with OpenMP; here every primitive pair (and
pair-of-pairs) is a lane of one large vectorised computation, jit-compiled
with static shapes per (basis, element-pair) so recompilation happens once
per chemical system, not per geometry.  Everything is differentiable w.r.t.
atomic coordinates, enabling exact autodiff gradients through integrals.

Key structures (z-axis molecules, as enforced by the driver):
  * Hermite expansion coefficients E_t^{ij} per primitive pair, built by the
    standard two-term recursion with static loop bounds (pyx:1428-1481).
  * Coulomb integrals use the 1-D Hermite table R^n_{00v}: for atoms on the
    z axis, R_{tuv} = (t-1)!!(u-1)!! R^{(t+u)/2}_{00v} with t,u even
    (pyx:1612-1652), reducing the 3-D Hermite recursion to a tiny 2-D table.
  * Bounded tables: instead of the reference's raw (-2a)^n F_n tables,
    which span many decades, we use the exactly scaled recursion
    Rt[v,n] = R[v,n] / s^(n+v), s = 2*alpha, whose base is (-1)^n F_n, and
    restore s^(n+v) through per-pair factors (2p)^(t/2) and per-quartet
    ratio powers (q/(p+q))^(t/2) -- all bounded.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .boys import boys_table

TWO_PI_POW_2_5 = 2.0 * math.pi ** 2.5  # 34.9868366552497...
PI_POW_1_5 = math.pi ** 1.5


def _double_factorial(n: int) -> float:
    result = 1.0
    while n > 1:
        result *= n
        n -= 2
    return result


# =========================================================================
# Hermite expansion coefficient tables (vectorised over a batch of pairs)
# =========================================================================

def build_E_table(l1max: int, l2max: int, AB, a, b, include_exp=True):
    """E_t^{ij} tables for one Cartesian direction, batched.

    Args:
        l1max, l2max: static maximum angular momenta.
        AB: (batch,) separation A - B along this axis.
        a, b: (batch,) primitive exponents.
        include_exp: include the Gaussian product factor exp(-mu AB^2) in the
            base coefficient (the reference convention).

    Returns:
        list-of-lists E[i][j] -> (batch, i+j+1) arrays (entries beyond i+j
        are absent; callers pad as needed).
    """
    p = a + b
    mu = a * b / p
    one_over_2p = 0.5 / p
    shift1 = -(mu / a) * AB   # X_PA
    shift2 = (mu / b) * AB    # X_PB

    base = jnp.exp(-mu * AB * AB) if include_exp else jnp.ones_like(p)

    E = [[None] * (l2max + 1) for _ in range(l1max + 1)]
    E[0][0] = base[:, None]  # (batch, 1)

    def raise_index(prev, shift, nt_prev):
        # prev: (batch, nt_prev); output (batch, nt_prev + 1)
        nt = nt_prev + 1
        cols = []
        for t in range(nt):
            val = 0.0
            if t - 1 >= 0:
                val = one_over_2p * prev[:, t - 1]
            if t < nt_prev:
                val = val + shift * prev[:, t]
            if t + 1 < nt_prev:
                val = val + (t + 1) * prev[:, t + 1]
            cols.append(val)
        return jnp.stack(cols, axis=-1)

    for i in range(1, l1max + 1):
        E[i][0] = raise_index(E[i - 1][0], shift1, i)
    for i in range(l1max + 1):
        for j in range(1, l2max + 1):
            E[i][j] = raise_index(E[i][j - 1], shift2, i + j)
    return E


def stack_E_table(E, l1max, l2max, tmax):
    """Stack ragged E[i][j] into (l1max+1, l2max+1, tmax+1, batch)."""
    rows = []
    for i in range(l1max + 1):
        cols = []
        for j in range(l2max + 1):
            tab = E[i][j]  # (batch, i+j+1)
            pad = tmax + 1 - tab.shape[1]
            if pad > 0:
                tab = jnp.pad(tab, ((0, 0), (0, pad)))
            cols.append(tab[:, :tmax + 1].T)  # (tmax+1, batch)
        rows.append(jnp.stack(cols))
    return jnp.stack(rows)


def gather_E_row(E_stacked, l1_idx, l2_idx):
    """Select E[l1, l2, :, k] per batch element -> (batch, tmax+1)."""
    I, J, T, batch = E_stacked.shape
    flat = E_stacked.reshape(I * J, T, batch)
    lin = l1_idx * J + l2_idx
    return flat[lin, :, jnp.arange(batch)]


def gather_E_scalar(E_stacked, l1_idx, l2_idx, t: int):
    I, J, T, batch = E_stacked.shape
    flat = E_stacked.reshape(I * J * T, batch)
    lin = (l1_idx * J + l2_idx) * T + t
    return flat[lin, jnp.arange(batch)]


# =========================================================================
# Scaled z-axis Coulomb Hermite table
# =========================================================================

def build_scaled_Rz_table(vmax: int, nmax: int, PQz, alpha):
    """Rt[v][n] = R^n_{00v} / (2 alpha)^(n+v), built from (-1)^n F_n.

    Recursion: Rt[v,n] = PQz * Rt[v-1,n+1] + (v-1)/(2 alpha) * Rt[v-2,n+1].
    Returns (batch, vmax+1, nmax+1); entries with n > nmax - v are unused
    garbage (kept for static shape) -- callers only touch valid (v, n).
    """
    F = boys_table(nmax, alpha * PQz * PQz)  # (batch, nmax+1)
    signs = jnp.array([(-1.0) ** n for n in range(nmax + 1)], dtype=F.dtype)
    rows = [F * signs]
    inv_s = 0.5 / alpha
    for v in range(1, vmax + 1):
        prev1 = rows[v - 1]
        shifted1 = jnp.concatenate([prev1[:, 1:], jnp.zeros_like(prev1[:, :1])], axis=1)
        row = PQz[:, None] * shifted1
        if v > 1:
            prev2 = rows[v - 2]
            shifted2 = jnp.concatenate([prev2[:, 1:], jnp.zeros_like(prev2[:, :1])], axis=1)
            row = row + ((v - 1) * inv_s)[:, None] * shifted2
        rows.append(row)
    return jnp.stack(rows, axis=1)


# =========================================================================
# Integral plan: host-side static description + jitted kernels
# =========================================================================

class IntegralPlan:
    """Static (per chemical system + basis) plan for all AO integrals.

    Host-side preprocessing enumerates primitive pairs once; the jitted
    kernels take only the atomic coordinates (and charges / dipole origin),
    so geometry changes never retrace.
    """

    def __init__(self, basis_functions, n_atoms: int, eri_row_chunk: int | None = None):
        self.n_basis = N = len(basis_functions)
        self.n_atoms = n_atoms
        self.lmax = max(bf.l_total for bf in basis_functions)

        # ---- flat primitive-pair arrays over ordered AO pairs (i >= j) ----
        ao_i, ao_j, pair_id = [], [], []
        a_list, b_list, coef_list = [], [], []
        l1_list, l2_list = [], []
        atom1, atom2 = [], []
        pid = 0
        pair_index = np.zeros((N, N), dtype=np.int32)
        for i in range(N):
            bi = basis_functions[i]
            for j in range(i + 1):
                bj = basis_functions[j]
                pair_index[i, j] = pair_index[j, i] = pid
                for k in range(bi.num_exps):
                    for l in range(bj.num_exps):
                        ao_i.append(i)
                        ao_j.append(j)
                        pair_id.append(pid)
                        a_list.append(bi.exps[k])
                        b_list.append(bj.exps[l])
                        coef_list.append(bi.coefs[k] * bi.norms[k] * bj.coefs[l] * bj.norms[l])
                        l1_list.append(bi.lmn)
                        l2_list.append(bj.lmn)
                        atom1.append(bi.atom_index)
                        atom2.append(bj.atom_index)
                pid += 1
        self.n_pairs = pid
        self.pair_index = pair_index

        self.ao_i = jnp.array(ao_i, dtype=jnp.int32)
        self.ao_j = jnp.array(ao_j, dtype=jnp.int32)
        self.pair_id = jnp.array(pair_id, dtype=jnp.int32)
        # AO indices per ordered AO pair id (i >= j)
        pid_i = np.zeros(pid, dtype=np.int32)
        pid_j = np.zeros(pid, dtype=np.int32)
        for i in range(N):
            for j in range(i + 1):
                pid_i[pair_index[i, j]] = i
                pid_j[pair_index[i, j]] = j
        self.pid_i = jnp.array(pid_i)
        self.pid_j = jnp.array(pid_j)
        self.a = jnp.array(a_list)
        self.b = jnp.array(b_list)
        self.coef = jnp.array(coef_list)
        self.l1 = jnp.array(l1_list, dtype=jnp.int32)  # (Npp, 3)
        self.l2 = jnp.array(l2_list, dtype=jnp.int32)
        self.atom1 = jnp.array(atom1, dtype=jnp.int32)
        self.atom2 = jnp.array(atom2, dtype=jnp.int32)
        self.n_prim_pairs = len(a_list)

        # lz sums per primitive pair / per AO pair, needed for ERI parity
        self.lsum = self.l1 + self.l2  # (Npp, 3)

        # ---- parity-blocked symmetric quartet sweep structure ------------
        # For z-aligned systems (the only geometry class TUNA treats; the
        # one-/two-atom systems are always placed on the z axis) every pair
        # has AB_x = AB_y = 0, so its x/y Hermite expansion carries only
        # coefficients of parity (l1+l2) mod 2, and a quartet (12|34)
        # vanishes unless the bra and ket pairs have MATCHING x parities and
        # matching y parities (the reference exploits the same symmetry:
        # tuna_integral.pyx:1324-1331).  Primitive pairs are grouped into 4
        # parity classes and the sweep visits class-diagonal upper-triangular
        # block pairs only, writing each unordered quartet's value to both
        # packed positions.  Measured quartet reduction vs the round-4 dense
        # npp^2 sweep: 5.9x (N2/6-311G), 6.7x (cc-pVTZ), 7.4x (cc-pVQZ),
        # with bitwise-equal opportunities for parity checks (the skipped
        # quartets are exact zeros of the dense math).
        l1n = np.asarray(l1_list, dtype=np.int64)
        l2n = np.asarray(l2_list, dtype=np.int64)
        parity_cls = (2 * ((l1n[:, 0] + l2n[:, 0]) & 1)
                      + ((l1n[:, 1] + l2n[:, 1]) & 1))
        npp = self.n_prim_pairs
        class_idx = [np.where(parity_cls == k)[0] for k in range(4)]
        if eri_row_chunk is None:
            # Keep the per-block quartet workspace around ~256 MB: the
            # largest intermediate is the Rz table of (vmax+1)(nmax+1) f64
            # per quartet, so block edge T satisfies T^2 * bytes <= budget.
            per_quartet_bytes = 8 * ((4 * self.lmax + 1) * (4 * self.lmax + 1)
                                     + 14 * (2 * self.lmax + 1))
            T = int(np.sqrt(256e6 / per_quartet_bytes))
            # >=4 blocks across the largest class bounds the diagonal-block
            # and padding waste at small problem sizes
            max_class = max((len(ix) for ix in class_idx if len(ix)),
                            default=1)
            T = max(8, min(T, (max_class + 3) // 4))
        else:
            T = max(1, int(eri_row_chunk))
        blocks, block_pairs, block_cls = [], [], []
        for k, ix in enumerate(class_idx):
            if len(ix) == 0:
                continue
            nb = (len(ix) + T - 1) // T
            padded = np.full(nb * T, npp, dtype=np.int64)  # npp = sentinel
            padded[:len(ix)] = ix
            base = len(blocks)
            blocks.extend(padded.reshape(nb, T))
            block_cls.extend([k] * nb)
            for bi in range(nb):
                for bj in range(bi, nb):
                    block_pairs.append((base + bi, base + bj))
        self._qt_blocks = np.asarray(blocks, dtype=np.int32)       # (NB, T)
        self._qt_block_cls = np.asarray(block_cls, dtype=np.int32)  # (NB,)
        self._qt_block_pairs = np.asarray(block_pairs, dtype=np.int32)
        self.eri_row_chunk = T  # block edge (kept under the historical name)

        self._one_electron = jax.jit(self._one_electron_impl)
        self._eri = jax.jit(self._eri_impl)
        self._eri_pair = jax.jit(self._eri_pair_impl)
        self._fock_direct = jax.jit(self._fock_direct_impl)

    # ------------------------------------------------------------------
    # One-electron integrals: S, T, V_NE, D (3), Q (3)  [Cartesian basis]
    # ------------------------------------------------------------------

    def one_electron(self, coords, charges, dipole_origin_z):
        return self._one_electron(coords, charges, dipole_origin_z)

    def _one_electron_impl(self, coords, charges, dipole_origin_z):
        lmax = self.lmax
        A = coords[self.atom1]  # (Npp, 3)
        B = coords[self.atom2]
        a, b = self.a, self.b
        p = a + b
        prefactor = self.coef * PI_POW_1_5 / (p * jnp.sqrt(p))

        # E tables per axis, up to l2 + 2 on the second index (kinetic and
        # quadrupole raise the second function's angular momentum by 2).
        tmax = 2 * lmax + 2
        E_axes = []
        for axis in range(3):
            E = build_E_table(lmax, lmax + 2, A[:, axis] - B[:, axis], a, b)
            E_axes.append(stack_E_table(E, lmax, lmax + 2, tmax))

        l1, l2 = self.l1, self.l2
        S_axis, T_axis, D_axis, Q_axis = [], [], [], []
        P_coord = (a[:, None] * A + b[:, None] * B) / p[:, None]
        origin = jnp.stack([jnp.zeros_like(dipole_origin_z),
                            jnp.zeros_like(dipole_origin_z), dipole_origin_z])
        for axis in range(3):
            Etab = E_axes[axis]
            l1x, l2x = l1[:, axis], l2[:, axis]
            S0 = gather_E_scalar(Etab, l1x, l2x, 0)
            E1 = gather_E_scalar(Etab, l1x, l2x, 1)
            E2 = gather_E_scalar(Etab, l1x, l2x, 2)
            S_plus2 = gather_E_scalar(Etab, l1x, l2x + 2, 0)
            S_minus2 = jnp.where(l2x >= 2,
                                 gather_E_scalar(Etab, l1x, jnp.maximum(l2x - 2, 0), 0),
                                 0.0)
            Tx = ((2 * l2x + 1) * b * S0
                  - 2.0 * b * b * S_plus2
                  - 0.5 * (l2x * (l2x - 1)) * S_minus2)
            Px = P_coord[:, axis] - origin[axis]
            Dx = E1 + Px * S0
            Qx = 2.0 * E2 + 2.0 * Px * E1 + (Px * Px + 0.5 / p) * S0
            S_axis.append(S0)
            T_axis.append(Tx)
            D_axis.append(Dx)
            Q_axis.append(Qx)

        Sx, Sy, Sz = S_axis
        s_val = prefactor * Sx * Sy * Sz
        t_val = prefactor * (T_axis[0] * Sy * Sz + Sx * T_axis[1] * Sz + Sx * Sy * T_axis[2])
        d_vals = [prefactor * D_axis[0] * Sy * Sz,
                  prefactor * Sx * D_axis[1] * Sz,
                  prefactor * Sx * Sy * D_axis[2]]
        q_vals = [prefactor * Q_axis[0] * Sy * Sz,
                  prefactor * Sx * Q_axis[1] * Sz,
                  prefactor * Sx * Sy * Q_axis[2]]

        # ---- nuclear attraction (z-axis Hermite table) -------------------
        # Scaled form: each Hermite coefficient picks up (2p)^(t/2) for x/y
        # and (2p)^v for z, matching Rt[v,n] = R[v,n]/(2p)^(n+v).
        Ex = gather_E_row(E_axes[0], l1[:, 0], l2[:, 0])[:, :2 * lmax + 1]
        Ey = gather_E_row(E_axes[1], l1[:, 1], l2[:, 1])[:, :2 * lmax + 1]
        Ez = gather_E_row(E_axes[2], l1[:, 2], l2[:, 2])[:, :2 * lmax + 1]
        two_p = 2.0 * p
        sqrt_2p = jnp.sqrt(two_p)
        half_powers = jnp.cumprod(
            jnp.concatenate([jnp.ones_like(p)[:, None],
                             jnp.repeat(sqrt_2p[:, None], 2 * lmax, axis=1)], axis=1), axis=1)
        full_powers = half_powers * half_powers
        Ex_s = Ex * half_powers
        Ey_s = Ey * half_powers
        Ez_s = Ez * full_powers

        mmax = lmax  # (t+u)/2 <= lmax per pair... t <= l1x+l2x etc.
        # t + u <= (l1x+l2x) + (l1y+l2y) <= 2*lmax, so m <= lmax
        vmax = 2 * lmax
        nmax = 2 * lmax  # total Hermite order per pair

        v_total = jnp.zeros_like(p)
        for atom in range(self.n_atoms):
            PCz = P_coord[:, 2] - coords[atom, 2]
            Rz = build_scaled_Rz_table(vmax, nmax, PCz, p)  # (Npp, vmax+1, nmax+1)
            # axy[m] = sum_{t,u even, t/2+u/2 = m} Ex_s[t](t-1)!! Ey_s[u](u-1)!!
            ax = jnp.stack([Ex_s[:, 2 * m] * _double_factorial(2 * m - 1)
                            for m in range(mmax + 1)], axis=1)
            ay = jnp.stack([Ey_s[:, 2 * m] * _double_factorial(2 * m - 1)
                            for m in range(mmax + 1)], axis=1)
            axy = jnp.zeros((p.shape[0], nmax + 1), dtype=p.dtype)
            for m1 in range(mmax + 1):
                for m2 in range(mmax + 1):
                    axy = axy.at[:, m1 + m2].add(ax[:, m1] * ay[:, m2])
            contrib = jnp.einsum("bv,bn,bvn->b", Ez_s, axy, Rz[:, :2 * lmax + 1, :])
            v_total = v_total - charges[atom] * contrib * 2.0 * jnp.pi / p

        v_val = self.coef * v_total

        # ---- scatter into matrices ---------------------------------------
        def scatter(values):
            M = jnp.zeros((self.n_basis, self.n_basis), dtype=values.dtype)
            M = M.at[self.ao_i, self.ao_j].add(values)
            upper = jnp.triu(M.T, k=1)
            return M + upper

        S = scatter(s_val)
        T = scatter(t_val)
        V = scatter(v_val)
        D = jnp.stack([scatter(v) for v in d_vals])
        Q = jnp.stack([scatter(v) for v in q_vals])
        return S, T, V, D, Q

    # ------------------------------------------------------------------
    # Electron repulsion integrals  [Cartesian basis]
    # ------------------------------------------------------------------

    def eri(self, coords):
        return self._eri(coords)

    def _pair_data(self, coords):
        """Per-primitive-pair scaled Hermite vectors for the ERI kernel."""
        lmax = self.lmax
        tmax = 2 * lmax
        A = coords[self.atom1]
        B = coords[self.atom2]
        a, b = self.a, self.b
        p = a + b
        Pz = (a * A[:, 2] + b * B[:, 2]) / p

        hs = []
        for axis in range(3):
            E = build_E_table(lmax, lmax, A[:, axis] - B[:, axis], a, b)
            Etab = stack_E_table(E, lmax, lmax, tmax)
            hs.append(gather_E_row(Etab, self.l1[:, axis], self.l2[:, axis]))

        sqrt_2p = jnp.sqrt(2.0 * p)
        half_powers = jnp.cumprod(
            jnp.concatenate([jnp.ones_like(p)[:, None],
                             jnp.repeat(sqrt_2p[:, None], tmax, axis=1)], axis=1), axis=1)
        full_powers = half_powers * half_powers
        hx = hs[0] * half_powers
        hy = hs[1] * half_powers
        hz = hs[2] * full_powers
        return hx, hy, hz, p, Pz

    def _sweep_blocks(self, coords):
        """Shared parity-blocked symmetric quartet sweep.

        Returns (block_rows, block_values, dtype) where block_rows(b) gathers
        the per-pair data of block b (padded entries point at a zero-
        coefficient sentinel row) and block_values(rowd, cold) computes the
        (T, T) quartet values (ij|kl) for the row block's primitive pairs
        against the column block's.  Consumers iterate
        self._qt_block_pairs -- bl <= bj within one parity class -- and
        accumulate each unordered quartet ONCE, adding the transposed
        contribution for the strictly-upper part (see _eri_sweep /
        _fock_sweep); cross-class quartets are exact zeros of the z-aligned
        Hermite expansion and are never touched."""
        lmax = self.lmax
        tmax = 2 * lmax          # max Hermite order per pair per axis
        vmax4 = 2 * tmax         # total z Hermite order per quartet
        nmax4 = 4 * lmax         # Boys order cap per quartet

        hx, hy, hz, p, Pz = self._pair_data(coords)

        # Alternating z signs on the "34" side implement (-1)^phi (the x/y
        # signs collapse to the class constant folded into pair_E_cls)
        sign = jnp.array([(-1.0) ** t for t in range(tmax + 1)])

        # One sentinel row (index npp) backs block padding: the zero
        # coefficient kills its contributions, the benign exponent (p = 1)
        # keeps alpha/pref finite.
        def ext(x, fill=0.0):
            pad = jnp.full((1,) + x.shape[1:], fill, dtype=x.dtype)
            return jnp.concatenate([x, pad], axis=0)

        data = {
            "hx": ext(hx), "hy": ext(hy), "hz": ext(hz),
            "p": ext(p, 1.0), "Pz": ext(Pz),
            "coef": ext(self.coef),
            "pid": jnp.concatenate([self.pair_id,
                                    jnp.zeros((1,), dtype=self.pair_id.dtype)]),
        }
        blocks = jnp.asarray(self._qt_blocks)   # (NB, T) incl. sentinel npp
        block_cls = jnp.asarray(self._qt_block_cls)

        # ---- packed-parity x/y axes ------------------------------------
        # Within one parity class every pair's x Hermite row has entries
        # only at t = 2k + px (AB_x = 0), so the x/y coupling runs on the
        # PACKED kp = lmax+1 entries instead of the tmax+1 = 2*lmax+1 dense
        # axis: the coupling einsums drop from (t,u,T) = 7x7x13 to
        # (k,k,m) = 4x4x7 and the pairing einsum from 13x13x13 to 7x7x13 at
        # lmax = 3 -- ~2.6x fewer multiply-adds in the sweep's hottest
        # stage, with exact math (the dropped entries are structural
        # zeros).  The ket-side (-1)^t alternating sign collapses to the
        # class constant (-1)^(px+py), folded into the pairing tensor.
        kp = lmax + 1
        # t-positions of the packed entries per x/y parity; the odd row's
        # overflow (2k+1 > tmax) is clamped to tmax, whose entry is zero
        # for odd-parity pairs (wrong parity), keeping the gather exact.
        pack_even = jnp.asarray([min(2 * k, tmax) for k in range(kp)],
                                dtype=jnp.int32)
        pack_odd = jnp.asarray([min(2 * k + 1, tmax) for k in range(kp)],
                               dtype=jnp.int32)
        # packed coupling: (k1, k2) -> m = k1 + k2
        n2k = 2 * (kp - 1)
        conv_K = np.zeros((kp, kp, n2k + 1))
        for k1 in range(kp):
            for k2 in range(kp):
                conv_K[k1, k2, k1 + k2] = 1.0
        conv_K = jnp.asarray(conv_K)
        # packed pairing with double factorials and the class sign, one
        # constant per parity class: n = (m1 + px) + (m2 + py)
        dfact_x = np.array([_double_factorial(2 * m - 1)
                            for m in range(n2k + 2)])
        pair_E_cls = np.zeros((4, n2k + 1, n2k + 1, nmax4 + 1))
        for cls in range(4):
            px_c, py_c = cls >> 1, cls & 1
            s_cls = (-1.0) ** (px_c + py_c)
            for m1 in range(n2k + 1):
                for m2 in range(n2k + 1):
                    n = m1 + px_c + m2 + py_c
                    if n <= nmax4:
                        pair_E_cls[cls, m1, m2, n] = (s_cls
                                                      * dfact_x[m1 + px_c]
                                                      * dfact_x[m2 + py_c])
        pair_E_cls = jnp.asarray(pair_E_cls)
        # dense z coupling (AB_z != 0: no parity structure on z)
        n2t = 2 * tmax
        conv_T = np.zeros((tmax + 1, tmax + 1, n2t + 1))       # t, u -> t+u
        for t in range(tmax + 1):
            for u in range(tmax + 1):
                conv_T[t, u, t + u] = 1.0
        conv_T = jnp.asarray(conv_T)
        # valid (V, n) mask: only n <= nmax4 - V entries of the Rz table hold
        # meaningful values (the rest are static-shape garbage)
        vn_mask = jnp.asarray(np.array([[1.0 if n <= nmax4 - V else 0.0
                                         for n in range(nmax4 + 1)]
                                        for V in range(vmax4 + 1)]))

        def block_rows(b):
            idx = jax.lax.dynamic_index_in_dim(blocks, b, keepdims=False)
            d = {k: v[idx] for k, v in data.items()}
            d["gidx"] = idx     # global primitive index (sentinel npp last)
            d["cls"] = jax.lax.dynamic_index_in_dim(block_cls, b,
                                                    keepdims=False)
            return d

        def block_values(rowd, cold):
            p12 = rowd["p"][:, None]           # (T, 1)
            q34 = cold["p"][None, :]           # (1, T)
            psum = p12 + q34
            alpha = p12 * q34 / psum
            PQz = rowd["Pz"][:, None] - cold["Pz"][None, :]

            ratio12 = q34 / psum               # (T, T), in (0,1)
            ratio34 = p12 / psum
            sqrt_r12 = jnp.sqrt(ratio12)
            sqrt_r34 = jnp.sqrt(ratio34)

            # ratio half-powers: (T, T, tmax+1)
            def ratio_powers(base):
                outs = [jnp.ones_like(base)]
                for _ in range(tmax):
                    outs.append(outs[-1] * base)
                return jnp.stack(outs, axis=-1)

            r12_half = ratio_powers(sqrt_r12)
            r34_half = ratio_powers(sqrt_r34)
            r12_full = r12_half * r12_half
            r34_full = r34_half * r34_half

            # parity class of this (class-diagonal) block pair
            cls = rowd["cls"]
            px = cls >> 1
            py = cls & 1
            idxx = jnp.where(px == 1, pack_odd, pack_even)
            idxy = jnp.where(py == 1, pack_odd, pack_even)
            # full-ratio powers ratio^k live at the even half-power slots
            r12_k = r12_half[..., : 2 * kp : 2]          # (T, T, kp)
            r34_k = r34_half[..., : 2 * kp : 2]
            # the odd-parity residue sqrt(ratio)^px as one class-selected
            # factor per side/axis pair
            fx12 = jnp.where(px == 1, sqrt_r12, 1.0)[..., None]
            fy12 = jnp.where(py == 1, sqrt_r12, 1.0)[..., None]
            fx34 = jnp.where(px == 1, sqrt_r34, 1.0)[..., None]
            fy34 = jnp.where(py == 1, sqrt_r34, 1.0)[..., None]

            gx12 = rowd["hx"][:, idxx][:, None, :] * r12_k * fx12
            gy12 = rowd["hy"][:, idxy][:, None, :] * r12_k * fy12
            gx34 = cold["hx"][:, idxx][None, :, :] * r34_k * fx34
            gy34 = cold["hy"][:, idxy][None, :, :] * r34_k * fy34
            gz12 = rowd["hz"][:, None, :] * r12_full
            gz34 = (cold["hz"] * sign)[None, :, :] * r34_full

            # packed correlations G[m] = sum_{k1+k2=m} g1[k1] g2[k2]
            Gx = jnp.einsum("rck,rcl,klm->rcm", gx12, gx34, conv_K)
            Gy = jnp.einsum("rck,rcl,klm->rcm", gy12, gy34, conv_K)
            Gz = jnp.einsum("rct,rcu,tuT->rcT", gz12, gz34, conv_T)

            # axy[n] = sum_{m1,m2} Gx[m1] Gy[m2] E_cls[m1,m2,n] with the
            # (T-1)!! weights, class parity offsets and ket sign baked in
            axy = jnp.einsum("rcm,rcu,mun->rcn", Gx, Gy, pair_E_cls[cls])

            Rz = build_scaled_Rz_table(vmax4, nmax4,
                                       PQz.reshape(-1), alpha.reshape(-1))
            Rz = Rz.reshape(PQz.shape + (vmax4 + 1, nmax4 + 1)) * vn_mask

            total = jnp.einsum("rcv,rcvn,rcn->rc", Gz, Rz, axy)

            pref = TWO_PI_POW_2_5 / (p12 * q34 * jnp.sqrt(psum))
            return rowd["coef"][:, None] * cold["coef"][None, :] * pref * total

        return block_rows, block_values, p.dtype

    def _eri_sweep(self, coords):
        """(block-pair body, initial carry) accumulating the packed
        (n_pairs, n_pairs) pair matrix: the forward mask c >= r keeps each
        unordered quartet once (incl. the diagonal), the strict mask c > r
        writes its mirror into the transposed packed position."""
        block_rows, block_values, dtype = self._sweep_blocks(coords)

        def body(carry, pair):
            rowd = block_rows(pair[0])
            cold = block_rows(pair[1])
            v = block_values(rowd, cold)
            upper = cold["gidx"][None, :] >= rowd["gidx"][:, None]
            strict = cold["gidx"][None, :] > rowd["gidx"][:, None]
            vf = jnp.where(upper, v, 0.0)
            vb = jnp.where(strict, v, 0.0)
            fwd = jax.ops.segment_sum(vf.T, cold["pid"],
                                      num_segments=self.n_pairs).T  # (T, n_pairs)
            carry = carry.at[rowd["pid"]].add(fwd)
            bwd = jax.ops.segment_sum(vb, rowd["pid"],
                                      num_segments=self.n_pairs)    # (n_pairs, T)
            carry = carry.at[cold["pid"]].add(bwd.T)
            return carry, None

        carry0 = jnp.zeros((self.n_pairs, self.n_pairs), dtype=dtype)
        return body, carry0

    def _eri_pair_impl(self, coords):
        """Packed (n_pairs, n_pairs) pair matrix of permutation-unique ERI
        values: element (pair_ij, pair_kl) = (ij|kl).  This is the compact
        form the transform-direct MO path consumes (ops/motransform.py) --
        one quarter the dense tensor's memory, and the N^4 expansion is
        skipped entirely."""
        body, carry0 = self._eri_sweep(coords)
        out, _ = jax.lax.scan(body, carry0,
                              jnp.asarray(self._qt_block_pairs))
        return out

    def eri_pair_packed(self, coords):
        return self._eri_pair(coords)

    def _eri_impl(self, coords):
        out = self._eri_pair_impl(coords)
        # Expand packed pair matrix to the full N^4 tensor
        pidx = jnp.array(self.pair_index)
        eri = out[pidx[:, :, None, None], pidx[None, None, :, :]]
        return eri

    # ------------------------------------------------------------------
    # Direct Fock build: J/K contracted during the sweep, O(chunk x N^2)
    # memory, the N^4 tensor is never materialised.
    # ------------------------------------------------------------------

    def fock_direct(self, coords, P):
        """Coulomb and exchange matrices J, K for (symmetric) density P,
        contracted against permutation-unique integral values as they are
        generated.  This is the large-basis path: the reference must store
        the N^4 tensor and pre-flight-checks host RAM (tuna_kernel.py:392-406,
        3 GB at cc-pV5Z / 32 GB at cc-pV6Z); here peak memory is the row
        chunk's (R, n_pairs) workspace.
        """
        return self._fock_direct(coords, P)

    def fock_closure(self, spherical_transformation=None):
        """(coords, P) -> (J, K) closure for the SCF kernel's direct-Fock
        path, in the spherical AO basis when a transformation is given.  The
        scanned sweep is traced inside the jitted SCF while_loop.

        Cached on the plan and tagged with a stable `cache_token`, so every
        geometry of the same chemical system (OPT/FREQ/scan steps) reuses ONE
        compiled SCF kernel -- coordinates enter as a kernel argument, never
        as a trace constant.
        """
        spherical = spherical_transformation is not None
        cached = self.__dict__.get("_fock_closures", {})
        if spherical in cached:
            return cached[spherical]
        fock = self._fock_direct_impl
        if not spherical:
            def closure(coords, P):
                return fock(coords, P)
        else:
            U_sph = jnp.asarray(spherical_transformation)

            def closure(coords, P):
                J_c, K_c = fock(coords, U_sph.T @ P @ U_sph)
                return U_sph @ J_c @ U_sph.T, U_sph @ K_c @ U_sph.T
        closure.cache_token = (id(self), spherical)
        cached[spherical] = closure
        self._fock_closures = cached
        return closure

    def _fock_sweep(self, coords, P):
        """(block-pair body, initial carry) for the direct Fock build: J/K
        accumulated from the quartet value blocks, the N^4 tensor never
        materialised.  Each unordered quartet contributes BOTH orientations
        (bra pair as "ij" and as "kl") via a second accumulate call with the
        transposed strict-upper values; `_fock_direct_impl` folds the body
        over the block pairs with `lax.scan`."""
        block_rows, block_values, dtype = self._sweep_blocks(coords)
        N = self.n_basis
        pi, pj = self.pid_i, self.pid_j           # AO indices per pair id
        # pair degeneracy for J; off-diagonal K mask for the k<->l swap
        Pp_pair = P[pi, pj] * jnp.where(pi == pj, 1.0, 2.0)   # (n_pairs,)
        m_pair = jnp.where(pi == pj, 0.0, 1.0)

        def accumulate(J_pair, K, v, rowd, cold):
            # v: (Tr, Tc) quartet values with rows acting as "ij", cols "kl"
            rpid, cpid = rowd["pid"], cold["pid"]
            irow, jrow = pi[rpid], pj[rpid]       # (Tr,) AO i >= j
            kcol, lcol = pi[cpid], pj[cpid]       # (Tc,) AO k >= l
            m_kl = m_pair[cpid]
            m_ij = jnp.where(irow == jrow, 0.0, 1.0)[:, None]

            # J[i,j] = sum_c (ij|c) P_c  -- one dot per row, binned by pid
            J_pair = J_pair.at[rpid].add(v @ Pp_pair[cpid])

            # K[m,n] += (ms|tn) P[t,s] over the distinct dense positions this
            # packed value occupies: (m,s) in {(i,j),(j,i)}, (t,n) in
            # {(k,l),(l,k)} (degenerate options masked out)
            def seg(values, segments):
                return jax.ops.segment_sum(values.T, segments,
                                           num_segments=N).T  # (Tr, N)

            P_kj = P[kcol[None, :], jrow[:, None]]  # (Tr, Tc)
            P_lj = P[lcol[None, :], jrow[:, None]]
            P_ki = P[kcol[None, :], irow[:, None]]
            P_li = P[lcol[None, :], irow[:, None]]

            rows_i = seg(v * P_kj, lcol) + seg(v * P_lj * m_kl[None, :], kcol)
            rows_j = (seg(v * P_ki, lcol)
                      + seg(v * P_li * m_kl[None, :], kcol)) * m_ij
            K = K.at[irow].add(rows_i)
            K = K.at[jrow].add(rows_j)
            return J_pair, K

        def block_body(carry, pair):
            J_pair, K = carry
            rowd = block_rows(pair[0])
            cold = block_rows(pair[1])
            v = block_values(rowd, cold)
            upper = cold["gidx"][None, :] >= rowd["gidx"][:, None]
            strict = cold["gidx"][None, :] > rowd["gidx"][:, None]
            J_pair, K = accumulate(J_pair, K, jnp.where(upper, v, 0.0),
                                   rowd, cold)
            J_pair, K = accumulate(J_pair, K, jnp.where(strict, v, 0.0).T,
                                   cold, rowd)
            return (J_pair, K), None

        carry0 = (jnp.zeros(self.n_pairs, dtype=dtype),
                  jnp.zeros((N, N), dtype=dtype))
        return block_body, carry0

    def _fock_unpack(self, J_pair, K):
        """Expand the packed J pair vector symmetrically."""
        N = self.n_basis
        J = jnp.zeros((N, N), dtype=J_pair.dtype)
        J = J.at[self.pid_i, self.pid_j].set(J_pair)
        J = J + jnp.triu(J.T, k=1)
        return J, K

    def _fock_direct_impl(self, coords, P):
        block_body, carry0 = self._fock_sweep(coords, P)
        (J_pair, K), _ = jax.lax.scan(block_body, carry0,
                                      jnp.asarray(self._qt_block_pairs))
        return self._fock_unpack(J_pair, K)

    @property
    def n_block_pairs(self):
        return len(self._qt_block_pairs)


def cross_overlap(basis_functions_1, basis_functions_2) -> np.ndarray:
    """Overlap matrix between two basis sets (host-side, used for guesses).

    Mirrors tuna_integral.pyx:626-768.  Runs eagerly ON THE HOST CPU
    device, like the rest of the guess stage: the E-table recursion unrolls
    to several hundred small eager ops, which the host finishes faster than
    a GPU (PERF.md, guess stage).
    """
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        return _cross_overlap_eager(basis_functions_1, basis_functions_2)


def _cross_overlap_eager(basis_functions_1, basis_functions_2) -> np.ndarray:
    lmax1 = max(bf.l_total for bf in basis_functions_1)
    lmax2 = max(bf.l_total for bf in basis_functions_2)

    rows_i, rows_j, a_l, b_l, coef_l, l1_l, l2_l, A_l, B_l = [], [], [], [], [], [], [], [], []
    for i, bi in enumerate(basis_functions_1):
        for j, bj in enumerate(basis_functions_2):
            for k in range(bi.num_exps):
                for l in range(bj.num_exps):
                    rows_i.append(i)
                    rows_j.append(j)
                    a_l.append(bi.exps[k])
                    b_l.append(bj.exps[l])
                    coef_l.append(bi.coefs[k] * bi.norms[k] * bj.coefs[l] * bj.norms[l])
                    l1_l.append(bi.lmn)
                    l2_l.append(bj.lmn)
                    A_l.append(bi.origin)
                    B_l.append(bj.origin)

    a = jnp.array(a_l)
    b = jnp.array(b_l)
    coef = jnp.array(coef_l)
    l1 = jnp.array(l1_l, dtype=jnp.int32)
    l2 = jnp.array(l2_l, dtype=jnp.int32)
    A = jnp.array(A_l)
    B = jnp.array(B_l)

    p = a + b
    prefactor = coef * PI_POW_1_5 / (p * jnp.sqrt(p))
    s = prefactor
    for axis in range(3):
        E = build_E_table(lmax1, lmax2, A[:, axis] - B[:, axis], a, b)
        Etab = stack_E_table(E, lmax1, lmax2, lmax1 + lmax2)
        s = s * gather_E_scalar(Etab, l1[:, axis], l2[:, axis], 0)

    S = jnp.zeros((len(basis_functions_1), len(basis_functions_2)))
    S = S.at[jnp.array(rows_i), jnp.array(rows_j)].add(s)
    return np.array(S)
