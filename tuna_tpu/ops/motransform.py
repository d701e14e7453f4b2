"""Transform-direct AO -> MO two-electron integrals from the PACKED pair
matrix, never materialising the dense N^4 AO tensor.

The integral sweep (ops/integrals.py IntegralPlan) naturally produces the
permutation-unique packed pair matrix G_pair[(ij),(kl)] = (ij|kl) of shape
(n_pairs, n_pairs) = ~(N^2/2)^2 values -- one quarter of the dense tensor.
The reference must expand and store the full Cartesian N^4 tensor before
its sparse-kron MO transform (tuna_kernel.py:392-406, :504-523; ~3 GB at
cc-pV5Z and ~32 GB at cc-pV6Z of host RAM).  Here the two half-transforms
run row-chunk-wise straight off the packed matrix:

  phase 1:  H[(ij), (pq)]   = sum_{kl} W[k,p] W[l,q] (ij|kl)
  phase 2:  G[(rs), (pq)]   = sum_{ij} W[i,r] W[j,s] H[(ij),(pq)]

with W = (cartesian AO -> MO) combined coefficients, and (pq) packed over
p >= q (the transform preserves the pair symmetry).  Peak memory is the
packed matrices plus one (chunk, N, N) dense workspace -- at cc-pV5Z H2
this is ~1.3 GB against the reference's ~3 GB AO tensor alone, and the MO
result is ~4x smaller than the dense MO tensor until a consumer expands
the blocks it needs.

`pair_packed_to_mo_sharded` runs the same two phases data-parallel over a
jax.sharding.Mesh: phase 1 shards the (ij) rows, an all_to_all reshards to
(pq) columns, phase 2 transforms locally -- no replicated N^4-scale array
ever exists on one device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def mo_pair_indices(n_mo: int):
    """(rows, cols) of the packed MO pair ordering p >= q."""
    return np.tril_indices(n_mo)


def mo_pair_index_matrix(n_mo: int) -> np.ndarray:
    """Symmetric (n_mo, n_mo) -> packed index lookup."""
    idx = np.zeros((n_mo, n_mo), dtype=np.int64)
    rows, cols = np.tril_indices(n_mo)
    idx[rows, cols] = idx[cols, rows] = np.arange(len(rows))
    return idx


def _half_transform(M_rows, pair_index, W, tri):
    """One half-transform: (rows, n_ao_pairs) -> (rows, n_mo_pairs).

    Expands each packed row to its dense symmetric (N, N) matrix by gather,
    applies the W sandwich, and re-packs the (symmetric) MO pair axis.
    """
    dense = M_rows[:, pair_index]                      # (rows, N, N)
    t = jnp.einsum("rkl,kp->rpl", dense, W, optimize=True)
    t = jnp.einsum("rpl,lq->rpq", t, W, optimize=True)
    return t[:, tri[0], tri[1]]


def _chunked_half_transform(M, pair_index, W, tri, row_chunk):
    """Half-transform all rows of M, scanning in chunks so the dense
    (chunk, N, N) workspace stays bounded."""
    n_rows = M.shape[0]
    n_chunks = -(-n_rows // row_chunk)
    pad = n_chunks * row_chunk - n_rows
    Mp = jnp.pad(M, ((0, pad), (0, 0))).reshape(n_chunks, row_chunk, -1)

    def body(_, rows):
        return None, _half_transform(rows, pair_index, W, tri)

    _, out = jax.lax.scan(body, None, Mp)
    return out.reshape(n_chunks * row_chunk, -1)[:n_rows]


@partial(jax.jit, static_argnames=("n_mo", "row_chunk"))
def pair_packed_to_mo(G_pair, pair_index, W, n_mo: int, row_chunk: int = 128):
    """Packed AO pair matrix -> packed MO pair matrix (chemists' notation).

    Args:
        G_pair: (n_ao_pairs, n_ao_pairs) packed (ij|kl).
        pair_index: (N, N) int array mapping dense (i, j) -> packed index.
        W: (N, n_mo) combined cartesian-AO -> MO coefficients.
        n_mo: static MO count.
    Returns:
        (n_mo_pairs, n_mo_pairs) packed (rs|pq); element ((rs),(pq)) with
        both axes packed over the tril ordering of mo_pair_indices(n_mo).
    """
    tri = mo_pair_indices(n_mo)
    pair_index = jnp.asarray(pair_index)
    H = _chunked_half_transform(G_pair, pair_index, W, tri, row_chunk)
    # phase 2 transforms the remaining AO pair axis of H^T
    return _chunked_half_transform(H.T, pair_index, W, tri, row_chunk)


def expand_mo_chemists(G_mo, n_mo: int):
    """Packed MO pair matrix -> dense chemists' (pq|rs) tensor."""
    midx = jnp.asarray(mo_pair_index_matrix(n_mo))
    return G_mo[midx[:, :, None, None], midx[None, None, :, :]]


@partial(jax.jit, static_argnames=("n_mo", "row_chunk"))
def pair_packed_to_mo_mixed(G_pair, pair_index, W_left, W_right, n_mo: int,
                            row_chunk: int = 128):
    """Mixed-coefficient transform: left pair gets W_left, right gets W_right.

    Serves the UHF-reference integral-direct path, where the spin-orbital
    tensor decomposes into spatial chemists' blocks (a_sigma b_sigma |
    c_tau d_tau) with per-spin orbital sets.  Returns the packed matrix
    whose element ((rs), (pq)) is (r_left s_left | p_right q_right); expand
    with `expand_mo_chemists` (both orbital sets span the same n_mo here,
    so the packed orderings coincide).
    """
    tri = mo_pair_indices(n_mo)
    pair_index = jnp.asarray(pair_index)
    H = _chunked_half_transform(G_pair, pair_index, W_right, tri, row_chunk)
    # The second half-transform (over the untouched AO pair axis, using
    # chemists' (ij|kl) = (kl|ij) symmetry) leaves the RIGHT pairs on its
    # row axis; transpose so the left pairs lead.
    return _chunked_half_transform(H.T, pair_index, W_left, tri, row_chunk).T


def pair_packed_to_mo_sharded(G_pair, pair_index, W, n_mo: int,
                              mesh: Mesh, row_chunk: int = 128):
    """Mesh-sharded transform-direct AO -> MO (see module docstring).

    The (ij) row axis of G_pair is sharded over the mesh's first axis;
    phase 1 runs locally per shard, one all_to_all reshards H from
    row-sharded to column-sharded, and phase 2 again runs locally.  The
    result is the packed MO pair matrix sharded over its COLUMN axis.
    """
    axis = mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    tri = mo_pair_indices(n_mo)
    n_mo_pairs = len(tri[0])
    pq_pad = (-n_mo_pairs) % n_dev
    n_rows = G_pair.shape[0]
    pad = (-n_rows) % n_dev
    if pad:
        G_pair = jnp.pad(G_pair, ((0, pad), (0, 0)))
    pair_index_dev = jnp.asarray(pair_index)

    def local(G_rows):
        # phase 1 on this shard's rows
        H_local = _chunked_half_transform(G_rows, pair_index_dev, W, tri,
                                          row_chunk)          # (rows_l, PQ)
        if pq_pad:
            H_local = jnp.pad(H_local, ((0, 0), (0, pq_pad)))
        # reshard: split the PQ axis over devices, gather all rows
        H_cols = jax.lax.all_to_all(H_local, axis, split_axis=1,
                                    concat_axis=0, tiled=True)  # (rows, PQ_l)
        H_cols = H_cols[:n_rows]                              # drop row pad
        # phase 2 on this shard's PQ columns (zero pad columns stay zero)
        return _chunked_half_transform(H_cols.T, pair_index_dev, W, tri,
                                       row_chunk).T           # (RS, PQ_l)

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=PartitionSpec(axis),
                       out_specs=PartitionSpec(None, axis))
    sharded = jax.jit(fn)
    out = sharded(jax.device_put(
        G_pair, NamedSharding(mesh, PartitionSpec(axis))))
    return out[:, :n_mo_pairs] if pq_pad else out
