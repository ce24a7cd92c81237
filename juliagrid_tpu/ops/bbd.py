"""Bordered-block-diagonal (BBD) partitioning and Schur-complement solves.

The scale axis of this domain is network size (SURVEY §5: up to the 82k-bus
SyntheticUSA case). A single giant nodal matrix doesn't fit one chip's
dense path, so the matrix is permuted to bordered block-diagonal form:

    [ A_11          B_1 ] [x_1]   [r_1]
    [       ...     ...  ] [...] = [...]
    [            A_kk B_k ] [x_k]   [r_k]
    [ C_1   ...  C_k  D  ] [x_b]   [r_b]

Interior blocks factorize independently (vmapped mixed-precision dense
factorizations — or one per device over a ``block`` mesh axis); the border
Schur complement S = D - Σ_k C_k A_kk⁻¹ B_k reduces over blocks with a
``psum`` across devices, the (small) border system solves replicated, and the
back-substitution is again embarrassingly block-parallel. This is the
network-model-parallel axis that complements scenario data parallelism
(parallel/batch.py), per the BASELINE north star.

Partitioning runs host-side: BFS region growing over the bus graph
(the same style as the reference's physicalIsland BFS, model.jl:375-463)
with border extraction.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import scipy.sparse as sp

from . import linalg


def bbd_partition(adjacency: sp.spmatrix, n_blocks: int):
    """Partition buses into blocks + border via BFS region growing.

    Returns (block_of_bus array with -1 for border buses, border list).
    A bus whose neighbors span multiple regions is promoted to the border.
    """
    n = adjacency.shape[0]
    adj = adjacency.tocsr()
    target = (n + n_blocks - 1) // n_blocks

    region = np.full(n, -2, dtype=np.int64)  # -2 unassigned
    seeds = np.linspace(0, n - 1, n_blocks).astype(np.int64)
    frontiers = []
    for b, s in enumerate(seeds):
        while region[s] != -2:
            s = (s + 1) % n
        region[s] = b
        frontiers.append([int(s)])

    sizes = [1] * n_blocks
    active = True
    while active:
        active = False
        for b in range(n_blocks):
            if sizes[b] >= target or not frontiers[b]:
                continue
            new_frontier = []
            for u in frontiers[b]:
                for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
                    if region[v] == -2 and sizes[b] < target:
                        region[v] = b
                        sizes[b] += 1
                        new_frontier.append(int(v))
            frontiers[b] = new_frontier
            active = active or bool(new_frontier)

    # any unassigned stragglers join the smallest region
    for u in np.flatnonzero(region == -2):
        b = int(np.argmin(sizes))
        region[u] = b
        sizes[b] += 1

    # border: buses adjacent to a different region
    border = []
    for u in range(n):
        for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
            if region[v] != region[u]:
                border.append(u)
                break
    border = np.asarray(sorted(set(border)), dtype=np.int64)
    block_of = region.copy()
    block_of[border] = -1
    return block_of, border


class BbdArrays(NamedTuple):
    a_ii: jax.Array      # (k, ni, ni) interior blocks (padded, identity tail)
    a_ib: jax.Array      # (k, ni, m) interior-border coupling
    a_bi: jax.Array      # (k, m, ni)
    a_bb: jax.Array      # (m, m) border block
    interior_idx: jax.Array  # (k, ni) original bus index per padded slot
    interior_mask: jax.Array  # (k, ni) 1 for real slots
    border_idx: jax.Array    # (m,)


def build_bbd_arrays(a, block_of: np.ndarray,
                     border: np.ndarray) -> BbdArrays:
    """Compile the BBD snapshot from a host matrix — scipy sparse (the
    scale path: block extraction is O(nnz), no dense n x n intermediate)
    or dense ndarray (small cases/tests)."""
    n = a.shape[0]
    k = int(block_of.max()) + 1
    m = len(border)
    groups = [np.flatnonzero(block_of == b) for b in range(k)]
    ni = max(len(g) for g in groups)

    if sp.issparse(a):
        a_csr = a.tocsr()
        sub = lambda r, c: a_csr[r][:, c].toarray()  # noqa: E731
    else:
        sub = lambda r, c: np.asarray(a)[np.ix_(r, c)]  # noqa: E731

    a_ii = np.zeros((k, ni, ni))
    a_ib = np.zeros((k, ni, m))
    a_bi = np.zeros((k, m, ni))
    idx = np.zeros((k, ni), dtype=np.int64)
    mask = np.zeros((k, ni))
    for b, g in enumerate(groups):
        s = len(g)
        a_ii[b, :s, :s] = sub(g, g)
        a_ii[b, s:, s:] = np.eye(ni - s)
        a_ib[b, :s, :] = sub(g, border)
        a_bi[b, :, :s] = sub(border, g)
        idx[b, :s] = g
        mask[b, :s] = 1.0
    a_bb = sub(border, border)
    return BbdArrays(
        a_ii=jnp.asarray(a_ii), a_ib=jnp.asarray(a_ib),
        a_bi=jnp.asarray(a_bi), a_bb=jnp.asarray(a_bb),
        interior_idx=jnp.asarray(idx), interior_mask=jnp.asarray(mask),
        border_idx=jnp.asarray(border))


@jax.jit
def bbd_solve(arr: BbdArrays, rhs):
    """Solve A x = rhs through the Schur complement (single device,
    blocks vmapped)."""
    r_i = jax.vmap(lambda idx, msk: rhs[idx] * msk)(
        arr.interior_idx, arr.interior_mask)
    r_b = rhs[arr.border_idx]

    y, z = linalg.batched_lu_solve2(arr.a_ii, r_i, arr.a_ib)
    schur = arr.a_bb - jnp.sum(arr.a_bi @ z, axis=0)
    rhs_b = r_b - jnp.sum(
        jnp.einsum("kmi,ki->km", arr.a_bi, y), axis=0)
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_b)

    x_i = y - jnp.einsum("kim,m->ki", z, x_b)
    n = rhs.shape[0]
    x = jnp.zeros(n, dtype=rhs.dtype)
    x = x.at[arr.border_idx].set(x_b)

    def write(x, idx, xi, msk):
        return x.at[idx].add(xi * msk)

    for b in range(arr.a_ii.shape[0]):
        x = write(x, arr.interior_idx[b], x_i[b], arr.interior_mask[b])
    return x


def bbd_solve_sharded(mesh, arr: BbdArrays, rhs, axis: str = "block"):
    """Schur solve with interior blocks sharded over a mesh axis.

    Per-device: factor its block, local Schur contribution; ``psum``
    across the mesh combines the border system; the border solve
    replicates; the back-substitution stays local. The number of blocks
    must equal the axis size.
    """
    from jax.sharding import PartitionSpec as P

    k = arr.a_ii.shape[0]

    def local(a_ii, a_ib, a_bi, idx, msk, a_bb, rhs):
        # leading block axis is length-1 on each device
        a_ii, a_ib, a_bi = a_ii[0], a_ib[0], a_bi[0]
        idx, msk = idx[0], msk[0]
        r_i = rhs[idx] * msk
        f = linalg.factorize(a_ii, linalg.LU)
        y = linalg.solve(f, r_i)
        z = linalg.solve(f, a_ib)
        schur_part = a_bi @ z
        rhs_part = a_bi @ y
        schur = a_bb - jax.lax.psum(schur_part, axis)
        rhs_b = rhs[arr.border_idx] - jax.lax.psum(rhs_part, axis)
        x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_b)
        x_i = y - z @ x_b
        return x_i[None], x_b

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P()))
    x_i, x_b = fn(arr.a_ii, arr.a_ib, arr.a_bi, arr.interior_idx,
                  arr.interior_mask, arr.a_bb, rhs)
    n = rhs.shape[0]
    x = jnp.zeros(n, dtype=rhs.dtype).at[arr.border_idx].set(x_b)
    for b in range(k):
        x = x.at[arr.interior_idx[b]].add(
            x_i[b] * arr.interior_mask[b])
    return x


def bbd_matvec(arr: BbdArrays, x):
    """A @ x through the block structure (no dense n x n assembly)."""
    x_i = jax.vmap(lambda idx, msk: x[idx] * msk)(
        arr.interior_idx, arr.interior_mask)
    x_b = x[arr.border_idx]
    ax_i = jnp.einsum("kij,kj->ki", arr.a_ii, x_i) + arr.a_ib @ x_b
    ax_b = arr.a_bb @ x_b + jnp.sum(
        jnp.einsum("kmi,ki->km", arr.a_bi, x_i), axis=0)
    n = x.shape[0]
    out = jnp.zeros(n, dtype=x.dtype).at[arr.border_idx].set(ax_b)
    for b in range(arr.a_ii.shape[0]):
        out = out.at[arr.interior_idx[b]].add(
            ax_i[b] * arr.interior_mask[b])
    return out


@jax.jit
def bbd_solve_f64(arr: BbdArrays, rhs, refine: int = 2):
    """Full-f64 Schur solve for a symmetric quasi-definite BBD matrix.

    The endgame companion of ``bbd_solve``: the interior blocks (one
    batched f64 LU) and the border Schur complement are factored in f64.
    Used when the f32 factorization's backward error stalls the
    interior-point endgame (lin_res >= 1e-6 at active-set conditioning) —
    the structured-path twin of linalg.solve_f64_sqd. Block elimination's
    FORWARD error still scales with the interior conditioning, so the
    factors drive ``refine`` f64 refinement sweeps against the full BBD
    operator (each sweep is two cheap block matvecs + the already-computed
    triangular solves).
    """
    f_i = jax.vmap(jsl.lu_factor)(arr.a_ii)
    z = jax.vmap(jsl.lu_solve)(f_i, arr.a_ib)
    schur = arr.a_bb - jnp.sum(arr.a_bi @ z, axis=0)
    f_s = jsl.lu_factor(schur)

    n = rhs.shape[0]

    def direct(b):
        r_i = jax.vmap(lambda idx, msk: b[idx] * msk)(
            arr.interior_idx, arr.interior_mask)
        r_b = b[arr.border_idx]
        y = jax.vmap(jsl.lu_solve)(f_i, r_i)
        rhs_b = r_b - jnp.sum(
            jnp.einsum("kmi,ki->km", arr.a_bi, y), axis=0)
        x_b = jsl.lu_solve(f_s, rhs_b)
        x_i = y - jnp.einsum("kim,m->ki", z, x_b)
        x = jnp.zeros(n, dtype=b.dtype).at[arr.border_idx].set(x_b)
        for blk in range(arr.a_ii.shape[0]):
            x = x.at[arr.interior_idx[blk]].add(
                x_i[blk] * arr.interior_mask[blk])
        return x

    x = direct(rhs)

    def body(_, x):
        return x + direct(rhs - bbd_matvec(arr, x))

    return jax.lax.fori_loop(0, refine, body, x)


class BbdLocalArrays(NamedTuple):
    """BBD snapshot with LOCALITY-COMPRESSED border couplings: each
    block stores only the border columns it actually touches (mbl local
    slots, bsel mapping them to global border slots, padded with mb).
    k*ni*mbl grows ~n where the global-width k*ni*mb grows ~n^1.5 — the
    coupling memory wall of 10k+ KKT systems (same compression the NR
    and SE BBD paths carry)."""

    a_ii: jax.Array      # (k, ni, ni)
    a_ib: jax.Array      # (k, ni, mbl) local coupling
    a_bi: jax.Array      # (k, mbl, ni)
    a_bb: jax.Array      # (mb, mb)
    bsel: jax.Array      # i32 (k, mbl) local slot -> global border slot
    bmask: jax.Array     # (k, mbl) 1 for real slots
    interior_idx: jax.Array
    interior_mask: jax.Array
    border_idx: jax.Array


@jax.jit
def bbd_solve_local(arr: BbdLocalArrays, rhs):
    """Schur solve on the locality-compressed layout (single device)."""
    mb = arr.a_bb.shape[0]
    r_i = jax.vmap(lambda idx, msk: rhs[idx] * msk)(
        arr.interior_idx, arr.interior_mask)
    r_b = rhs[arr.border_idx]

    y, z = linalg.batched_lu_solve2(arr.a_ii, r_i, arr.a_ib)
    contrib = arr.a_bi @ z                       # (k, mbl, mbl)
    s_pad = jnp.zeros((mb + 1, mb + 1), dtype=rhs.dtype)
    s_pad = s_pad.at[arr.bsel[:, :, None], arr.bsel[:, None, :]].add(
        -contrib)
    schur = arr.a_bb + s_pad[:mb, :mb]
    r_red = jnp.zeros(mb + 1, dtype=rhs.dtype).at[arr.bsel].add(
        jnp.einsum("kmi,ki->km", arr.a_bi, y))
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU),
                       r_b - r_red[:mb])
    x_b_loc = jnp.concatenate(
        [x_b, jnp.zeros(1, dtype=rhs.dtype)])[arr.bsel] * arr.bmask
    x_i = y - jnp.einsum("kim,km->ki", z, x_b_loc)
    n = rhs.shape[0]
    x = jnp.zeros(n, dtype=rhs.dtype).at[arr.border_idx].set(x_b)
    for b in range(arr.a_ii.shape[0]):
        x = x.at[arr.interior_idx[b]].add(
            x_i[b] * arr.interior_mask[b])
    return x


@jax.jit
def bbd_solve_local_f64(arr: BbdLocalArrays, rhs, refine: int = 2):
    """Full-f64 LU Schur solve on the local layout (the endgame twin of
    bbd_solve_local; see bbd_solve_f64 for the math)."""
    mb = arr.a_bb.shape[0]
    f_i = jax.vmap(jsl.lu_factor)(arr.a_ii)
    z = jax.vmap(jsl.lu_solve)(f_i, arr.a_ib)
    contrib = arr.a_bi @ z
    s_pad = jnp.zeros((mb + 1, mb + 1), dtype=rhs.dtype)
    s_pad = s_pad.at[arr.bsel[:, :, None], arr.bsel[:, None, :]].add(
        -contrib)
    schur = arr.a_bb + s_pad[:mb, :mb]
    f_s = jsl.lu_factor(schur)
    n = rhs.shape[0]

    def matvec(x):
        x_i = jax.vmap(lambda idx, msk: x[idx] * msk)(
            arr.interior_idx, arr.interior_mask)
        x_b = x[arr.border_idx]
        x_b_loc = jnp.concatenate(
            [x_b, jnp.zeros(1, dtype=x.dtype)])[arr.bsel] * arr.bmask
        ax_i = jnp.einsum("kij,kj->ki", arr.a_ii, x_i) \
            + jnp.einsum("kim,km->ki", arr.a_ib, x_b_loc)
        ax_b = arr.a_bb @ x_b
        ab_loc = jnp.einsum("kmi,ki->km", arr.a_bi, x_i)
        ax_b = ax_b + jnp.zeros(mb + 1, dtype=x.dtype).at[arr.bsel].add(
            ab_loc)[:mb]
        out = jnp.zeros(n, dtype=x.dtype).at[arr.border_idx].set(ax_b)
        for b in range(arr.a_ii.shape[0]):
            out = out.at[arr.interior_idx[b]].add(
                ax_i[b] * arr.interior_mask[b])
        return out

    def direct(b):
        r_i = jax.vmap(lambda idx, msk: b[idx] * msk)(
            arr.interior_idx, arr.interior_mask)
        r_b = b[arr.border_idx]
        y = jax.vmap(jsl.lu_solve)(f_i, r_i)
        r_red = jnp.zeros(mb + 1, dtype=b.dtype).at[arr.bsel].add(
            jnp.einsum("kmi,ki->km", arr.a_bi, y))
        x_b = jsl.lu_solve(f_s, r_b - r_red[:mb])
        x_b_loc = jnp.concatenate(
            [x_b, jnp.zeros(1, dtype=b.dtype)])[arr.bsel] * arr.bmask
        x_i = y - jnp.einsum("kim,km->ki", z, x_b_loc)
        x = jnp.zeros(n, dtype=b.dtype).at[arr.border_idx].set(x_b)
        for blk in range(arr.a_ii.shape[0]):
            x = x.at[arr.interior_idx[blk]].add(
                x_i[blk] * arr.interior_mask[blk])
        return x

    x = direct(rhs)

    def body(_, x):
        return x + direct(rhs - matvec(x))

    return jax.lax.fori_loop(0, refine, body, x)


class BbdFactors(NamedTuple):
    """Precomputed BBD factorization: per-block f32 LU factors, the
    interior-solved coupling Z = A_ii^-1 B, and the factored Schur
    complement. Amortizes across iterations for constant matrices
    (fast-decoupled B'/B'', DC nodal, SE gain patterns)."""

    lu: jax.Array
    piv: jax.Array
    a_ii: jax.Array
    z: jax.Array
    a_bi: jax.Array
    schur_lu: jax.Array
    schur_piv: jax.Array
    schur: jax.Array
    interior_idx: jax.Array
    interior_mask: jax.Array
    border_idx: jax.Array


@jax.jit
def bbd_precompute(arr: BbdArrays) -> BbdFactors:
    lu, piv = jax.vmap(linalg.lu_factor32)(arr.a_ii)
    z = jax.vmap(linalg.lu_solve_refined)(lu, piv, arr.a_ii, arr.a_ib)
    schur = arr.a_bb - jnp.sum(arr.a_bi @ z, axis=0)
    schur_lu, schur_piv = linalg.lu_factor32(schur)
    return BbdFactors(
        lu=lu, piv=piv, a_ii=arr.a_ii, z=z, a_bi=arr.a_bi,
        schur_lu=schur_lu, schur_piv=schur_piv, schur=schur,
        interior_idx=arr.interior_idx, interior_mask=arr.interior_mask,
        border_idx=arr.border_idx)


def bbd_presolved_solve(f: BbdFactors, rhs):
    """Solve with precomputed factors: triangular solves + one reduction."""
    r_i = jax.vmap(lambda idx, msk: rhs[idx] * msk)(
        f.interior_idx, f.interior_mask)
    r_b = rhs[f.border_idx]
    y = jax.vmap(linalg.lu_solve_refined)(f.lu, f.piv, f.a_ii, r_i)
    rhs_b = r_b - jnp.sum(jnp.einsum("kmi,ki->km", f.a_bi, y), axis=0)
    x_b = linalg.lu_solve_refined(f.schur_lu, f.schur_piv, f.schur, rhs_b)
    x_i = y - jnp.einsum("kim,m->ki", f.z, x_b)
    n = rhs.shape[0]
    x = jnp.zeros(n, dtype=rhs.dtype).at[f.border_idx].set(x_b)
    k = f.a_ii.shape[0]
    for b in range(k):
        x = x.at[f.interior_idx[b]].add(x_i[b] * f.interior_mask[b])
    return x
