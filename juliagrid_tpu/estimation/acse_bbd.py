"""Gauss-Newton WLS state estimation on the BBD/Schur substrate.

The dense SE path (acse.py) scatters the measurement Jacobian into one
(m x 2n) matrix and forms gain = HᵀWH with a single dense matmul — fine to
~3k buses, impossible at ACTIVSg/SyntheticUSA scale. Here the gain matrix
never materializes globally:

  1. buses are partitioned on the SQUARED nodal pattern (the gain graph:
     an injection row couples buses two hops apart) with
     ops/partition.nd_partition, so every measurement row's variables live
     in one interior block ∪ border;
  2. measurement rows are assigned to the block of their interior
     variables (border-only rows round-robin); the H entry-IR
     (acse.h_entries) is routed at compile time into per-block row-local
     matrices H_int (k, mr, 2ni) and H_bdr (k, mr, 2lb), where the border
     columns are COMPRESSED to each block's local border (a block touches
     O(sqrt ni) of the global border, so the strips stay small at 10k+);
  3. each iteration the gain blocks are batched matmuls
     G_ii = H_intᵀ W H_int, G_ib = H_intᵀ W H_bdr,
     S_kk = H_bdrᵀ W H_bdr, followed by vmapped mixed-precision interior
     factorizations and a Schur-complement border solve whose matrix is
     scatter-assembled from the per-block local contributions —
     O(k·ni³ + mb³) instead of O((2n)³). The interior work shards over a
     ``block`` mesh axis for multi-device single-case estimation.

Reference parity anchor: the KLU/CHOLMOD normal-equations substrate of
acStateEstimation.jl:878-931 + backend/utility.jl:470-562, re-designed for
block-parallel dense factorization instead of serial sparse elimination.

Correlated rectangular PMU pairs are not supported on this path (use the
dense Normal path); they raise, mirroring the reference's guard on the
orthogonal method (acStateEstimation.jl:47-49).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..ops import linalg
from ..ops.partition import nd_partition
from ..powerflow.ac import Polar, compile_ac_arrays
from ..system.model import model
from ..system.types import PowerSystem
from ..utils.errors import MethodError_
from .acse import (AcStateEstimation, SeMethod, compile_se_arrays,
                   h_entries, h_entry_pattern)


class SeBbdArrays(NamedTuple):
    base: tuple          # SeArrays
    net: tuple           # AcArrays
    ent_rows: jax.Array  # i32[E] measurement row per H entry
    # entry routing into per-block H matrices
    hi_sel: jax.Array    # entries landing in H_int
    hi_blk: jax.Array
    hi_row: jax.Array
    hi_col: jax.Array
    hb_sel: jax.Array    # entries landing in H_bdr (local border cols)
    hb_blk: jax.Array
    hb_row: jax.Array
    hb_col: jax.Array
    # per-BLOCK padded entry tables: the H blocks build one block at a
    # time inside a lax.map, so the (k, mr, 2ni) batch never
    # materializes (about 9e8 elements at the 25k lattice)
    pb_ei: jax.Array     # i32 (k, emax_i) entry index (pad 0)
    pb_mi: jax.Array     # f64 (k, emax_i) 1/0 pad mask
    pb_ri: jax.Array     # i32 (k, emax_i) row slot
    pb_ci: jax.Array     # i32 (k, emax_i) interior col slot
    pb_eb: jax.Array     # border analogs
    pb_mb: jax.Array
    pb_rb: jax.Array
    pb_cb: jax.Array
    # row routing
    rows_idx: jax.Array   # i32[k, mr] measurement row per slot (pad 0)
    row_mask: jax.Array   # f64[k, mr]
    # local border -> global border slot map (pad -> 2mb sentinel)
    lb_gidx: jax.Array    # i32[k, 2lb]
    # variable routing / masks
    bus_block: jax.Array  # i32[n] (-1 border)
    bus_slot: jax.Array   # i32[n]
    mask_int: jax.Array   # f64[k, 2ni]
    mask_bdr: jax.Array   # f64[2mb]


@dataclass
class _SeBbdLayout:
    k: int
    ni: int
    mb: int
    mr: int
    lb: int


def compile_se_bbd(system: PowerSystem, monitoring, n_blocks: int):
    # all routing below reads the HOST mirrors (arr_h), never device
    # arrays
    arr, types, row_device, arr_h = compile_se_arrays(
        system, monitoring, return_host=True)
    net = compile_ac_arrays(system)
    if arr_h.pair_r1.shape[0]:
        raise MethodError_(
            "A non-diagonal precision matrix prevents the use of the "
            "BBD method; use the dense Normal path.")
    n = system.bus.number
    model(system, "ac")

    nodal = system.model.ac.nodal.tocsr()
    pat = sp.csr_matrix((np.ones(nodal.nnz), nodal.indices, nodal.indptr),
                        shape=nodal.shape)
    gain_pat = (pat @ pat).tocsr()
    block_of, border = nd_partition(gain_pat, n_blocks)
    k = n_blocks
    groups = [np.flatnonzero(block_of == b) for b in range(k)]
    ni = max(max(len(g) for g in groups), 1)
    mb = max(len(border), 1)

    bus_block = block_of.astype(np.int64)
    bus_slot = np.zeros(n, dtype=np.int64)
    for g in groups:
        bus_slot[g] = np.arange(len(g))
    bus_slot[border] = np.arange(len(border))

    from ..powerflow.ac import ac_entry_host
    net_rows, net_cols_h, _vals, _diag = ac_entry_host(system)
    net_h = net._replace(cols=net_cols_h)
    ent_rows, ent_cols = h_entry_pattern(arr_h, net_h, n, xp=np)
    m = int(arr_h.mean.shape[0])

    # row -> block: the block of any interior variable it touches (the
    # squared-pattern partition guarantees uniqueness); border-only rows
    # round-robin for load balance
    ent_bus = ent_cols % n
    row_block = np.full(m, -1, dtype=np.int64)
    for e in range(len(ent_rows)):
        b = bus_block[ent_bus[e]]
        if b < 0:
            continue
        r = ent_rows[e]
        if row_block[r] < 0:
            row_block[r] = b
        elif row_block[r] != b:
            raise RuntimeError(
                "SE BBD routing: row touches two interiors "
                f"(row {r}: blocks {row_block[r]} and {b})")
    rr = 0
    for r in np.flatnonzero(row_block < 0):
        row_block[r] = rr % k
        rr += 1

    rows_of = [np.flatnonzero(row_block == b) for b in range(k)]
    mr = max(max(len(rws) for rws in rows_of), 1)
    rows_idx = np.zeros((k, mr), dtype=np.int64)
    row_mask = np.zeros((k, mr))
    row_slot = np.zeros(m, dtype=np.int64)
    for b, rws in enumerate(rows_of):
        rows_idx[b, :len(rws)] = rws
        row_mask[b, :len(rws)] = 1.0
        row_slot[rws] = np.arange(len(rws))

    # entry routing; border columns compressed to each block's local border
    is_mag = ent_cols >= n
    blk_e = row_block[ent_rows]
    lrow_e = row_slot[ent_rows]
    col_interior = bus_block[ent_bus] >= 0

    sel = np.arange(len(ent_rows))
    hi = col_interior
    hb = ~col_interior

    lcol_int = bus_slot[ent_bus] + np.where(is_mag, ni, 0)

    # local border lists per block (global border slots touched)
    local_lists = []
    for b in range(k):
        touched = np.unique(bus_slot[ent_bus[hb & (blk_e == b)]])
        local_lists.append(touched)
    lb = max(max((len(t) for t in local_lists), default=0), 1)
    lb_gidx = np.full((k, 2 * lb), 2 * mb, dtype=np.int64)  # pad sentinel
    local_of = {}  # (block, global border slot) -> local slot
    for b, touched in enumerate(local_lists):
        for s, gslot in enumerate(touched):
            local_of[(b, int(gslot))] = s
            lb_gidx[b, s] = gslot
            lb_gidx[b, lb + s] = mb + gslot
    lcol_bdr = np.zeros(len(ent_rows), dtype=np.int64)
    for e in np.flatnonzero(hb):
        s = local_of[(int(blk_e[e]), int(bus_slot[ent_bus[e]]))]
        lcol_bdr[e] = s + (lb if is_mag[e] else 0)

    # masks: real slots active; slack angle pinned
    slack = int(arr_h.slack)
    mask_int = np.zeros((k, 2 * ni))
    for b, g in enumerate(groups):
        mask_int[b, :len(g)] = 1.0
        mask_int[b, ni:ni + len(g)] = 1.0
    mask_bdr = np.zeros(2 * mb)
    mask_bdr[:len(border)] = 1.0
    mask_bdr[mb:mb + len(border)] = 1.0
    if bus_block[slack] >= 0:
        mask_int[bus_block[slack], bus_slot[slack]] = 0.0
    else:
        mask_bdr[bus_slot[slack]] = 0.0

    def group_pad(mask, lcol):
        idxs = [sel[mask & (blk_e == b)] for b in range(k)]
        emax = max(max((len(ii) for ii in idxs), default=0), 1)
        eidx = np.zeros((k, emax), np.int64)
        emask = np.zeros((k, emax))
        for b, ii in enumerate(idxs):
            eidx[b, :len(ii)] = ii
            emask[b, :len(ii)] = 1.0
        return eidx, emask, lrow_e[eidx], lcol[eidx]

    pb_ei, pb_mi, pb_ri, pb_ci = group_pad(hi, lcol_int)
    pb_eb, pb_mb_, pb_rb, pb_cb = group_pad(hb, lcol_bdr)

    i32 = lambda x: jnp.asarray(np.asarray(x), dtype=jnp.int32)  # noqa: E731
    sb = SeBbdArrays(
        base=arr, net=net, ent_rows=i32(ent_rows),
        hi_sel=i32(sel[hi]), hi_blk=i32(blk_e[hi]),
        hi_row=i32(lrow_e[hi]), hi_col=i32(lcol_int[hi]),
        hb_sel=i32(sel[hb]), hb_blk=i32(blk_e[hb]),
        hb_row=i32(lrow_e[hb]), hb_col=i32(lcol_bdr[hb]),
        pb_ei=i32(pb_ei), pb_mi=jnp.asarray(pb_mi),
        pb_ri=i32(pb_ri), pb_ci=i32(pb_ci),
        pb_eb=i32(pb_eb), pb_mb=jnp.asarray(pb_mb_),
        pb_rb=i32(pb_rb), pb_cb=i32(pb_cb),
        rows_idx=i32(rows_idx), row_mask=jnp.asarray(row_mask),
        lb_gidx=i32(lb_gidx),
        bus_block=i32(bus_block), bus_slot=i32(bus_slot),
        mask_int=jnp.asarray(mask_int), mask_bdr=jnp.asarray(mask_bdr))
    layout = _SeBbdLayout(k=k, ni=ni, mb=mb, mr=mr, lb=lb)
    return sb, layout, types, row_device


# element budget (k*mr*2ni) for the vmapped gain stage; ACTIVSg10k
# (~2.1e8) batches, the 25k lattice (~9e8) streams per block. The bound
# was set on the previous accelerator and is to be re-derived on the GPU.
_GAIN_BATCH_ELEMS = int(4e8)


def _gn_increment_bbd(sb: SeBbdArrays, layout: _SeBbdLayout, vm, va):
    arr = sb.base
    k, ni, mb, lb = layout.k, layout.ni, layout.mb, layout.lb
    mr = layout.mr
    n = vm.shape[0]

    vals, h = h_entries(arr, sb.net, vm, va)
    vals = vals * arr.status[sb.ent_rows]
    r = arr.mean - h

    # Entry-level masking, then the SAME memory/precision design as the
    # dense path (acse.gn_increment): the H blocks materialize ONLY in
    # f32 (weight-scaled, feeding HIGHEST-precision gain matmuls one
    # block at a time) while the f64 right-hand side comes exactly from
    # the sparse entry list. An f64 (k, mr, 2ni) H would be 7.6 GB at
    # the 25k lattice; the fixed point of the GN iteration is
    # rhs = H'Wr = 0, which stays f64-exact — the f32-formed gain only
    # affects the contraction rate.
    mask_lb = jnp.concatenate(
        [sb.mask_bdr, jnp.zeros(1, dtype=vm.dtype)])[sb.lb_gidx]  # (k, 2lb)
    sqw_g = jnp.sqrt(arr.w)
    wr_g = arr.w * r

    vals_i = vals[sb.hi_sel] * sb.mask_int[sb.hi_blk, sb.hi_col]
    rows_i = sb.ent_rows[sb.hi_sel]
    rhs_i = jnp.zeros((k, 2 * ni), dtype=vm.dtype)
    rhs_i = rhs_i.at[sb.hi_blk, sb.hi_col].add(vals_i * wr_g[rows_i])

    vals_b = vals[sb.hb_sel] * mask_lb[sb.hb_blk, sb.hb_col]
    rows_b = sb.ent_rows[sb.hb_sel]
    rhs_bk = jnp.zeros((k, 2 * lb), dtype=vm.dtype)
    rhs_bk = rhs_bk.at[sb.hb_blk, sb.hb_col].add(vals_b * wr_g[rows_b])

    hiprec = jax.lax.Precision.HIGHEST

    def _gains_block(args):
        ei, mi_, ri, ci, mint_b, eb, mb_, rb, cb, mlb_b = args
        v_i = vals[ei] * mi_ * mint_b[ci]
        h_b = jnp.zeros((mr, 2 * ni), dtype=jnp.float32)
        h_b = h_b.at[ri, ci].add(
            (v_i * sqw_g[sb.ent_rows[ei]]).astype(jnp.float32))
        v_b = vals[eb] * mb_ * mlb_b[cb]
        hb_b = jnp.zeros((mr, 2 * lb), dtype=jnp.float32)
        hb_b = hb_b.at[rb, cb].add(
            (v_b * sqw_g[sb.ent_rows[eb]]).astype(jnp.float32))
        g_ii_b = jnp.matmul(h_b.T, h_b, precision=hiprec).astype(
            vm.dtype) + jnp.diag(1.0 - mint_b)
        g_ib_b = jnp.matmul(h_b.T, hb_b, precision=hiprec).astype(
            vm.dtype)
        s_kk_b = jnp.matmul(hb_b.T, hb_b, precision=hiprec).astype(
            vm.dtype)
        return g_ii_b, g_ib_b, s_kk_b

    tables = (sb.pb_ei, sb.pb_mi, sb.pb_ri, sb.pb_ci, sb.mask_int,
              sb.pb_eb, sb.pb_mb, sb.pb_rb, sb.pb_cb, mask_lb)
    if k * mr * 2 * ni <= _GAIN_BATCH_ELEMS:
        # small enough to batch: vmapped f32 H builds + gain matmuls,
        # then the batched LU and batched f64 Schur einsums — the fully
        # sequential per-block pipeline below is slower wherever the
        # batch fits
        g_ii, g_ib, s_kk = jax.vmap(_gains_block)(tables)
        y, z = linalg.batched_lu_solve2(g_ii, rhs_i, g_ib)
        s_contrib = s_kk - jnp.einsum("kcm,kcd->kmd", g_ib, z)
        rhs_contrib = rhs_bk - jnp.einsum("kcm,kc->km", g_ib, y)
    else:
        # past the budget everything streams one block at a time: the
        # batched gain/Schur einsums over all k at once materialize
        # split-product temporaries that grow with k*mr*2ni
        def _per_block(args):
            rhs_i_b, rhs_b_b = args[-2:]
            g_ii_b, g_ib_b, s_kk_b = _gains_block(args[:-2])
            lu, piv = linalg.lu_factor32(g_ii_b)
            y_b = linalg.lu_solve_refined(lu, piv, g_ii_b, rhs_i_b)
            z_b = linalg.lu_solve_refined(lu, piv, g_ii_b, g_ib_b)
            s_c_b = s_kk_b - g_ib_b.T @ z_b
            r_c_b = rhs_b_b - g_ib_b.T @ y_b
            return y_b, z_b, s_c_b, r_c_b

        y, z, s_contrib, rhs_contrib = jax.lax.map(
            _per_block, tables + (rhs_i, rhs_bk))
    schur = jnp.zeros((2 * mb + 1, 2 * mb + 1), dtype=vm.dtype)
    schur = schur.at[sb.lb_gidx[:, :, None],
                     sb.lb_gidx[:, None, :]].add(s_contrib)
    schur = schur[:2 * mb, :2 * mb] + jnp.diag(1.0 - sb.mask_bdr)
    rhs_s = jnp.zeros(2 * mb + 1, dtype=vm.dtype)
    rhs_s = rhs_s.at[sb.lb_gidx].add(rhs_contrib)[:2 * mb]
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_s)
    x_b_loc = jnp.concatenate(
        [x_b, jnp.zeros(1, dtype=vm.dtype)])[sb.lb_gidx]  # (k, 2lb)
    x_i = y - jnp.einsum("kcm,km->kc", z, x_b_loc)

    interior = sb.bus_block >= 0
    blk_safe = jnp.where(interior, sb.bus_block, 0)
    d_ang = jnp.where(interior, x_i[blk_safe, sb.bus_slot],
                      x_b[sb.bus_slot])
    d_mag = jnp.where(interior, x_i[blk_safe, ni + sb.bus_slot],
                      x_b[mb + sb.bus_slot])
    dx = jnp.concatenate([d_ang, d_mag])
    return dx, jnp.max(jnp.abs(dx))


@partial(jax.jit, static_argnames=("k", "ni", "mb", "mr", "lb", "max_iter"))
def _se_bbd_solve(sb: SeBbdArrays, k, ni, mb, mr, lb, vm, va, tol,
                  max_iter):
    layout = _SeBbdLayout(k=k, ni=ni, mb=mb, mr=mr, lb=lb)
    n = vm.shape[0]
    dx, maxinc = _gn_increment_bbd(sb, layout, vm, va)

    def cond(carry):
        vm, va, dx, maxinc, it = carry
        return (maxinc >= tol) & (it < max_iter)

    def body(carry):
        vm, va, dx, _, it = carry
        va = va + dx[:n]
        vm = vm + dx[n:]
        dx, maxinc = _gn_increment_bbd(sb, layout, vm, va)
        return vm, va, dx, maxinc, it + 1

    vm, va, dx, maxinc, it = jax.lax.while_loop(
        cond, body, (vm, va, dx, maxinc, jnp.int64(0)))
    return vm, va, it, maxinc, maxinc < tol


def gauss_newton_bbd(monitoring, n_blocks: int = 8) -> AcStateEstimation:
    """Gauss-Newton WLS with the BBD/Schur gain substrate (scale path)."""
    system = monitoring.system
    system.check_slack()
    model(system, "ac")
    n = system.bus.number
    sb, layout, types, row_device = compile_se_bbd(system, monitoring,
                                                   n_blocks)
    rev = system.model.revision
    method = SeMethod("gauss_newton_bbd")
    method.type = types
    method.row_device = row_device
    analysis = AcStateEstimation(
        system=system,
        monitoring=monitoring,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        method=method,
        arrays=sb.base,
        net=sb.net,
        signature={"ac_model": rev.ac_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )
    analysis._bbd = sb
    analysis._bbd_layout = layout
    analysis._bbd_n_blocks = n_blocks
    return analysis


def se_bbd_refresh(analysis: AcStateEstimation):
    """Signature-protocol staleness refresh for the BBD SE snapshot."""
    rev = analysis.system.model.revision
    mrev = analysis.monitoring.revision
    sig = analysis.signature
    if (sig.get("ac_model") != rev.ac_model
            or sig.get("measurement") != mrev.measurement
            or sig.get("meas_values") != mrev.values
            or sig.get("slack") != rev.slack):
        sb, layout, types, row_device = compile_se_bbd(
            analysis.system, analysis.monitoring, analysis._bbd_n_blocks)
        analysis._bbd = sb
        analysis._bbd_layout = layout
        analysis.arrays = sb.base
        analysis.net = sb.net
        analysis.method.type = types
        analysis.method.row_device = row_device
        sig.update(ac_model=rev.ac_model, measurement=mrev.measurement,
                   meas_values=mrev.values, slack=rev.slack)


def se_bbd_solve(analysis: AcStateEstimation, iteration: int = 40,
                 tolerance: float = 1e-8):
    se_bbd_refresh(analysis)
    lay = analysis._bbd_layout
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    vm, va, it, maxinc, converged = _se_bbd_solve(
        analysis._bbd, lay.k, lay.ni, lay.mb, lay.mr, lay.lb, vm, va,
        tolerance, iteration)
    analysis.voltage.magnitude = np.asarray(vm)
    analysis.voltage.angle = np.asarray(va)
    analysis.method.iteration = int(it)
    analysis.method.converged = bool(converged)
    analysis.method.max_increment = float(maxinc)
    return analysis
