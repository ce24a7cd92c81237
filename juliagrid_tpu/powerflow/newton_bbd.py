"""Newton-Raphson power flow on the BBD/Schur substrate.

The plain NR path (powerflow/ac.py) builds one dense 2n x 2n Jacobian —
fine to ~3k buses, impossible at ACTIVSg/SyntheticUSA scale. Here the bus
graph is partitioned (ops/bbd.py BFS partition, border buses promoted so
no edge joins interiors of different blocks) and every Jacobian entry is
routed at compile time to its destination: a per-block interior matrix,
an interior-border coupling strip, or the border block. Each iteration:

  1. vectorized mismatch + per-entry H/N/J/L values (same closed forms as
     the dense path),
  2. four scatter-adds route the values into (k, 2ni, 2ni) interiors,
     (k, 2ni, 2mb) couplings, and the (2mb, 2mb) border,
  3. vmapped mixed-precision factorization of the interiors, Schur
     reduction of the border, back-substitution — O(k * ni^3 + mb^3)
     instead of O((2n)^3), and the interior factorizations shard over a
     ``block`` mesh axis for multi-chip single-case solves.

Variable layout: block k holds [θ then V] of its interior buses (padded to
the max block size); the border holds [θ then V] of border buses. Masking
(slack angle, non-PQ magnitudes) uses the same identity-row trick as the
dense path, applied family-wise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as scipy_sp

from ..ops import linalg
from ..ops.partition import nd_partition
from ..system.model import model
from ..system.types import PowerSystem
from .ac import (AcPowerFlow, MethodState, Polar, _injections, _mismatch,
                 compile_ac_arrays, initialize_ac_power_flow)


class NrBbdArrays(NamedTuple):
    # per-entry network data (same as AcArrays)
    rows: jax.Array
    cols: jax.Array
    yg: jax.Array
    yb: jax.Array
    diag: jax.Array
    bus_type: jax.Array
    slack: jax.Array
    p_sched: jax.Array
    q_sched: jax.Array
    # entry routing: per Y entry x 4 quadrants -> family arrays
    # family 0: interior-interior, 1: interior-border, 2: border-interior,
    # 3: border-border. One index set per family.
    ii_sel: jax.Array   # i32[e0] index into the 4*nnz quadrant value vector
    ii_blk: jax.Array   # i32[e0]
    ii_row: jax.Array
    ii_col: jax.Array
    ib_sel: jax.Array
    ib_blk: jax.Array
    ib_row: jax.Array
    ib_col: jax.Array
    bi_sel: jax.Array
    bi_blk: jax.Array
    bi_row: jax.Array
    bi_col: jax.Array
    bb_sel: jax.Array
    bb_row: jax.Array
    bb_col: jax.Array
    # rhs routing
    bus_block: jax.Array   # i32[n] block of bus (-1 border)
    bus_slot: jax.Array    # i32[n] local slot (interior) or border slot
    # masks in local layouts
    mask_int: jax.Array    # f64[k, 2ni]
    mask_bdr: jax.Array    # f64[2mb]
    # locality-compressed border: each block only couples to the border
    # buses on its own perimeter, so the coupling strips store 2*mbl
    # local columns instead of 2*mb global ones (the (k, ni, mb) arrays
    # are the device-memory wall of the 70k-class envelope: k*ni*mb grows
    # ~n^1.5 while k*ni*mbl grows ~n). bsel maps local border slots to global
    # ones (padded with 2*mb -> a dummy scatter target).
    bsel: jax.Array        # i32[k, 2mbl]
    bmask: jax.Array       # f64[k, 2mbl] 1 for real local slots
    n_blocks: int = 0      # static via shape, kept for clarity


@dataclass
class _BbdLayout:
    k: int
    ni: int
    mb: int
    mbl: int = 0


def compile_nr_bbd(system: PowerSystem, n_blocks: int):
    base = compile_ac_arrays(system)
    n = system.bus.number
    model(system, "ac")
    # Partition on the STORED pattern (including the structural zeros that
    # ac_model keeps for out-of-service branches) so every routed entry is
    # guaranteed same-block or border — an eliminate_zeros() copy would let
    # an off branch span two interiors and break the routing invariant.
    nodal = system.model.ac.nodal.tocsr()
    pattern = scipy_sp.csr_matrix(
        (np.ones(nodal.nnz), nodal.indices, nodal.indptr), shape=nodal.shape)
    block_of, border = nd_partition(pattern, n_blocks)
    k = n_blocks
    groups = [np.flatnonzero(block_of == b) for b in range(k)]
    ni = max(len(g) for g in groups)
    mb = len(border)

    bus_block = block_of.copy()
    bus_slot = np.zeros(n, dtype=np.int64)
    for b, g in enumerate(groups):
        for s, u in enumerate(g):
            bus_slot[u] = s
    for q, u in enumerate(border):
        bus_slot[u] = q

    from .ac import ac_entry_host
    rows, cols, vals_host, _diag = ac_entry_host(system)
    nnz = len(rows)

    # quadrant value vector layout: [H(nnz), N(nnz), J(nnz), L(nnz)]
    # variable local index: θ -> slot, V -> ni + slot (interior) or
    # mb + slot (border). Fully vectorized: the per-entry Python loop
    # cost minutes of host time at the 70k-class nnz (~4M quadrants).
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    yg_host = np.asarray(vals_host.real)
    yb_host = np.asarray(vals_host.imag)
    bb_i = bus_block[rows]
    bb_j = bus_block[cols]
    int_i = bb_i >= 0
    int_j = bb_j >= 0
    cross = int_i & int_j & (bb_i != bb_j)
    # only structurally-zero entries (off branches kept in the pattern)
    # may cross interiors; their H/N/J/L values are identically 0, so
    # dropping them is exact
    bad = cross & ~((rows != cols) & (yg_host == 0.0) & (yb_host == 0.0))
    if bad.any():
        raise RuntimeError(
            "BBD routing: nonzero entry couples two interiors")
    fam = np.where(cross, -1,
                   np.where(int_i & int_j, 0,
                            np.where(int_i, 1, np.where(int_j, 2, 3))))
    e_idx = np.arange(nnz, dtype=np.int64)
    sels, blks, lrows, lcols, fams = [], [], [], [], []
    for quad, (mi_, mj_) in enumerate(
            ((False, False), (False, True), (True, False), (True, True))):
        # quad order: H (P,θ), N (P,V), J (Q,θ), L (Q,V)
        ri = np.where(int_i, bus_slot[rows] + (ni if mi_ else 0),
                      bus_slot[rows] + (mb if mi_ else 0))
        cj = np.where(int_j, bus_slot[cols] + (ni if mj_ else 0),
                      bus_slot[cols] + (mb if mj_ else 0))
        sels.append(quad * nnz + e_idx)
        blks.append(np.where(int_i, bb_i, np.where(int_j, bb_j, 0)))
        lrows.append(ri)
        lcols.append(cj)
        fams.append(fam)
    sel_all = np.concatenate(sels)
    blk_all = np.concatenate(blks)
    row_all = np.concatenate(lrows)
    col_all = np.concatenate(lcols)
    fam_all = np.concatenate(fams)

    def pack(f):
        m = fam_all == f
        return (sel_all[m].astype(np.int32), blk_all[m].astype(np.int32),
                row_all[m].astype(np.int32), col_all[m].astype(np.int32))

    ii = pack(0)
    ib = pack(1)
    bi = pack(2)
    bb = pack(3)

    # ---- locality compression of the border couplings ----------------
    # per block: the set of border BUSES it actually touches (union of
    # its ib columns and bi rows); remap those vars to local slots
    mb_s = max(mb, 1)
    pairs = np.concatenate([
        np.stack([ib[1].astype(np.int64), ib[3].astype(np.int64) % mb_s],
                 axis=1),
        np.stack([bi[1].astype(np.int64), bi[2].astype(np.int64) % mb_s],
                 axis=1)]) if mb else np.zeros((0, 2), dtype=np.int64)
    uniq = np.unique(pairs, axis=0) if len(pairs) else pairs
    counts = np.bincount(uniq[:, 0], minlength=k) if len(uniq) \
        else np.zeros(k, dtype=np.int64)
    mbl = max(int(counts.max()) if len(uniq) else 1, 1)
    # global (block, border-bus) -> local slot, via a dense lookup table
    loc_of = np.zeros((k, mb_s), dtype=np.int64)
    bsel = np.full((k, 2 * mbl), 2 * mb, dtype=np.int32)
    bmask = np.zeros((k, 2 * mbl))
    off = 0
    for b in range(k):
        qs = uniq[uniq[:, 0] == b, 1] if len(uniq) else np.zeros(0, int)
        loc_of[b, qs] = np.arange(len(qs))
        bsel[b, :len(qs)] = qs
        bsel[b, mbl:mbl + len(qs)] = mb + qs
        bmask[b, :len(qs)] = 1.0
        bmask[b, mbl:mbl + len(qs)] = 1.0

    def to_local(blks, gvars):
        b64 = blks.astype(np.int64)
        g64 = gvars.astype(np.int64)
        q = g64 % mb_s
        return (loc_of[b64, q]
                + np.where(g64 >= mb, mbl, 0)).astype(np.int32)

    ib = (ib[0], ib[1], ib[2], to_local(ib[1], ib[3]))
    bi = (bi[0], bi[1], to_local(bi[1], bi[2]), bi[3])

    # masks: active angle vars (bus != slack), active magnitude (PQ)
    types = system.bus.layout.type.array[:n]
    slack = system.bus.layout.slack
    m_ang = (np.arange(n) != slack).astype(np.float64)
    m_mag = (types == 1).astype(np.float64)
    mask_int = np.zeros((k, 2 * ni))
    for b, g in enumerate(groups):
        for s, u in enumerate(g):
            mask_int[b, s] = m_ang[u]
            mask_int[b, ni + s] = m_mag[u]
    mask_bdr = np.zeros(2 * mb)
    for q, u in enumerate(border):
        mask_bdr[q] = m_ang[u]
        mask_bdr[mb + q] = m_mag[u]

    arr = NrBbdArrays(
        rows=base.rows, cols=base.cols, yg=base.yg, yb=base.yb,
        diag=base.diag, bus_type=base.bus_type, slack=base.slack,
        p_sched=base.p_sched, q_sched=base.q_sched,
        ii_sel=jnp.asarray(ii[0]), ii_blk=jnp.asarray(ii[1]),
        ii_row=jnp.asarray(ii[2]), ii_col=jnp.asarray(ii[3]),
        ib_sel=jnp.asarray(ib[0]), ib_blk=jnp.asarray(ib[1]),
        ib_row=jnp.asarray(ib[2]), ib_col=jnp.asarray(ib[3]),
        bi_sel=jnp.asarray(bi[0]), bi_blk=jnp.asarray(bi[1]),
        bi_row=jnp.asarray(bi[2]), bi_col=jnp.asarray(bi[3]),
        bb_sel=jnp.asarray(bb[0]), bb_row=jnp.asarray(bb[2]),
        bb_col=jnp.asarray(bb[3]),
        bus_block=jnp.asarray(bus_block.astype(np.int32)),
        bus_slot=jnp.asarray(bus_slot.astype(np.int32)),
        mask_int=jnp.asarray(mask_int),
        mask_bdr=jnp.asarray(mask_bdr),
        bsel=jnp.asarray(bsel),
        bmask=jnp.asarray(bmask),
    )
    return arr, _BbdLayout(k=k, ni=ni, mb=mb, mbl=mbl)


def _quadrant_values(arr: NrBbdArrays, vm, va):
    """Per-entry H/N/J/L values, concatenated (4*nnz,), plus injections."""
    n = vm.shape[0]
    p, q, _, _ = _injections(arr, vm, va)
    vi = vm[arr.rows]
    vj = vm[arr.cols]
    th = va[arr.rows] - va[arr.cols]
    sin_t = jnp.sin(th)
    cos_t = jnp.cos(th)
    gc_bs = arr.yg * cos_t + arr.yb * sin_t
    gs_bc = arr.yg * sin_t - arr.yb * cos_t

    off = arr.rows != arr.cols
    h = jnp.where(off, vi * vj * gs_bc, 0.0)
    nn = jnp.where(off, vi * gc_bs, 0.0)
    jj = jnp.where(off, -vi * vj * gc_bs, 0.0)
    ll = jnp.where(off, vi * gs_bc, 0.0)

    # diagonal corrections land on the diagonal entries of the pattern
    # (where the per-entry yg/yb ARE Gii/Bii)
    diag_mask = ~off
    i_of = arr.rows
    h = jnp.where(diag_mask, -q[i_of] - arr.yb * vm[i_of] ** 2, h)
    nn = jnp.where(diag_mask, p[i_of] / vm[i_of] + arr.yg * vm[i_of], nn)
    jj = jnp.where(diag_mask, p[i_of] - arr.yg * vm[i_of] ** 2, jj)
    ll = jnp.where(diag_mask, q[i_of] / vm[i_of] - arr.yb * vm[i_of], ll)

    vals = jnp.concatenate([h, nn, jj, ll])
    return vals, p, q


def _nr_bbd_step(arr: NrBbdArrays, layout: _BbdLayout, vm, va):
    n = vm.shape[0]
    k, ni, mb, mbl = layout.k, layout.ni, layout.mb, layout.mbl
    vals, p, q = _quadrant_values(arr, vm, va)

    not_slack = jnp.arange(n) != arr.slack
    is_pq = arr.bus_type == 1
    mp = jnp.where(not_slack, p - arr.p_sched, 0.0)
    mq = jnp.where(is_pq, q - arr.q_sched, 0.0)

    # route Jacobian values; coupling strips live in the LOCAL border
    # layout (2*mbl columns per block — see NrBbdArrays.bsel)
    a_ii = jnp.zeros((k, 2 * ni, 2 * ni), dtype=vm.dtype)
    a_ii = a_ii.at[arr.ii_blk, arr.ii_row, arr.ii_col].add(
        vals[arr.ii_sel])
    a_ib = jnp.zeros((k, 2 * ni, 2 * mbl), dtype=vm.dtype)
    a_ib = a_ib.at[arr.ib_blk, arr.ib_row, arr.ib_col].add(
        vals[arr.ib_sel])
    a_bi = jnp.zeros((k, 2 * mbl, 2 * ni), dtype=vm.dtype)
    a_bi = a_bi.at[arr.bi_blk, arr.bi_row, arr.bi_col].add(
        vals[arr.bi_sel])
    a_bb = jnp.zeros((2 * mb, 2 * mb), dtype=vm.dtype)
    a_bb = a_bb.at[arr.bb_row, arr.bb_col].add(vals[arr.bb_sel])

    # masking: inactive vars -> identity rows/cols (family-wise); the
    # border mask is gathered into each block's local slots
    mi = arr.mask_int
    mbd = arr.mask_bdr
    mbd_pad = jnp.concatenate([mbd, jnp.zeros(1, dtype=vm.dtype)])
    mloc = mbd_pad[arr.bsel] * arr.bmask          # (k, 2mbl)
    eye_i = jnp.eye(2 * ni, dtype=vm.dtype)
    a_ii = mi[:, :, None] * a_ii * mi[:, None, :] \
        + eye_i[None] * (1.0 - mi)[:, :, None]
    a_ib = mi[:, :, None] * a_ib * mloc[:, None, :]
    a_bi = mloc[:, :, None] * a_bi * mi[:, None, :]
    a_bb = mbd[:, None] * a_bb * mbd[None, :] + jnp.diag(1.0 - mbd)

    # rhs routed to local layouts
    rhs_p = mp
    rhs_q = mq
    interior = arr.bus_block >= 0
    r_int = jnp.zeros((k, 2 * ni), dtype=vm.dtype)
    blk_safe = jnp.where(interior, arr.bus_block, 0)
    r_int = r_int.at[blk_safe, arr.bus_slot].add(
        jnp.where(interior, rhs_p, 0.0))
    r_int = r_int.at[blk_safe, ni + arr.bus_slot].add(
        jnp.where(interior, rhs_q, 0.0))
    r_bdr = jnp.zeros(2 * mb, dtype=vm.dtype)
    r_bdr = r_bdr.at[arr.bus_slot].add(jnp.where(interior, 0.0, rhs_p))
    r_bdr = r_bdr.at[mb + arr.bus_slot].add(jnp.where(interior, 0.0, rhs_q))
    r_int = r_int * mi
    r_bdr = r_bdr * mbd

    # Schur solve: per-block (2mbl)^2 contributions scatter-add into the
    # global border system (padded dummy row/col absorbs masked slots)
    y, z = linalg.batched_lu_solve2(a_ii, r_int, a_ib)
    contrib = a_bi @ z                             # (k, 2mbl, 2mbl)
    s_pad = jnp.zeros((2 * mb + 1, 2 * mb + 1), dtype=vm.dtype)
    s_pad = s_pad.at[arr.bsel[:, :, None], arr.bsel[:, None, :]].add(
        -contrib)
    schur = a_bb + s_pad[:2 * mb, :2 * mb]
    rhs_part = jnp.einsum("kmi,ki->km", a_bi, y)   # (k, 2mbl)
    r_red = jnp.zeros(2 * mb + 1, dtype=vm.dtype).at[arr.bsel].add(
        rhs_part)
    rhs_b = r_bdr - r_red[:2 * mb]
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_b)
    x_b_pad = jnp.concatenate([x_b, jnp.zeros(1, dtype=vm.dtype)])
    x_loc = x_b_pad[arr.bsel] * arr.bmask          # (k, 2mbl)
    x_i = y - jnp.einsum("kim,km->ki", z, x_loc)

    # gather increments back to global (θ, V)
    d_ang = jnp.where(
        interior,
        x_i[blk_safe, arr.bus_slot],
        x_b[arr.bus_slot])
    d_mag = jnp.where(
        interior,
        x_i[blk_safe, ni + arr.bus_slot],
        x_b[mb + arr.bus_slot])

    va_new = va - jnp.where(not_slack, d_ang, 0.0)
    vm_new = vm - jnp.where(is_pq, d_mag, 0.0)
    return vm_new, va_new


@partial(jax.jit, static_argnames=("k", "ni", "mb", "mbl", "max_iter"))
def _nr_bbd_solve(arr: NrBbdArrays, k, ni, mb, mbl, vm, va, tol, max_iter):
    layout = _BbdLayout(k=k, ni=ni, mb=mb, mbl=mbl)
    mp, mq, del_p, del_q = _mismatch(arr, vm, va)

    def cond(carry):
        vm, va, it, del_p, del_q = carry
        return (~((del_p < tol) & (del_q < tol))) & (it < max_iter)

    def body(carry):
        vm, va, it, _, _ = carry
        vm, va = _nr_bbd_step(arr, layout, vm, va)
        _, _, del_p, del_q = _mismatch(arr, vm, va)
        return vm, va, it + 1, del_p, del_q

    vm, va, it, del_p, del_q = jax.lax.while_loop(
        cond, body, (vm, va, jnp.int64(0), del_p, del_q))
    return vm, va, it, del_p, del_q, (del_p < tol) & (del_q < tol)


def newton_raphson_bbd(system: PowerSystem, n_blocks: int = 4) -> AcPowerFlow:
    """NR power flow with the BBD/Schur linear-solver substrate."""
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays, layout = compile_nr_bbd(system, n_blocks)
    rev = system.model.revision
    analysis = AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState("newton_raphson_bbd"),
        arrays=arrays,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )
    analysis._bbd_layout = layout
    analysis._bbd_n_blocks = n_blocks
    return analysis


def power_flow_bbd(analysis: AcPowerFlow, iteration: int = 20,
                   tolerance: float = 1e-8):
    """Driver for the BBD NR analysis."""
    analysis._refresh_arrays()
    layout = analysis._bbd_layout
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    vm, va, it, del_p, del_q, conv = _nr_bbd_solve(
        analysis.arrays, layout.k, layout.ni, layout.mb, layout.mbl,
        vm, va, tolerance, iteration)
    analysis.voltage.magnitude = np.asarray(vm)
    analysis.voltage.angle = np.asarray(va)
    analysis.method.iteration = int(it)
    analysis.method.converged = bool(conv)
    analysis.method.max_mismatch_active = float(del_p)
    analysis.method.max_mismatch_reactive = float(del_q)
    return analysis
