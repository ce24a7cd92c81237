"""Structured (BBD/Schur) KKT solver for the AC OPF interior-point method.

The IPM's condensed augmented system

    [ W + J_Iᵀ Σ J_I + δI   J_Eᵀ   ] [ dx ]   [ rhs_x ]
    [ J_E                   -δc I  ] [ v  ] = [ rhs_e ]

was a DENSE (n_x + m_E)² build (opf/ipm.py step), which grows as the
square of the case size (the reference hands this exact system to Ipopt's
sparse MA27 factorization, acOptimalPowerFlow.jl:333). Every KKT entry is graph-local
to the power network: θ/V couple along Y-bus edges, Pg/Qg/epigraph
helpers attach to their generator's bus, each balance-row dual couples to
its bus's neighbors, and flow/angle-row fill-in (J_IᵀΣJ_I) rides branch
edges. So the KKT inherits the network's bordered-block-diagonal form,
and the same substrate that carries 10k-bus NR and SE (ops/partition
nd_partition + ops/bbd Schur solve) carries the OPF step:

  1. host side, once per model structure: enumerate every KKT
     contribution as a static COO position (~50 vectorized groups:
     polynomial-cost diagonals, the 15 polar balance-Hessian stencils per
     Y entry, 16-entry blocks per flow row, Σ-weighted products per
     inequality row, J_E scatter groups and their transposes), assign
     each augmented index to its owner bus, partition the bus graph, and
     route every COO entry to (interior block, border strip, border
     block) exactly like the NR BBD router (powerflow/newton_bbd.py);
  2. device side, per IPM iteration (inside the jitted step): compute the
     COO values (closed forms shared with the analytic Jacobian/Hessian),
     Jacobi-equilibrate in COO space, scatter-add into the padded block
     arrays, and run the vmapped mixed-precision Schur solve
     (f32 factorizations + f64 refinement, ops/bbd.py economics).

The dense and BBD paths are equivalence-tested element-exact on the
assembled matrix and end-to-end on solved cases (tests/test_opf_kkt.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..ops import linalg
from ..ops.bbd import BbdArrays, BbdLocalArrays, bbd_solve
from ..ops.partition import nd_partition


class AcKktBbd:
    """Structured KKT factory for one `_AcSpec` constraint layout.

    Built host-side once per model structure (cached on the analysis,
    keyed by the spec signature); ``solve`` is jax-traceable and called
    from inside the IPM's jitted step. Implements the NlpProblem.kkt
    protocol: ``solve(x, y, z, sigma, delta, rhs_x, rhs_e, pk)`` and
    ``row_maxes(x, p)``.
    """

    def __init__(self, spec, n_blocks: int, mesh=None,
                 mesh_axis: str = "block"):
        """``mesh``: optional jax.sharding.Mesh — interior KKT blocks then
        factor one-per-device over ``mesh_axis`` with the Schur reduction
        riding a psum across the mesh (ops/bbd.bbd_solve_sharded), the
        model-parallel axis for single-case OPF beyond one device's
        memory.
        Requires n_blocks == mesh axis size."""
        self.spec = spec
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None and mesh.shape[mesh_axis] != n_blocks:
            raise ValueError(
                f"n_blocks={n_blocks} must equal mesh axis "
                f"'{mesh_axis}' size {mesh.shape[mesh_axis]}")
        n, g = spec.n, spec.g
        self.n_x = spec.n_x
        self.m_e = spec.m_e
        self.m_i = spec.m_i
        n_aug = spec.n_x + spec.m_e
        self.n_aug = n_aug

        # ---- owner bus of every augmented index -------------------------
        owner = np.full(n_aug, -1, dtype=np.int64)
        gen_bus = np.asarray(spec.gen_bus)
        owner[:n] = np.arange(n)                      # theta
        owner[n:2 * n] = np.arange(n)                 # V
        owner[2 * n:2 * n + g] = gen_bus              # Pg
        owner[2 * n + g:2 * n + 2 * g] = gen_bus      # Qg
        off = 2 * n + 2 * g
        if spec.n_hp:
            owner[off:off + spec.n_hp] = gen_bus[np.asarray(spec.pw_gens_p)]
        off += spec.n_hp
        if spec.n_hq:
            owner[off:off + spec.n_hq] = gen_bus[np.asarray(spec.pw_gens_q)]
        # equality rows (emit order of _AcSpec.eq)
        nx = spec.n_x
        owner[nx:nx + n] = np.arange(n)               # P balance
        owner[nx + n:nx + 2 * n] = np.arange(n)       # Q balance
        owner[nx + 2 * n] = spec.slack                # slack angle row
        r = nx + 2 * n + 1
        k_off = len(spec.gen_off)
        if k_off:
            owner[r:r + k_off] = gen_bus[spec.gen_off]      # off Pg rows
            r += k_off
            owner[r:r + k_off] = gen_bus[spec.gen_off]      # off Qg rows
            r += k_off
        for idx, bus_of in ((spec.fixv_i, lambda i: i),
                            (spec.fixp_i, lambda i: gen_bus[i]),
                            (spec.fixq_i, lambda i: gen_bus[i])):
            if len(idx):
                owner[r:r + len(idx)] = bus_of(np.asarray(idx))
                r += len(idx)
        assert r == n_aug and (owner >= 0).all()
        self.owner = owner

        # ---- partition the bus graph, assign aug slots ------------------
        nodal = spec_pattern(spec, n)
        block_of, border = nd_partition(nodal, n_blocks)
        self.k = n_blocks
        is_border_bus = np.zeros(n, dtype=bool)
        is_border_bus[border] = True

        aug_blk = block_of[owner]                    # -1 for border buses
        groups = [np.flatnonzero(aug_blk == b) for b in range(n_blocks)]
        bdr = np.flatnonzero(aug_blk < 0)
        ni = max((len(gr) for gr in groups), default=1)
        mb = len(bdr)
        self.ni, self.mb = ni, mb
        aug_slot = np.zeros(n_aug, dtype=np.int64)
        for b, gr in enumerate(groups):
            aug_slot[gr] = np.arange(len(gr))
        aug_slot[bdr] = np.arange(mb)

        interior_idx = np.zeros((n_blocks, ni), dtype=np.int64)
        interior_mask = np.zeros((n_blocks, ni))
        for b, gr in enumerate(groups):
            interior_idx[b, :len(gr)] = gr
            interior_mask[b, :len(gr)] = 1.0
        self._interior_idx = jnp.asarray(interior_idx)
        self._interior_mask = jnp.asarray(interior_mask)
        self._border_idx = jnp.asarray(bdr)
        # identity tail on padded interior diagonal slots
        pad_b, pad_s = np.nonzero(interior_mask == 0.0)
        self._pad_blk = jnp.asarray(pad_b.astype(np.int32))
        self._pad_slot = jnp.asarray(pad_s.astype(np.int32))

        # ---- static COO structure (matches _values emit order) ----------
        rows, cols = self._structure()
        self.n_entries = len(rows)
        # entries whose owners sit in two different interiors can only be
        # structurally-zero Y positions (out-of-service branches kept in
        # the stored pattern); their values are identically zero, but the
        # scatter needs a valid destination — route them to the border
        # block at slot 0 (they add 0.0 there).
        br_ = aug_blk[rows]
        bc_ = aug_blk[cols]
        cross = (br_ >= 0) & (bc_ >= 0) & (br_ != bc_)
        self._cross = jnp.asarray(np.flatnonzero(cross).astype(np.int32))
        fam = np.where(cross, 3,
                       np.where((br_ >= 0) & (bc_ >= 0), 0,
                                np.where(br_ >= 0, 1,
                                         np.where(bc_ >= 0, 2, 3))))
        self._rows = jnp.asarray(rows.astype(np.int32))
        self._cols = jnp.asarray(cols.astype(np.int32))

        def sel(f):
            s = np.flatnonzero(fam == f)
            return s

        s_ii, s_ib, s_bi, s_bb = sel(0), sel(1), sel(2), sel(3)
        blk = np.where(aug_blk >= 0, aug_blk, 0)
        self._ii = tuple(jnp.asarray(a.astype(np.int32)) for a in (
            s_ii, blk[rows[s_ii]], aug_slot[rows[s_ii]],
            aug_slot[cols[s_ii]]))
        # ---- locality-compressed border couplings ----------------------
        # each block only touches the border slots on its own frontier;
        # the (k, ni, mb) global-width strips are the memory wall of the
        # 10k-bus OPF KKT (k*ni*mb grows ~n^1.5, k*ni*mbl ~n)
        ib_blk = blk[rows[s_ib]].astype(np.int64)
        ib_col = aug_slot[cols[s_ib]].astype(np.int64)
        bi_blk = blk[cols[s_bi]].astype(np.int64)
        bi_row = aug_slot[rows[s_bi]].astype(np.int64)
        pairs = np.unique(np.concatenate([
            np.stack([ib_blk, ib_col], axis=1),
            np.stack([bi_blk, bi_row], axis=1)]), axis=0)             if len(ib_blk) + len(bi_blk) else np.zeros((0, 2), np.int64)
        counts = np.bincount(pairs[:, 0], minlength=n_blocks)             if len(pairs) else np.zeros(n_blocks, dtype=np.int64)
        mbl = max(int(counts.max()) if len(pairs) else 1, 1)
        self.mbl = mbl
        loc_of = np.zeros((n_blocks, max(mb, 1)), dtype=np.int64)
        bsel = np.full((n_blocks, mbl), mb, dtype=np.int32)
        bmask = np.zeros((n_blocks, mbl))
        for b in range(n_blocks):
            qs = pairs[pairs[:, 0] == b, 1] if len(pairs)                 else np.zeros(0, np.int64)
            loc_of[b, qs] = np.arange(len(qs))
            bsel[b, :len(qs)] = qs
            bmask[b, :len(qs)] = 1.0
        self._bsel = jnp.asarray(bsel)
        self._bmask = jnp.asarray(bmask)
        self._ib = tuple(jnp.asarray(a.astype(np.int32)) for a in (
            s_ib, ib_blk, aug_slot[rows[s_ib]],
            loc_of[ib_blk, ib_col]))
        self._bi = tuple(jnp.asarray(a.astype(np.int32)) for a in (
            s_bi, bi_blk, loc_of[bi_blk, bi_row],
            aug_slot[cols[s_bi]]))
        # mesh (model-parallel) mode keeps the GLOBAL-width layout: the
        # per-device Schur reduction rides a psum over full border strips
        self._ib_g = tuple(jnp.asarray(a.astype(np.int32)) for a in (
            s_ib, ib_blk, aug_slot[rows[s_ib]], ib_col))
        self._bi_g = tuple(jnp.asarray(a.astype(np.int32)) for a in (
            s_bi, bi_blk, bi_row, aug_slot[cols[s_bi]]))
        # cross-interior structural zeros: dump at border (0, 0)
        bb_r = np.where(cross[s_bb], 0, aug_slot[rows[s_bb]])
        bb_c = np.where(cross[s_bb], 0, aug_slot[cols[s_bb]])
        self._bb = (jnp.asarray(s_bb.astype(np.int32)),
                    jnp.asarray(bb_r.astype(np.int32)),
                    jnp.asarray(bb_c.astype(np.int32)))

    # ------------------------------------------------------------------
    # COO structure: list of (rows, cols) per group, concatenated. The
    # emit order here and in _values must match exactly — both walk the
    # same group sequence guarded by the same len() tests.
    # ------------------------------------------------------------------

    def _group_seq_static(self):
        spec = self.spec
        n, g, nx = spec.n, spec.g, spec.n_x
        re = np.asarray(spec.rows, dtype=np.int64)
        ce = np.asarray(spec.cols, dtype=np.int64)
        ar = np.arange(n)
        out = []

        # --- W: polynomial cost diagonals
        for (kind, deg), idx in zip(spec.poly_keys, spec.poly_idx):
            if deg < 2:
                continue
            col0 = 2 * n if kind == "p" else 2 * n + g
            out.append((col0 + idx, col0 + idx))

        # --- W: balance Hessian stencils (15 groups, length nnz)
        ti, tj = re, ce
        vic, vjc = n + re, n + ce
        for pos in ((ti, ti), (tj, tj), (ti, tj), (tj, ti),
                    (ti, vic), (vic, ti), (ti, vjc), (vjc, ti),
                    (tj, vic), (vic, tj), (tj, vjc), (vjc, tj),
                    (vic, vjc), (vjc, vic), (vic, vic)):
            out.append(pos)

        # --- W: flow-row Hessian 4x4 blocks
        if len(spec.fl_k):
            fb, tb = spec.fl_fb, spec.fl_tb
            i4 = np.stack([fb, tb, n + fb, n + tb], axis=1)
            for a in range(4):
                for b in range(4):
                    out.append((i4[:, a], i4[:, b]))

        # --- W: J_I' Sigma J_I products
        br, bc, _bs = spec.ji_bound
        if len(br):
            out.append((bc, bc))
        if len(spec.cc_i):
            cp = 2 * n + spec.cc_i
            cq = 2 * n + g + spec.cc_i
            for pos in ((cp, cp), (cp, cq), (cq, cp), (cq, cq)):
                out.append(pos)
        if len(spec.fl_k):
            for mask in (spec.fl_has_lo, spec.fl_has_hi):
                if not mask.any():
                    continue
                i4m = i4[mask]
                for a in range(4):
                    for b in range(4):
                        out.append((i4m[:, a], i4m[:, b]))
        if len(spec.an_f):
            for pos in ((spec.an_f, spec.an_f), (spec.an_f, spec.an_t),
                        (spec.an_t, spec.an_f), (spec.an_t, spec.an_t)):
                out.append(pos)
        for cuts, pq0, h0 in ((spec.pwp, 2 * n, 2 * n + 2 * g),
                              (spec.pwq, 2 * n + g,
                               2 * n + 2 * g + spec.n_hp)):
            gi, hpos = cuts[0], cuts[1]
            if len(gi):
                cp = pq0 + gi
                ch = h0 + hpos
                for pos in ((cp, cp), (cp, ch), (ch, cp), (ch, ch)):
                    out.append(pos)

        # --- W: delta regularization diagonal (closes the W section)
        out.append((np.arange(nx), np.arange(nx)))
        self._n_w = sum(len(r) for r, _ in out)

        # --- J_E groups (emitted at (nx+row, col); _both adds transpose)
        def _both(row, col):
            out.append((nx + row, col))
            out.append((col, nx + row))

        _both(re, ce)            # P rows, theta cols (off-diag)
        _both(re, n + ce)        # P rows, V cols
        _both(ar, ar)            # P diag theta
        _both(ar, n + ar)        # P diag V
        _both(n + re, ce)        # Q rows, theta
        _both(n + re, n + ce)    # Q rows, V
        _both(n + ar, ar)
        _both(n + ar, n + ar)
        gb = np.asarray(spec.gen_bus, dtype=np.int64)
        _both(gb, 2 * n + np.arange(g))           # gen P columns
        _both(n + gb, 2 * n + g + np.arange(g))   # gen Q columns
        _both(np.asarray([2 * n]), np.asarray([spec.slack]))
        r = 2 * n + 1
        k_off = len(spec.gen_off)
        if k_off:
            _both(r + np.arange(k_off), 2 * n + spec.gen_off)
            r += k_off
            _both(r + np.arange(k_off), 2 * n + g + spec.gen_off)
            r += k_off
        for idx, col0 in ((spec.fixv_i, n), (spec.fixp_i, 2 * n),
                          (spec.fixq_i, 2 * n + g)):
            if len(idx):
                _both(r + np.arange(len(idx)), col0 + np.asarray(idx))
                r += len(idx)

        # --- equality diagonal regularization (-delta_c)
        out.append((nx + np.arange(spec.m_e), nx + np.arange(spec.m_e)))
        return out

    def _structure(self):
        groups = self._group_seq_static()  # also sets self._n_w
        rows = np.concatenate([np.asarray(r, dtype=np.int64)
                               for r, _ in groups])
        cols = np.concatenate([np.asarray(c, dtype=np.int64)
                               for _, c in groups])
        return rows, cols

    # ------------------------------------------------------------------
    # device-side values (same group order)
    # ------------------------------------------------------------------

    def _values(self, x, y_s, z_s, sigma, delta, pk):
        spec = self.spec
        n, g, nx = spec.n, spec.g, spec.n_x
        p = pk["p"]
        sf = pk["sf"]
        ge = pk.get("ge", jnp.ones(spec.m_e))
        gi = pk.get("gi", jnp.ones(spec.m_i)) if spec.m_i else jnp.zeros(0)
        y_raw = ge * y_s / sf
        z_raw = (gi * z_s / sf) if spec.m_i else jnp.zeros(0)
        sig_eff = (sigma * gi * gi) if spec.m_i else jnp.zeros(0)

        theta, v, pg, qg, hp, hq = spec.split(x)
        re_, ce_ = spec.rows, spec.cols
        vals = []

        # --- W: polynomial cost diagonals
        for (kind, deg), idx, co in zip(spec.poly_keys, spec.poly_idx,
                                        p.poly_co):
            if deg < 2:
                continue
            pq = pg[idx] if kind == "p" else qg[idx]
            acc = jnp.zeros_like(pq)
            for j in range(deg - 1):
                kk = deg - j
                acc = acc * pq + co[:, j] * kk * (kk - 1)
            vals.append(sf * acc)

        # --- W: balance Hessian stencils (mirror _AcSpec.hess)
        vi = v[re_]
        vj = v[ce_]
        th = theta[re_] - theta[ce_]
        ct = jnp.cos(th)
        st = jnp.sin(th)
        gc = p.yg * ct + p.yb * st
        gs = p.yg * st - p.yb * ct
        t1 = vi * vj * gc
        t2 = vi * vj * gs
        diag = np.asarray(re_) == np.asarray(ce_)
        offf = jnp.asarray((~diag).astype(np.float64))
        yp = y_raw[:n][re_] * offf
        yq = y_raw[n:2 * n][re_] * offf
        c_tt = -(yp * t1 + yq * t2)
        c_tivi = -yp * vj * gs + yq * vj * gc
        c_tivj = -yp * vi * gs + yq * vi * gc
        c_tjvi = yp * vj * gs - yq * vj * gc
        c_tjvj = yp * vi * gs - yq * vi * gc
        c_vv = yp * gc + yq * gs
        dsel = jnp.asarray(diag.astype(np.float64))
        c_dd = (y_raw[:n][re_] * 2.0 * p.yg
                - y_raw[n:2 * n][re_] * 2.0 * p.yb) * dsel
        for cvals in (c_tt, c_tt, -c_tt, -c_tt,
                      c_tivi, c_tivi, c_tivj, c_tivj,
                      c_tjvi, c_tjvi, c_tjvj, c_tjvj,
                      c_vv, c_vv, c_dd):
            vals.append(sf * cvals)

        # --- W: flow-row Hessians
        from .acopf import _flow_row_val
        if len(spec.fl_k):
            nf = len(spec.fl_k)
            wfl = jnp.zeros(nf)
            if len(spec.ji_fl_lo_rows):
                wfl = wfl.at[np.flatnonzero(spec.fl_has_lo)].add(
                    -z_raw[spec.ji_fl_lo_rows])
            if len(spec.ji_fl_hi_rows):
                wfl = wfl.at[np.flatnonzero(spec.fl_has_hi)].add(
                    z_raw[spec.ji_fl_hi_rows])
            fb, tb = spec.fl_fb, spec.fl_tb
            zrow = jnp.stack([theta[fb], theta[tb], v[fb], v[tb]], axis=1)
            h4 = jax.vmap(jax.hessian(_flow_row_val))(
                zrow, p.yff[spec.fl_k], p.yft[spec.fl_k],
                p.ytf[spec.fl_k], p.ytt[spec.fl_k],
                jnp.asarray(spec.fl_from), jnp.asarray(spec.fl_cls))
            for a in range(4):
                for b in range(4):
                    vals.append(sf * wfl * h4[:, a, b])

        # --- W: J_I' Sigma J_I
        br, _bc, _bs = spec.ji_bound
        if len(br):
            vals.append(sig_eff[br])
        if len(spec.cc_i):
            sc = sig_eff[spec.ji_cc_rows]
            vals.append(sc * p.cc_aq * p.cc_aq)
            vals.append(sc * p.cc_aq * p.cc_ap)
            vals.append(sc * p.cc_ap * p.cc_aq)
            vals.append(sc * p.cc_ap * p.cc_ap)
        if len(spec.fl_k):
            gz = spec._flow_grads(theta, v, p)
            for mask, rows_j in ((spec.fl_has_lo, spec.ji_fl_lo_rows),
                                 (spec.fl_has_hi, spec.ji_fl_hi_rows)):
                if not mask.any():
                    continue
                gm = gz[mask]
                sr = sig_eff[rows_j]
                for a in range(4):
                    for b in range(4):
                        vals.append(sr * gm[:, a] * gm[:, b])
        if len(spec.an_f):
            s_lo = sig_eff[spec.ji_an_lo_rows] + sig_eff[spec.ji_an_hi_rows]
            vals.append(s_lo)
            vals.append(-s_lo)
            vals.append(-s_lo)
            vals.append(s_lo)
        for cuts, rows_j, slope in ((spec.pwp, spec.ji_pwp_rows,
                                     p.pwp_slope),
                                    (spec.pwq, spec.ji_pwq_rows,
                                     p.pwq_slope)):
            if len(cuts[0]):
                sr = sig_eff[rows_j]
                vals.append(sr * slope * slope)
                vals.append(-sr * slope)
                vals.append(-sr * slope)
                vals.append(sr)

        # --- W: delta diagonal
        vals.append(jnp.full(nx, delta))

        # --- J_E values (each emitted twice: block and transpose)
        ar = np.arange(n)
        p_bus = jax.ops.segment_sum(t1, re_, num_segments=n)
        q_bus = jax.ops.segment_sum(t2, re_, num_segments=n)
        gii = jax.ops.segment_sum(jnp.where(jnp.asarray(diag), p.yg, 0.0),
                                  re_, num_segments=n)
        bii = jax.ops.segment_sum(jnp.where(jnp.asarray(diag), p.yb, 0.0),
                                  re_, num_segments=n)

        def _both(row_idx, v_):
            v_ = ge[row_idx] * v_
            vals.append(v_)
            vals.append(v_)

        _both(np.asarray(re_), -t2 * offf)
        _both(np.asarray(re_), -vi * gc * offf)
        _both(ar, q_bus + bii * v * v)
        _both(ar, -(p_bus / v + gii * v))
        _both(n + np.asarray(re_), t1 * offf)
        _both(n + np.asarray(re_), -vi * gs * offf)
        _both(n + ar, -(p_bus - gii * v * v))
        _both(n + ar, -(q_bus / v - bii * v))
        gb = np.asarray(spec.gen_bus, dtype=np.int64)
        on = jnp.asarray(spec.gen_on).astype(x.dtype)
        _both(gb, on)
        _both(n + gb, on)
        _both(np.asarray([2 * n]), jnp.ones(1))
        r = 2 * n + 1
        k_off = len(spec.gen_off)
        if k_off:
            _both(r + np.arange(k_off), jnp.ones(k_off))
            r += k_off
            _both(r + np.arange(k_off), jnp.ones(k_off))
            r += k_off
        for idx in (spec.fixv_i, spec.fixp_i, spec.fixq_i):
            if len(idx):
                _both(r + np.arange(len(idx)), jnp.ones(len(idx)))
                r += len(idx)

        # --- equality diagonal regularization
        vals.append(jnp.full(spec.m_e, -1e-10))

        out = jnp.concatenate(vals)
        assert out.shape[0] == self.n_entries, \
            (out.shape[0], self.n_entries)
        return out

    # ------------------------------------------------------------------
    # NlpProblem.kkt protocol
    # ------------------------------------------------------------------

    def _assemble(self, x, y_s, z_s, sigma, delta, pk, rhs_x, rhs_e):
        """COO values -> equilibrated padded block arrays + scaled rhs."""
        vals = self._values(x, y_s, z_s, sigma, delta, pk)
        # structurally-zero cross-interior entries: force exact zeros so
        # a live-edited value can never leak across interiors silently
        if self._cross.shape[0]:
            vals = vals.at[self._cross].set(0.0)
        rhs = jnp.concatenate([rhs_x, rhs_e])

        # Jacobi equilibration in COO space (same math as the dense path)
        rmax = jnp.zeros(self.n_aug).at[self._rows].max(jnp.abs(vals))
        d = 1.0 / jnp.sqrt(jnp.maximum(rmax, 1e-12))
        vals_s = vals * d[self._rows] * d[self._cols]
        rhs_s = rhs * d

        k, ni, mb = self.k, self.ni, self.mb
        a_ii = jnp.zeros((k, ni, ni))
        a_ii = a_ii.at[self._ii[1], self._ii[2], self._ii[3]].add(
            vals_s[self._ii[0]])
        a_ii = a_ii.at[self._pad_blk, self._pad_slot, self._pad_slot].add(
            1.0)
        a_bb = jnp.zeros((mb, mb))
        a_bb = a_bb.at[self._bb[1], self._bb[2]].add(vals_s[self._bb[0]])

        if self.mesh is not None:
            # mesh (model-parallel) mode: global-width strips — the
            # per-device Schur reduction psums full border contributions
            a_ib = jnp.zeros((k, ni, mb))
            a_ib = a_ib.at[self._ib_g[1], self._ib_g[2],
                           self._ib_g[3]].add(vals_s[self._ib_g[0]])
            a_bi = jnp.zeros((k, mb, ni))
            a_bi = a_bi.at[self._bi_g[1], self._bi_g[2],
                           self._bi_g[3]].add(vals_s[self._bi_g[0]])
            arr = BbdArrays(
                a_ii=a_ii, a_ib=a_ib, a_bi=a_bi, a_bb=a_bb,
                interior_idx=self._interior_idx,
                interior_mask=self._interior_mask,
                border_idx=self._border_idx)
        else:
            mbl = self.mbl
            a_ib = jnp.zeros((k, ni, mbl))
            a_ib = a_ib.at[self._ib[1], self._ib[2], self._ib[3]].add(
                vals_s[self._ib[0]])
            a_bi = jnp.zeros((k, mbl, ni))
            a_bi = a_bi.at[self._bi[1], self._bi[2], self._bi[3]].add(
                vals_s[self._bi[0]])
            arr = BbdLocalArrays(
                a_ii=a_ii, a_ib=a_ib, a_bi=a_bi, a_bb=a_bb,
                bsel=self._bsel, bmask=self._bmask,
                interior_idx=self._interior_idx,
                interior_mask=self._interior_mask,
                border_idx=self._border_idx)
        return vals, rhs, d, arr, rhs_s

    def _finish(self, vals, rhs, sol):
        """Unscaled residual check + curvature from the solved direction."""
        ax = jax.ops.segment_sum(vals * sol[self._cols], self._rows,
                                 num_segments=self.n_aug)
        lin_res = jnp.max(jnp.abs(ax - rhs)) / (1.0 + jnp.max(jnp.abs(rhs)))
        w_vals = vals[:self._n_w]
        w_rows = self._rows[:self._n_w]
        w_cols = self._cols[:self._n_w]
        curv = jnp.sum(w_vals * sol[w_rows] * sol[w_cols])
        return sol[:self.n_x], sol[self.n_x:], lin_res, curv

    def solve(self, x, y_s, z_s, sigma, delta, rhs_x, rhs_e, pk):
        """Solve the augmented system; returns (dx, v, lin_res, curv)
        with the same conventions as the dense step (v = -dy)."""
        vals, rhs, d, arr, rhs_s = self._assemble(
            x, y_s, z_s, sigma, delta, pk, rhs_x, rhs_e)
        if self.mesh is not None:
            from ..ops.bbd import bbd_solve_sharded
            sol = d * bbd_solve_sharded(self.mesh, arr, rhs_s,
                                        axis=self.mesh_axis)
        else:
            from ..ops.bbd import bbd_solve_local
            sol = d * bbd_solve_local(arr, rhs_s)
        return self._finish(vals, rhs, sol)

    def solve_f64(self, x, y_s, z_s, sigma, delta, rhs_x, rhs_e, pk):
        """Endgame variant: the same assembly, solved through the full-f64
        LU Schur path (ops/bbd.bbd_solve_f64) — the structured twin of
        linalg.solve_f64_sqd, used when the f32 factorization's backward
        error stalls the interior-point endgame.
        Runs unsharded even in mesh mode (the handful of endgame
        iterations value correctness over the model-parallel layout)."""
        vals, rhs, d, arr, rhs_s = self._assemble(
            x, y_s, z_s, sigma, delta, pk, rhs_x, rhs_e)
        if self.mesh is not None:
            from ..ops.bbd import bbd_solve_f64
            sol = d * bbd_solve_f64(arr, rhs_s)
        else:
            from ..ops.bbd import bbd_solve_local_f64
            sol = d * bbd_solve_local_f64(arr, rhs_s)
        return self._finish(vals, rhs, sol)

    def row_maxes(self, x, p):
        """Per-row max|J| of the RAW equality/inequality Jacobians at x,
        from the same closed forms — no dense (m, n_x) materialization
        (gradient-based scaling at 10k+ scale)."""
        spec = self.spec
        n = spec.n
        theta, v, pg, qg, hp, hq = spec.split(x)
        re_, ce_ = spec.rows, spec.cols
        vi = v[re_]
        vj = v[ce_]
        th = theta[re_] - theta[ce_]
        ct = jnp.cos(th)
        st = jnp.sin(th)
        gc = p.yg * ct + p.yb * st
        gs = p.yg * st - p.yb * ct
        t1 = vi * vj * gc
        t2 = vi * vj * gs
        diag = np.asarray(re_) == np.asarray(ce_)
        offf = jnp.asarray((~diag).astype(np.float64))
        p_bus = jax.ops.segment_sum(t1, re_, num_segments=n)
        q_bus = jax.ops.segment_sum(t2, re_, num_segments=n)
        gii = jax.ops.segment_sum(jnp.where(jnp.asarray(diag), p.yg, 0.0),
                                  re_, num_segments=n)
        bii = jax.ops.segment_sum(jnp.where(jnp.asarray(diag), p.yb, 0.0),
                                  re_, num_segments=n)
        rme = jnp.ones(spec.m_e)  # unit rows (slack/off/fix/gen cols)
        seg = lambda vv, rr: jax.ops.segment_max(  # noqa: E731
            jnp.abs(vv), rr, num_segments=spec.m_e)
        ar = np.arange(n)
        for rr, vv in (
                (np.asarray(re_), -t2 * offf),
                (np.asarray(re_), -vi * gc * offf),
                (ar, q_bus + bii * v * v),
                (ar, -(p_bus / v + gii * v)),
                (n + np.asarray(re_), t1 * offf),
                (n + np.asarray(re_), -vi * gs * offf),
                (n + ar, -(p_bus - gii * v * v)),
                (n + ar, -(q_bus / v - bii * v))):
            rme = jnp.maximum(rme, seg(vv, jnp.asarray(rr)))

        if not spec.m_i:
            return rme, jnp.zeros(0)
        rmi = jnp.ones(spec.m_i)
        if len(spec.cc_i):
            rmi = rmi.at[spec.ji_cc_rows].set(
                jnp.maximum(jnp.abs(p.cc_aq), jnp.abs(p.cc_ap)))
        if len(spec.fl_k):
            gz = spec._flow_grads(theta, v, p)
            gmax = jnp.max(jnp.abs(gz), axis=1)
            if len(spec.ji_fl_lo_rows):
                rmi = rmi.at[spec.ji_fl_lo_rows].set(gmax[spec.fl_has_lo])
            if len(spec.ji_fl_hi_rows):
                rmi = rmi.at[spec.ji_fl_hi_rows].set(gmax[spec.fl_has_hi])
        for cuts, rows_j, slope in ((spec.pwp, spec.ji_pwp_rows, "pwp"),
                                    (spec.pwq, spec.ji_pwq_rows, "pwq")):
            if len(cuts[0]):
                sl = p.pwp_slope if slope == "pwp" else p.pwq_slope
                rmi = rmi.at[rows_j].set(jnp.abs(sl))
        # floor at 1.0 everywhere: the gradient-based scale
        # min(1, 100/max) is unchanged for any true max in [floor, 100]
        return rme, jnp.maximum(rmi, 1.0)


def spec_pattern(spec, n):
    """Bus-graph pattern (CSR, ones) from the spec's stored Y entries."""
    r = np.asarray(spec.rows)
    c = np.asarray(spec.cols)
    pat = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    pat.sum_duplicates()
    pat.data[:] = 1.0
    return pat
