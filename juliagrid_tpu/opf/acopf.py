"""AC optimal power flow on the in-house interior-point solver.

Model parity with /root/reference/src/optimalPowerFlow/acOptimalPowerFlow.jl:
variables V (bounded), θ (slack fixed), Pg/Qg (capability boxes,
out-of-service fixed at 0), piecewise epigraph helpers for both power kinds
(:436-484); nonlinear bus balance from the Y-bus pattern (:517-567);
trapezoidal P-Q capability-curve cuts (:570-627); flow limits with the
reference's type dispatch — 1 active power, 2/3 apparent (3 squared), 4/5
current magnitude (5 squared), with limit clamping and skip rules
(checkLimit, :695-703); angle-difference constraints (:495-514); objective
= full polynomial costs (quadratic + monomial tails, utility.jl:473-523)
plus piecewise affine/epigraph terms, for active and reactive costs.

The whole model is three pure JAX functions (objective/eq/ineq) over a flat
state vector — autodiff supplies exact Jacobians and the Lagrangian
Hessian to the IPM (opf/ipm.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..postprocessing.results import AcPower, Cartesian
from ..powerflow.ac import Polar
from ..system.model import model
from ..system.types import PowerSystem
from .dcopf import OpfMethod
from .ipm import NlpProblem, solve_nlp


@dataclass
class AcOptimalPowerFlow:
    system: PowerSystem
    voltage: Polar
    power: AcPower
    method: OpfMethod
    current: Optional[object] = None
    kind: str = "optimal_power_flow"
    _spec: Optional[object] = None
    _x0: Optional[np.ndarray] = None
    signature: dict = None

    def _refresh_spec(self):
        """Rebuild when the system moved past the captured revision
        (reference acOptimalPowerFlow.jl:275-283)."""
        rev = self.system.model.revision
        key = (rev.ac_model, rev.ac_pattern, rev.ac_optimization,
               rev.injection, rev.slack, rev.type)
        if self.signature != {"key": key}:
            from ..system.model import model as _model
            _model(self.system, "ac")
            old = self._spec
            self._spec = _AcSpec(self.system)
            if old is not None and old.n_x != self._spec.n_x:
                self._x0 = None
            if self._x0 is None:
                set_initial_point(self)
            else:
                # warm restart after a model edit: the carried iterate is
                # a previous OPTIMUM, sitting exactly on its active bounds
                # — slacks at zero pin every fraction-to-boundary step of
                # the re-solve. Push it strictly inside (Ipopt's
                # warm_start_bound_push) and re-seat the epigraph helpers
                # for the (possibly changed) cost curves.
                self._x0 = np.array(self._x0)  # res.x views are read-only
                self._spec.push_inside(self._x0)
                if self._spec.n_hp or self._spec.n_hq:
                    self._spec.init_helpers(self._x0)
            self.signature = {"key": key}


class AcParams(NamedTuple):
    """Numeric model data threaded through the IPM as a runtime pytree.

    Everything a live edit can change without altering the constraint
    *structure* lives here (bounds, cost coefficients, demands, Y-bus
    values, flow/angle limits); the structure (index arrays, masks, row
    counts) stays baked into the trace. Editing a field re-solves against
    the same compiled step functions — the analogue of the reference
    patching its live JuMP model (optimalPowerFlow/utility.jl:525-700)
    instead of rebuilding it.
    """

    yg: object          # Y-bus entry values (pattern static)
    yb: object
    pd: object          # bus demand
    qd: object
    slack_angle: object
    fixv_b: object      # fixed-variable values (equality rows)
    fixp_b: object
    fixq_b: object
    vlo_b: object       # simple-bound values
    vhi_b: object
    plo_b: object
    phi_b: object
    qlo_b: object
    qhi_b: object
    cc_aq: object       # capability-curve cut coefficients
    cc_ap: object
    cc_b: object
    fl_lo: object       # flow limits (already squared where applicable)
    fl_hi: object
    an_lo: object       # angle-difference limits
    an_hi: object
    yff: object         # branch two-port admittances for flow expressions,
    yft: object         # stored as (k, 2) [real, imag] f64 stacks so the
    ytf: object         # flow expressions stay in all-real arithmetic
    ytt: object
    pwp_slope: object   # piecewise epigraph cut data
    pwp_icept: object
    pwq_slope: object
    pwq_icept: object
    poly_co: object     # tuple of cost-coefficient arrays, one per group
    obj_const: object


class _AcSpec:
    def __init__(self, system: PowerSystem):
        model(system, "ac")
        n = system.bus.number
        g = system.generator.number
        bus = system.bus
        gen = system.generator
        self.n, self.g = n, g
        self.slack = bus.layout.slack
        self.slack_angle = float(bus.voltage.angle[self.slack])

        coo = system.model.ac.nodal.tocoo()
        order = np.lexsort((coo.col, coo.row))
        self.rows = jnp.asarray(coo.row[order].astype(np.int32))
        self.cols = jnp.asarray(coo.col[order].astype(np.int32))
        self.yg = np.asarray(coo.data[order].real)
        self.yb = np.asarray(coo.data[order].imag)

        self.pd = np.asarray(bus.demand.active.array[:n]).copy()
        self.qd = np.asarray(bus.demand.reactive.array[:n]).copy()
        self.gen_bus = jnp.asarray(gen.layout.bus.array[:g].astype(np.int32))
        self.gen_on = gen.layout.status.array[:g] == 1

        # ---- objective ---------------------------------------------------
        self.poly_terms = []       # (kind 'p'|'q', gen idx, coeff array)
        self.pw_cuts_p = []        # (gen, helper pos, slope, intercept)
        self.pw_cuts_q = []
        self.pw_gens_p = []
        self.pw_gens_q = []
        self.obj_const = 0.0

        for kind, cost, pw_gens, pw_cuts in (
                ("p", gen.cost.active, self.pw_gens_p, self.pw_cuts_p),
                ("q", gen.cost.reactive, self.pw_gens_q, self.pw_cuts_q)):
            for i in range(g):
                if not self.gen_on[i]:
                    continue
                cmodel = int(cost.model[i]) if i < len(cost.model) else 0
                if cmodel == 2 and i in cost.polynomial:
                    self.poly_terms.append(
                        (kind, i,
                         np.asarray(cost.polynomial[i], dtype=float)))
                elif cmodel == 1 and i in cost.piecewise:
                    pts = np.asarray(cost.piecewise[i])
                    if len(pts) == 2:
                        slope = ((pts[1, 1] - pts[0, 1])
                                 / (pts[1, 0] - pts[0, 0]))
                        icept = pts[0, 1] - pts[0, 0] * slope
                        self.poly_terms.append(
                            (kind, i, np.asarray([slope, icept])))
                    elif len(pts) > 2:
                        hpos = len(pw_gens)
                        pw_gens.append(i)
                        for k in range(1, len(pts)):
                            slope = ((pts[k, 1] - pts[k - 1, 1])
                                     / (pts[k, 0] - pts[k - 1, 0]))
                            if not np.isfinite(slope):
                                raise ValueError(
                                    "piecewise cost has infinite slope")
                            pw_cuts.append(
                                (i, hpos, slope,
                                 slope * pts[k - 1, 0] - pts[k - 1, 1]))
                    else:
                        raise ValueError(
                            "piecewise cost requires at least two points")

        self.n_hp = len(self.pw_gens_p)
        self.n_hq = len(self.pw_gens_q)
        self.n_x = 2 * n + 2 * g + self.n_hp + self.n_hq

        # ---- inequality bookkeeping -------------------------------------
        self.ineq_tags = []
        vmin = bus.voltage.min_magnitude.array[:n]
        vmax = bus.voltage.max_magnitude.array[:n]
        self.fix_v = [(i, float(vmin[i])) for i in range(n)
                      if np.isfinite(vmin[i]) and vmin[i] == vmax[i]]
        fixed_v = {i for i, _ in self.fix_v}
        self.v_lo = [(i, float(vmin[i])) for i in range(n)
                     if np.isfinite(vmin[i]) and i not in fixed_v]
        self.v_hi = [(i, float(vmax[i])) for i in range(n)
                     if np.isfinite(vmax[i]) and i not in fixed_v]
        for i, _ in self.v_lo:
            self.ineq_tags.append(("voltage_min", i))
        for i, _ in self.v_hi:
            self.ineq_tags.append(("voltage_max", i))

        cap = gen.capability
        self.p_lo, self.p_hi, self.q_lo, self.q_hi = [], [], [], []
        # lo == hi boxes are fixed outputs: two opposing inequalities can
        # never both hold strictly (their barrier slacks would have to sum
        # to zero), so they become equality rows — JuMP's fixed-variable
        # treatment for the same situation (Ipopt make_parameter)
        self.fix_p, self.fix_q = [], []
        for i in range(g):
            if not self.gen_on[i]:
                continue
            for lo_store, hi_store, fix_store, lo, hi, kindtag in (
                    (self.p_lo, self.p_hi, self.fix_p,
                     cap.min_active[i], cap.max_active[i], "active"),
                    (self.q_lo, self.q_hi, self.fix_q,
                     cap.min_reactive[i], cap.max_reactive[i], "reactive")):
                if np.isfinite(lo) and lo == hi:
                    fix_store.append((i, float(lo)))
                    continue
                if np.isfinite(lo):
                    lo_store.append((i, float(lo)))
                    self.ineq_tags.append((f"{kindtag}_min", i))
                if np.isfinite(hi):
                    hi_store.append((i, float(hi)))
                    self.ineq_tags.append((f"{kindtag}_max", i))

        # capability-curve cuts (reference capabilityCurve, :570-627)
        self.curve_cuts = []
        self.curve_tags = []
        for i in range(g):
            if not self.gen_on[i]:
                continue
            low, up = cap.low_active[i], cap.up_active[i]
            if (low == 0.0 and up == 0.0) or low == up:
                continue
            if low >= up or cap.max_low_reactive[i] <= \
                    cap.min_low_reactive[i] or cap.max_up_reactive[i] <= \
                    cap.min_up_reactive[i]:
                raise ValueError("Capability curve is not correctly defined.")
            diff_p_inv = 1.0 / (up - low)
            min_low_p = cap.min_active[i] - low
            max_low_p = cap.max_active[i] - low

            diff_q = cap.max_up_reactive[i] - cap.max_low_reactive[i]
            max_q_min_p = cap.max_low_reactive[i] + min_low_p * diff_q \
                * diff_p_inv
            max_q_max_p = cap.max_low_reactive[i] + max_low_p * diff_q \
                * diff_p_inv
            if max_q_min_p < cap.max_reactive[i] \
                    or max_q_max_p < cap.max_reactive[i]:
                dq = cap.max_low_reactive[i] - cap.max_up_reactive[i]
                dp = up - low
                b = dq * low + dp * cap.max_low_reactive[i]
                scale = 1.0 / np.sqrt(dq**2 + dp**2)
                self.curve_cuts.append((i, scale * dq, scale * dp, scale * b))
                self.curve_tags.append((i, "capability_upper"))

            diff_q = cap.min_up_reactive[i] - cap.min_low_reactive[i]
            min_q_min_p = cap.min_low_reactive[i] + min_low_p * diff_q \
                * diff_p_inv
            min_q_max_p = cap.min_low_reactive[i] + max_low_p * diff_q \
                * diff_p_inv
            if min_q_min_p > cap.min_reactive[i] \
                    or min_q_max_p > cap.min_reactive[i]:
                dq = cap.min_up_reactive[i] - cap.min_low_reactive[i]
                dp = low - up
                b = dq * low + dp * cap.min_low_reactive[i]
                scale = 1.0 / np.sqrt(dq**2 + dp**2)
                self.curve_cuts.append((i, scale * dq, scale * dp, scale * b))
                self.curve_tags.append((i, "capability_lower"))

        # flow constraints (from/to, type dispatch)
        m = system.branch.number
        br = system.branch
        ac = system.model.ac
        self.flows = []
        for k in range(m):
            if br.layout.status[k] != 1:
                continue
            ftype = int(br.flow.type[k]) if len(br.flow.type) else 3
            sq = 2 if ftype in (3, 5) else 1
            for side, lo, hi in (
                    ("from", br.flow.min_from_bus[k], br.flow.max_from_bus[k]),
                    ("to", br.flow.min_to_bus[k], br.flow.max_to_bus[k])):
                lo, hi = float(lo), float(hi)
                if ftype != 1:
                    lo, hi = max(lo, 0.0), max(hi, 0.0)
                if (lo == 0.0 and hi == 0.0) or (np.isinf(lo)
                                                 and np.isinf(hi)):
                    continue
                lo_c, hi_c = lo ** sq, hi ** sq
                fb, tb = int(br.layout.from_bus[k]), int(br.layout.to_bus[k])
                self.flows.append((k, side, ftype, fb, tb, lo_c, hi_c))
                if np.isfinite(lo_c) and not (ftype != 1 and lo == 0.0):
                    self.ineq_tags.append((f"flow_{side}_min", k))
                if np.isfinite(hi_c):
                    self.ineq_tags.append((f"flow_{side}_max", k))

        self.angles = []
        two_pi = 2 * np.pi
        for k in range(m):
            if br.layout.status[k] != 1:
                continue
            lo = float(br.voltage.min_diff_angle[k]) if len(
                br.voltage.min_diff_angle) else -two_pi
            hi = float(br.voltage.max_diff_angle[k]) if len(
                br.voltage.max_diff_angle) else two_pi
            meaningful = ((np.isfinite(lo) and lo not in (0.0, -two_pi))
                          or (np.isfinite(hi) and hi not in (0.0, two_pi)))
            if meaningful:
                self.angles.append(
                    (int(br.layout.from_bus[k]), int(br.layout.to_bus[k]),
                     lo, hi, k))
                self.ineq_tags.append(("angle_min", k))
                self.ineq_tags.append(("angle_max", k))

        for (gi, *_rest) in self.pw_cuts_p:
            self.ineq_tags.append(("piecewise_active", gi))
        for (gi, *_rest) in self.pw_cuts_q:
            self.ineq_tags.append(("piecewise_reactive", gi))

        # branch two-port params for flow expressions
        self.br_yff = ac.nodal_from_from
        self.br_yft = ac.nodal_from_to
        self.br_ytf = ac.nodal_to_from
        self.br_ytt = ac.nodal_to_to

        self._finalize()

    def _finalize(self):
        """Re-derive the vectorized constraint arrays, tag list, and
        params pytree from the bookkeeping lists. Called at build time
        and after structural live edits (opf/edit.py) -- O(constraints)
        numpy work, no system scan."""
        # ---- vectorized constraint arrays (traced fns must be loop-free:
        # a per-element Python ineq() at pegase scale produces a ~10k-op
        # XLA graph whose compile blows up) -------------------------------
        def _pairs(lst):
            idx = np.asarray([i for i, _ in lst], dtype=np.int64)
            val = np.asarray([b for _, b in lst], dtype=np.float64)
            return idx, val

        self.vlo_i, self.vlo_b = _pairs(self.v_lo)
        self.vhi_i, self.vhi_b = _pairs(self.v_hi)
        self.fixv_i, self.fixv_b = _pairs(self.fix_v)
        self.fixp_i, self.fixp_b = _pairs(self.fix_p)
        self.fixq_i, self.fixq_b = _pairs(self.fix_q)
        self.plo_i, self.plo_b = _pairs(self.p_lo)
        self.phi_i, self.phi_b = _pairs(self.p_hi)
        self.qlo_i, self.qlo_b = _pairs(self.q_lo)
        self.qhi_i, self.qhi_b = _pairs(self.q_hi)
        cc = self.curve_cuts
        self.cc_i = np.asarray([c[0] for c in cc], dtype=np.int64)
        self.cc_aq = np.asarray([c[1] for c in cc])
        self.cc_ap = np.asarray([c[2] for c in cc])
        self.cc_b = np.asarray([c[3] for c in cc])

        fl = self.flows
        self.fl_k = np.asarray([f[0] for f in fl], dtype=np.int64)
        self.fl_from = np.asarray([f[1] == "from" for f in fl])
        self.fl_fb = np.asarray([f[3] for f in fl], dtype=np.int64)
        self.fl_tb = np.asarray([f[4] for f in fl], dtype=np.int64)
        self.fl_cls = np.asarray([f[2] for f in fl], dtype=np.int64)
        fl_lo = np.asarray([f[5] for f in fl], dtype=np.float64)
        fl_hi = np.asarray([f[6] for f in fl], dtype=np.float64)
        self.fl_has_lo = np.asarray(
            [np.isfinite(f[5]) and not (f[2] != 1 and f[5] == 0.0)
             for f in fl])
        self.fl_has_hi = np.isfinite(fl_hi)
        self.fl_lo = np.where(self.fl_has_lo, fl_lo, 0.0)
        self.fl_hi = np.where(self.fl_has_hi, fl_hi, 0.0)

        an = self.angles
        self.an_f = np.asarray([a[0] for a in an], dtype=np.int64)
        self.an_t = np.asarray([a[1] for a in an], dtype=np.int64)
        self.an_lo = np.asarray([a[2] for a in an])
        self.an_hi = np.asarray([a[3] for a in an])

        def _cuts(cuts):
            gi = np.asarray([c[0] for c in cuts], dtype=np.int64)
            hpos = np.asarray([c[1] for c in cuts], dtype=np.int64)
            slope = np.asarray([c[2] for c in cuts])
            icept = np.asarray([c[3] for c in cuts])
            return gi, hpos, slope, icept

        self.pwp = _cuts(self.pw_cuts_p)
        self.pwq = _cuts(self.pw_cuts_q)

        # polynomial objective grouped by (kind, degree) for vector polyval
        self.poly_groups = {}
        for kind, i, coeffs in self.poly_terms:
            key = (kind, len(coeffs) - 1)
            self.poly_groups.setdefault(key, ([], []))
            self.poly_groups[key][0].append(i)
            self.poly_groups[key][1].append(coeffs)
        self.poly_groups = {
            key: (np.asarray(idx, dtype=np.int64), np.asarray(co))
            for key, (idx, co) in self.poly_groups.items()}
        self.poly_keys = list(self.poly_groups.keys())
        self.poly_idx = [self.poly_groups[k][0] for k in self.poly_keys]
        self.poly_co = [self.poly_groups[k][1] for k in self.poly_keys]

        # rebuild the tag list in the grouped emit order of ineq()
        tags = []
        tags += [("voltage_min", int(i)) for i in self.vlo_i]
        tags += [("voltage_max", int(i)) for i in self.vhi_i]
        tags += [("active_min", int(i)) for i in self.plo_i]
        tags += [("active_max", int(i)) for i in self.phi_i]
        tags += [("reactive_min", int(i)) for i in self.qlo_i]
        tags += [("reactive_max", int(i)) for i in self.qhi_i]
        tags += [(t, int(i)) for (i, t) in self.curve_tags]
        for k, f, has in zip(self.fl_k, self.fl_from, self.fl_has_lo):
            if has:
                tags.append((f"flow_{'from' if f else 'to'}_min", int(k)))
        for k, f, has in zip(self.fl_k, self.fl_from, self.fl_has_hi):
            if has:
                tags.append((f"flow_{'from' if f else 'to'}_max", int(k)))
        tags += [("angle_min", a[4]) for a in an]
        tags += [("angle_max", a[4]) for a in an]
        tags += [("piecewise_active", int(gi)) for gi in self.pwp[0]]
        tags += [("piecewise_reactive", int(gi)) for gi in self.pwq[0]]
        self.ineq_tags = tags

        # ---- static scatter patterns for the analytic Jacobians ---------
        # (row offsets mirror the emit order of eq()/ineq() exactly;
        # empty blocks contribute zero rows, same as the concat)
        n, g = self.n, self.g
        self.gen_off = np.flatnonzero(~self.gen_on)
        self.m_e = (2 * n + 1 + 2 * len(self.gen_off) + len(self.fixv_i)
                    + len(self.fixp_i) + len(self.fixq_i))
        r = 0
        jb_rows, jb_cols, jb_sign = [], [], []
        for cols, sgn in ((n + self.vlo_i, 1.0), (n + self.vhi_i, -1.0),
                          (2 * n + self.plo_i, 1.0),
                          (2 * n + self.phi_i, -1.0),
                          (2 * n + g + self.qlo_i, 1.0),
                          (2 * n + g + self.qhi_i, -1.0)):
            k = len(cols)
            jb_rows.append(np.arange(r, r + k))
            jb_cols.append(np.asarray(cols, dtype=np.int64))
            jb_sign.append(np.full(k, sgn))
            r += k
        self.ji_bound = (np.concatenate(jb_rows),
                         np.concatenate(jb_cols),
                         np.concatenate(jb_sign))
        self.ji_cc_rows = np.arange(r, r + len(self.cc_i))
        r += len(self.cc_i)
        k_lo = int(self.fl_has_lo.sum()) if len(self.fl_k) else 0
        k_hi = int(self.fl_has_hi.sum()) if len(self.fl_k) else 0
        self.ji_fl_lo_rows = np.arange(r, r + k_lo)
        r += k_lo
        self.ji_fl_hi_rows = np.arange(r, r + k_hi)
        r += k_hi
        k_an = len(self.an_f)
        self.ji_an_lo_rows = np.arange(r, r + k_an)
        r += k_an
        self.ji_an_hi_rows = np.arange(r, r + k_an)
        r += k_an
        self.ji_pwp_rows = np.arange(r, r + len(self.pwp[0]))
        r += len(self.pwp[0])
        self.ji_pwq_rows = np.arange(r, r + len(self.pwq[0]))
        r += len(self.pwq[0])
        self.m_i = r

        self.params = self._make_params()

    def _make_params(self) -> AcParams:
        j = jnp.asarray
        return AcParams(
            yg=j(self.yg), yb=j(self.yb), pd=j(self.pd), qd=j(self.qd),
            slack_angle=j(self.slack_angle),
            fixv_b=j(self.fixv_b), fixp_b=j(self.fixp_b),
            fixq_b=j(self.fixq_b),
            vlo_b=j(self.vlo_b), vhi_b=j(self.vhi_b),
            plo_b=j(self.plo_b), phi_b=j(self.phi_b),
            qlo_b=j(self.qlo_b), qhi_b=j(self.qhi_b),
            cc_aq=j(self.cc_aq), cc_ap=j(self.cc_ap), cc_b=j(self.cc_b),
            fl_lo=j(self.fl_lo), fl_hi=j(self.fl_hi),
            an_lo=j(self.an_lo), an_hi=j(self.an_hi),
            yff=j(np.stack([self.br_yff.real, self.br_yff.imag], axis=-1)),
            yft=j(np.stack([self.br_yft.real, self.br_yft.imag], axis=-1)),
            ytf=j(np.stack([self.br_ytf.real, self.br_ytf.imag], axis=-1)),
            ytt=j(np.stack([self.br_ytt.real, self.br_ytt.imag], axis=-1)),
            pwp_slope=j(self.pwp[2]), pwp_icept=j(self.pwp[3]),
            pwq_slope=j(self.pwq[2]), pwq_icept=j(self.pwq[3]),
            poly_co=tuple(j(co) for co in self.poly_co),
            obj_const=j(float(self.obj_const)),
        )

    def push_inside(self, x0):
        """Project the start strictly inside the simple-bound constraints
        (Ipopt's push_x0 / bound_push kappa_1 = 0.01): MATPOWER starts
        routinely sit outside their own boxes (V above Vmax, Qg outside
        capability), which pins the IPM slacks at the boundary and caps
        the fraction-to-boundary step at ~1e-3."""
        n, g = self.n, self.g
        kappa = 0.01

        def _clip(vec, lo_pairs, hi_pairs):
            lo = np.full(vec.shape, -np.inf)
            hi = np.full(vec.shape, np.inf)
            for i, b in lo_pairs:
                lo[i] = b
            for i, b in hi_pairs:
                hi[i] = b
            pl = np.where(np.isfinite(lo),
                          kappa * np.maximum(1.0, np.abs(lo)), 0.0)
            pu = np.where(np.isfinite(hi),
                          kappa * np.maximum(1.0, np.abs(hi)), 0.0)
            both = np.isfinite(lo) & np.isfinite(hi)
            width = np.where(both, hi - lo, np.inf)
            pl = np.minimum(pl, kappa * width)
            pu = np.minimum(pu, kappa * width)
            lo_eff = np.where(np.isfinite(lo), lo + pl, -np.inf)
            hi_eff = np.where(np.isfinite(hi), hi - pu, np.inf)
            return np.clip(vec, np.minimum(lo_eff, hi_eff),
                           np.maximum(lo_eff, hi_eff))

        x0[n:2 * n] = _clip(x0[n:2 * n], self.v_lo, self.v_hi)
        x0[2 * n:2 * n + g] = _clip(x0[2 * n:2 * n + g],
                                    self.p_lo, self.p_hi)
        x0[2 * n + g:2 * n + 2 * g] = _clip(
            x0[2 * n + g:2 * n + 2 * g], self.q_lo, self.q_hi)
        # fixed outputs/voltages start exactly at their fixed value
        for i, b in self.fix_v:
            x0[n + i] = b
        for i, b in self.fix_p:
            x0[2 * n + i] = b
        for i, b in self.fix_q:
            x0[2 * n + g + i] = b

    def init_helpers(self, x0):
        """Initialize the piecewise epigraph helpers to the actual piecewise
        cost at the starting generator outputs, so every epigraph cut is
        feasible at the initial point (h >= slope*p - icept holds with
        equality on the active segment). Helpers at an arbitrary constant
        violate the cuts by cost-unit magnitudes and force the IPM through
        a long infeasibility phase."""
        n, g = self.n, self.g
        for cuts, n_h, off, pq0 in (
                (self.pwp, self.n_hp, 2 * n + 2 * g,
                 x0[2 * n:2 * n + g]),
                (self.pwq, self.n_hq, 2 * n + 2 * g + self.n_hp,
                 x0[2 * n + g:2 * n + 2 * g])):
            gi, hpos, slope, icept = cuts
            if not len(gi):
                continue
            h = np.full(n_h, -np.inf)
            np.maximum.at(h, hpos, slope * pq0[gi] - icept)
            x0[off:off + n_h] = np.where(np.isfinite(h), h + 1e-3, 1.0)

    # ---- state layout ----------------------------------------------------

    def split(self, x):
        n, g = self.n, self.g
        theta = x[:n]
        v = x[n:2 * n]
        pg = x[2 * n:2 * n + g]
        qg = x[2 * n + g:2 * n + 2 * g]
        hp = x[2 * n + 2 * g:2 * n + 2 * g + self.n_hp]
        hq = x[2 * n + 2 * g + self.n_hp:]
        return theta, v, pg, qg, hp, hq

    def _injections(self, theta, v, p):
        vi = v[self.rows]
        vj = v[self.cols]
        th = theta[self.rows] - theta[self.cols]
        t1 = vi * vj * (p.yg * jnp.cos(th) + p.yb * jnp.sin(th))
        t2 = vi * vj * (p.yg * jnp.sin(th) - p.yb * jnp.cos(th))
        import jax
        p = jax.ops.segment_sum(t1, self.rows, num_segments=self.n)
        q = jax.ops.segment_sum(t2, self.rows, num_segments=self.n)
        return p, q

    def objective(self, x, p):
        theta, v, pg, qg, hp, hq = self.split(x)
        val = p.obj_const
        for (kind, deg), idx, co in zip(self.poly_keys, self.poly_idx,
                                        p.poly_co):
            pq = pg[idx] if kind == "p" else qg[idx]
            acc = jnp.zeros_like(pq)
            for j in range(deg + 1):  # Horner over the shared degree
                acc = acc * pq + co[:, j]
            val = val + jnp.sum(acc)
        if self.n_hp:
            val = val + jnp.sum(hp)
        if self.n_hq:
            val = val + jnp.sum(hq)
        return val

    def eq(self, x, p):
        theta, v, pg, qg, hp, hq = self.split(x)
        p_inj, q_inj = self._injections(theta, v, p)
        on = jnp.asarray(self.gen_on)
        sup_p = jnp.zeros(self.n).at[self.gen_bus].add(
            jnp.where(on, pg, 0.0))
        sup_q = jnp.zeros(self.n).at[self.gen_bus].add(
            jnp.where(on, qg, 0.0))
        out = [sup_p - p_inj - p.pd,
               sup_q - q_inj - p.qd,
               jnp.reshape(theta[self.slack] - p.slack_angle, (1,))]
        off_idx = np.flatnonzero(~self.gen_on)
        if len(off_idx):
            out.append(pg[off_idx])
            out.append(qg[off_idx])
        if len(self.fixv_i):
            out.append(v[self.fixv_i] - p.fixv_b)
        if len(self.fixp_i):
            out.append(pg[self.fixp_i] - p.fixp_b)
        if len(self.fixq_i):
            out.append(qg[self.fixq_i] - p.fixq_b)
        return jnp.concatenate(out)

    def _flow_values(self, theta, v, p):
        """Vectorized flow-constraint values over all constrained rows.

        All-real arithmetic (admittances ride as [re, im] stacks) — see
        AcParams."""
        fb, tb = self.fl_fb, self.fl_tb
        vfr = v[fb] * jnp.cos(theta[fb])
        vfi = v[fb] * jnp.sin(theta[fb])
        vtr = v[tb] * jnp.cos(theta[tb])
        vti = v[tb] * jnp.sin(theta[tb])
        yff = p.yff[self.fl_k]
        yft = p.yft[self.fl_k]
        ytf = p.ytf[self.fl_k]
        ytt = p.ytt[self.fl_k]
        is_from = jnp.asarray(self.fl_from)
        gf = jnp.where(is_from, yff[:, 0], ytf[:, 0])
        bf = jnp.where(is_from, yff[:, 1], ytf[:, 1])
        gt = jnp.where(is_from, yft[:, 0], ytt[:, 0])
        bt = jnp.where(is_from, yft[:, 1], ytt[:, 1])
        ire = gf * vfr - bf * vfi + gt * vtr - bt * vti
        iim = gf * vfi + bf * vfr + gt * vti + bt * vtr
        vr = jnp.where(is_from, vfr, vtr)
        vi = jnp.where(is_from, vfi, vti)
        pp = vr * ire + vi * iim        # Re(v * conj(i))
        qq = vi * ire - vr * iim        # Im(v * conj(i))
        s2 = pp * pp + qq * qq
        i2 = ire * ire + iim * iim
        cls = self.fl_cls
        # guard sqrt(0) rows (types 2/4): value is exact, gradient clamps
        sqrt_s = jnp.sqrt(jnp.maximum(s2, 1e-24))
        sqrt_i = jnp.sqrt(jnp.maximum(i2, 1e-24))
        val = jnp.select(
            [cls == 1, cls == 2, cls == 3, cls == 4],
            [pp, sqrt_s, s2, sqrt_i], i2)
        return val

    def ineq(self, x, p):
        theta, v, pg, qg, hp, hq = self.split(x)
        out = [v[self.vlo_i] - p.vlo_b,
               p.vhi_b - v[self.vhi_i],
               pg[self.plo_i] - p.plo_b,
               p.phi_b - pg[self.phi_i],
               qg[self.qlo_i] - p.qlo_b,
               p.qhi_b - qg[self.qhi_i],
               p.cc_b - p.cc_aq * pg[self.cc_i]
               - p.cc_ap * qg[self.cc_i]]
        if len(self.fl_k):
            val = self._flow_values(theta, v, p)
            out.append((val - p.fl_lo)[self.fl_has_lo])
            out.append((p.fl_hi - val)[self.fl_has_hi])
        if len(self.an_f):
            diff = theta[self.an_f] - theta[self.an_t]
            out.append(diff - p.an_lo)
            out.append(p.an_hi - diff)
        for (gi, hpos, _sl, _ic), sl, ic, h, pq in (
                (self.pwp, p.pwp_slope, p.pwp_icept, hp, pg),
                (self.pwq, p.pwq_slope, p.pwq_icept, hq, qg)):
            if len(gi):
                out.append(ic - sl * pq[gi] + h[hpos])
        out = [jnp.asarray(o) for o in out]
        out = [o for o in out if o.shape[0]]
        if not out:
            return None
        return jnp.concatenate(out)

    # ---- analytic derivatives ----------------------------------------
    # Autodiffing eq/ineq costs n_x tangent passes through the whole
    # constraint graph per IPM iteration (chunked at pegase scale, but
    # still the dominant per-iteration cost). The derivatives have
    # closed forms: the classic polar power-flow Jacobian per Y entry
    # (same formulas as the SE rows, estimation/acse.py h_entries;
    # reference equations.jl:1-698) plus constant bound/fix/cut rows;
    # only the per-branch flow rows use a 4-variable vmapped grad.

    def jac_eq(self, x, p):
        """Analytic equality Jacobian, shape (m_e, n_x)."""
        import jax
        theta, v, pg, qg, hp, hq = self.split(x)
        n, g = self.n, self.g
        rows_e, cols_e = self.rows, self.cols
        vi = v[rows_e]
        vj = v[cols_e]
        th = theta[rows_e] - theta[cols_e]
        ct = jnp.cos(th)
        st = jnp.sin(th)
        gc = p.yg * ct + p.yb * st
        gs = p.yg * st - p.yb * ct
        t1 = vi * vj * gc
        t2 = vi * vj * gs
        p_bus = jax.ops.segment_sum(t1, rows_e, num_segments=n)
        q_bus = jax.ops.segment_sum(t2, rows_e, num_segments=n)
        diag = rows_e == cols_e
        offf = (~diag).astype(v.dtype)
        gii = jax.ops.segment_sum(jnp.where(diag, p.yg, 0.0), rows_e,
                                  num_segments=n)
        bii = jax.ops.segment_sum(jnp.where(diag, p.yb, 0.0), rows_e,
                                  num_segments=n)

        J = jnp.zeros((self.m_e, self.n_x), dtype=v.dtype)
        ar = jnp.arange(n)
        # balance rows: d(sup - inj - demand)/d· = -d inj/d·
        J = J.at[rows_e, cols_e].add(-t2 * offf)                # -dP/dθj
        J = J.at[rows_e, n + cols_e].add(-vi * gc * offf)       # -dP/dVj
        J = J.at[ar, ar].add(q_bus + bii * v * v)               # -dP/dθi
        J = J.at[ar, n + ar].add(-(p_bus / v + gii * v))        # -dP/dVi
        J = J.at[n + rows_e, cols_e].add(t1 * offf)             # -dQ/dθj
        J = J.at[n + rows_e, n + cols_e].add(-vi * gs * offf)   # -dQ/dVj
        J = J.at[n + ar, ar].add(-(p_bus - gii * v * v))        # -dQ/dθi
        J = J.at[n + ar, n + ar].add(-(q_bus / v - bii * v))    # -dQ/dVi
        on = jnp.asarray(self.gen_on).astype(v.dtype)
        gcols = 2 * n + jnp.arange(g)
        J = J.at[self.gen_bus, gcols].add(on)
        J = J.at[n + self.gen_bus, g + gcols].add(on)
        r = 2 * n
        J = J.at[r, self.slack].set(1.0)
        r += 1
        k = len(self.gen_off)
        if k:
            J = J.at[r + np.arange(k), 2 * n + self.gen_off].set(1.0)
            r += k
            J = J.at[r + np.arange(k), 2 * n + g + self.gen_off].set(1.0)
            r += k
        for idx, col0 in ((self.fixv_i, n), (self.fixp_i, 2 * n),
                          (self.fixq_i, 2 * n + g)):
            if len(idx):
                J = J.at[r + np.arange(len(idx)), col0 + idx].set(1.0)
                r += len(idx)
        return J

    def _flow_grads(self, theta, v, p):
        """Per-row (dθf, dθt, dVf, dVt) of the flow-constraint values:
        each row depends on exactly four state variables, so a vmapped
        4-variable grad is exact and O(rows)."""
        import jax
        fb, tb = self.fl_fb, self.fl_tb
        yff = p.yff[self.fl_k]
        yft = p.yft[self.fl_k]
        ytf = p.ytf[self.fl_k]
        ytt = p.ytt[self.fl_k]
        is_from = jnp.asarray(self.fl_from)
        cls = jnp.asarray(self.fl_cls)
        z = jnp.stack([theta[fb], theta[tb], v[fb], v[tb]], axis=1)
        return jax.vmap(jax.grad(_flow_row_val))(z, yff, yft, ytf, ytt,
                                                 is_from, cls)

    def jac_ineq(self, x, p):
        """Analytic inequality Jacobian, shape (m_i, n_x)."""
        theta, v, pg, qg, hp, hq = self.split(x)
        n, g = self.n, self.g
        J = jnp.zeros((self.m_i, self.n_x), dtype=v.dtype)
        br, bc, bs = self.ji_bound
        if len(br):
            J = J.at[br, bc].set(jnp.asarray(bs, dtype=v.dtype))
        if len(self.cc_i):
            J = J.at[self.ji_cc_rows, 2 * n + self.cc_i].add(-p.cc_aq)
            J = J.at[self.ji_cc_rows, 2 * n + g + self.cc_i].add(-p.cc_ap)
        if len(self.fl_k):
            gz = self._flow_grads(theta, v, p)
            for rows_j, mask, sgn in ((self.ji_fl_lo_rows, self.fl_has_lo,
                                       1.0),
                                      (self.ji_fl_hi_rows, self.fl_has_hi,
                                       -1.0)):
                if len(rows_j):
                    gm = sgn * gz[mask]
                    J = J.at[rows_j, self.fl_fb[mask]].add(gm[:, 0])
                    J = J.at[rows_j, self.fl_tb[mask]].add(gm[:, 1])
                    J = J.at[rows_j, n + self.fl_fb[mask]].add(gm[:, 2])
                    J = J.at[rows_j, n + self.fl_tb[mask]].add(gm[:, 3])
        if len(self.an_f):
            J = J.at[self.ji_an_lo_rows, self.an_f].add(1.0)
            J = J.at[self.ji_an_lo_rows, self.an_t].add(-1.0)
            J = J.at[self.ji_an_hi_rows, self.an_f].add(-1.0)
            J = J.at[self.ji_an_hi_rows, self.an_t].add(1.0)
        for rows_j, (gi, hpos, _sl, _ic), sl, pq_col0, h_col0 in (
                (self.ji_pwp_rows, self.pwp, p.pwp_slope, 2 * n,
                 2 * n + 2 * g),
                (self.ji_pwq_rows, self.pwq, p.pwq_slope, 2 * n + g,
                 2 * n + 2 * g + self.n_hp)):
            if len(gi):
                J = J.at[rows_j, pq_col0 + gi].add(-sl)
                J = J.at[rows_j, h_col0 + hpos].add(1.0)
        return J

    def hess(self, x, y, z, p):
        """Analytic raw Lagrangian Hessian  ∇²f - Σ y ∇²c_E - Σ z ∇²c_I
        (NlpProblem.hess convention): polynomial-cost diagonal, the
        classic polar power-flow second derivatives per Y entry weighted
        by the balance duals, and dual-weighted 4x4 vmapped blocks for
        the flow rows. Every other row (bounds, capability, angle,
        piecewise, slack/off/fix) is linear. The reference delegates this
        assembly to JuMP/Ipopt's AD (acOptimalPowerFlow.jl:333); the
        closed form replaces the chunked autodiff pass that dominated
        pegase-scale IPM iterations."""
        import jax
        theta, v, pg, qg, hp, hq = self.split(x)
        n, g = self.n, self.g
        H = jnp.zeros((self.n_x, self.n_x), dtype=v.dtype)

        # objective: d² of the polynomial costs, diagonal in pg/qg
        for (kind, deg), idx, co in zip(self.poly_keys, self.poly_idx,
                                        p.poly_co):
            if deg < 2:
                continue
            pq = pg[idx] if kind == "p" else qg[idx]
            acc = jnp.zeros_like(pq)
            for j in range(deg - 1):  # descending coeffs of p''
                k = deg - j
                acc = acc * pq + co[:, j] * k * (k - 1)
            col0 = 2 * n if kind == "p" else 2 * n + g
            H = H.at[col0 + idx, col0 + idx].add(acc)

        # balance rows: +y ∇²inj (c_E = sup - inj - pd, so -y∇²c = +y∇²inj)
        rows_e, cols_e = self.rows, self.cols
        vi = v[rows_e]
        vj = v[cols_e]
        th = theta[rows_e] - theta[cols_e]
        ct = jnp.cos(th)
        st = jnp.sin(th)
        gc = p.yg * ct + p.yb * st
        gs = p.yg * st - p.yb * ct
        t1 = vi * vj * gc
        t2 = vi * vj * gs
        diag = rows_e == cols_e
        offf = (~diag).astype(v.dtype)
        yp = y[:n][rows_e] * offf
        yq = y[n:2 * n][rows_e] * offf

        ti, tj = rows_e, cols_e
        vic, vjc = n + rows_e, n + cols_e
        c_tt = -(yp * t1 + yq * t2)
        H = H.at[ti, ti].add(c_tt)
        H = H.at[tj, tj].add(c_tt)
        H = H.at[ti, tj].add(-c_tt)
        H = H.at[tj, ti].add(-c_tt)
        c_tivi = -yp * vj * gs + yq * vj * gc
        H = H.at[ti, vic].add(c_tivi)
        H = H.at[vic, ti].add(c_tivi)
        c_tivj = -yp * vi * gs + yq * vi * gc
        H = H.at[ti, vjc].add(c_tivj)
        H = H.at[vjc, ti].add(c_tivj)
        c_tjvi = yp * vj * gs - yq * vj * gc
        H = H.at[tj, vic].add(c_tjvi)
        H = H.at[vic, tj].add(c_tjvi)
        c_tjvj = yp * vi * gs - yq * vi * gc
        H = H.at[tj, vjc].add(c_tjvj)
        H = H.at[vjc, tj].add(c_tjvj)
        c_vv = yp * gc + yq * gs
        H = H.at[vic, vjc].add(c_vv)
        H = H.at[vjc, vic].add(c_vv)
        # diagonal Y entries: inj_i has vi² terms only
        dsel = diag.astype(v.dtype)
        c_dd = (y[:n][rows_e] * 2.0 * p.yg
                - y[n:2 * n][rows_e] * 2.0 * p.yb) * dsel
        H = H.at[vic, vic].add(c_dd)

        # flow rows: z-weighted per-row 4x4 blocks
        if len(self.fl_k):
            wfl = jnp.zeros(len(self.fl_k), dtype=v.dtype)
            if len(self.ji_fl_lo_rows):
                wfl = wfl.at[np.flatnonzero(self.fl_has_lo)].add(
                    -z[self.ji_fl_lo_rows])
            if len(self.ji_fl_hi_rows):
                wfl = wfl.at[np.flatnonzero(self.fl_has_hi)].add(
                    z[self.ji_fl_hi_rows])
            fb, tb = self.fl_fb, self.fl_tb
            zrow = jnp.stack([theta[fb], theta[tb], v[fb], v[tb]], axis=1)
            h4 = jax.vmap(jax.hessian(_flow_row_val))(
                zrow, p.yff[self.fl_k], p.yft[self.fl_k],
                p.ytf[self.fl_k], p.ytt[self.fl_k],
                jnp.asarray(self.fl_from), jnp.asarray(self.fl_cls))
            i4 = np.stack([fb, tb, n + fb, n + tb], axis=1)
            for a in range(4):
                for b in range(4):
                    H = H.at[i4[:, a], i4[:, b]].add(wfl * h4[:, a, b])
        return H


def _flow_row_val(z, yff_e, yft_e, ytf_e, ytt_e, from_e, cls_e):
    """One flow-constraint value from its four state variables
    z = (θf, θt, Vf, Vt); vmapped with grad/hessian for the analytic
    Jacobian/Hessian rows (must mirror _flow_values exactly). The
    admittances arrive as [re, im] 2-vectors — all-real arithmetic (see
    AcParams)."""
    thf, tht, vf_, vt_ = z[0], z[1], z[2], z[3]
    vfr, vfi = vf_ * jnp.cos(thf), vf_ * jnp.sin(thf)
    vtr, vti = vt_ * jnp.cos(tht), vt_ * jnp.sin(tht)
    gf = jnp.where(from_e, yff_e[0], ytf_e[0])
    bf = jnp.where(from_e, yff_e[1], ytf_e[1])
    gt = jnp.where(from_e, yft_e[0], ytt_e[0])
    bt = jnp.where(from_e, yft_e[1], ytt_e[1])
    ire = gf * vfr - bf * vfi + gt * vtr - bt * vti
    iim = gf * vfi + bf * vfr + gt * vti + bt * vtr
    vr = jnp.where(from_e, vfr, vtr)
    vi = jnp.where(from_e, vfi, vti)
    pp = vr * ire + vi * iim
    qq = vi * ire - vr * iim
    s2 = pp * pp + qq * qq
    i2 = ire * ire + iim * iim
    sqrt_s = jnp.sqrt(jnp.maximum(s2, 1e-24))
    sqrt_i = jnp.sqrt(jnp.maximum(i2, 1e-24))
    return jnp.select(
        [cls_e == 1, cls_e == 2, cls_e == 3, cls_e == 4],
        [pp, sqrt_s, s2, sqrt_i], i2)


def ac_optimal_power_flow(system: PowerSystem) -> AcOptimalPowerFlow:
    """Reference acOptimalPowerFlow (acOptimalPowerFlow.jl:44-250)."""
    system.check_slack()
    model(system, "ac")
    spec = _AcSpec(system)
    n, g = spec.n, spec.g
    x0 = np.zeros(spec.n_x)
    x0[:n] = system.bus.voltage.angle.array[:n]
    x0[n:2 * n] = system.bus.voltage.magnitude.array[:n]
    x0[2 * n:2 * n + g] = system.generator.output.active.array[:g]
    x0[2 * n + g:2 * n + 2 * g] = system.generator.output.reactive.array[:g]
    spec.push_inside(x0)
    if spec.n_hp or spec.n_hq:
        spec.init_helpers(x0)

    power = AcPower(generator=Cartesian(
        active=system.generator.output.active.array[:g].copy(),
        reactive=system.generator.output.reactive.array[:g].copy()))
    analysis = AcOptimalPowerFlow(
        system=system,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        power=power,
        method=OpfMethod("ac_optimal_power_flow"),
    )
    analysis._spec = spec
    analysis._x0 = x0
    return analysis


# buses past which the dense (n_x+m_E)² KKT build is replaced by the
# structured BBD assembly/solve automatically (the dense KKT grows as the
# square of the case size). The bound was set on the previous accelerator
# and is to be re-derived on the GPU.
_KKT_BBD_AUTO = 4000


def solve(analysis: AcOptimalPowerFlow, max_iter: int = 300,
          tolerance: float = 1e-8, verbose: int = 0,
          max_seconds=None, kkt_blocks=None,
          kkt_mesh=None) -> AcOptimalPowerFlow:
    """``kkt_blocks``: number of BBD interior blocks for the structured
    KKT solver (opf/kkt_bbd.py). ``None`` = auto (dense below
    ``_KKT_BBD_AUTO`` buses, BBD above); ``0`` forces dense.
    ``kkt_mesh``: optional jax.sharding.Mesh with a ``block`` axis —
    interior KKT blocks factor one-per-device with the Schur reduction
    riding a psum (model-parallel single-case OPF); requires
    kkt_blocks == axis size."""
    analysis._refresh_spec()
    spec = analysis._spec
    import jax.numpy as jnp_
    has_ineq = spec.ineq(jnp_.asarray(analysis._x0), spec.params) is not None
    # dual carry and the structured-KKT cache are both valid only against
    # the same constraint layout: length equality is not enough (two
    # structural edits can keep counts equal while permuting row meaning),
    # so stamp the structure and compare
    layout = (spec.n, tuple(spec.ineq_tags),
              tuple(i for i, _ in spec.fix_v),
              tuple(i for i, _ in spec.fix_p),
              tuple(i for i, _ in spec.fix_q))
    if kkt_blocks is None:
        kkt_blocks = max(8, spec.n // 512) if spec.n >= _KKT_BBD_AUTO else 0
    kkt_obj = None
    if kkt_blocks:
        cache = getattr(analysis, "_kkt_cache", None)
        # keyed by spec identity + structural layout + block count: live
        # NUMERIC edits patch the spec in place (same id, same layout) and
        # reuse the routed structure — re-solving hits the XLA compile
        # cache; structural edits change the layout (or rebuild the spec)
        # and re-route
        key = (id(spec), layout, kkt_blocks, id(kkt_mesh))
        if cache is not None and cache[0] == key:
            kkt_obj = cache[1]
        else:
            from .kkt_bbd import AcKktBbd
            kkt_obj = AcKktBbd(spec, kkt_blocks, mesh=kkt_mesh)
            analysis._kkt_cache = (key, kkt_obj)
    problem = NlpProblem(objective=spec.objective, eq=spec.eq,
                         ineq=spec.ineq if has_ineq else None,
                         jac_eq=spec.jac_eq,
                         jac_ineq=spec.jac_ineq if has_ineq else None,
                         hess=spec.hess,
                         push_inside=spec.push_inside,
                         params=spec.params,
                         kkt=kkt_obj)
    warm = None
    prev = getattr(analysis.method, "result", None)
    if getattr(analysis, "_carry_duals", False) and prev is not None \
            and getattr(analysis.method, "_warm_layout", None) == layout:
        warm = (prev.y, prev.z, prev.s)
    analysis._carry_duals = False
    res = solve_nlp(problem, analysis._x0, max_iter=max_iter, tol=tolerance,
                    verbose=verbose, warm_duals=warm,
                    max_seconds=max_seconds)
    analysis.method._warm_layout = layout
    analysis.method.result = res
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    analysis.method.objective = res.objective

    n, g = spec.n, spec.g
    analysis.voltage.angle = res.x[:n]
    analysis.voltage.magnitude = res.x[n:2 * n]
    pg = res.x[2 * n:2 * n + g].copy()
    qg = res.x[2 * n + g:2 * n + 2 * g].copy()
    pg[~spec.gen_on] = 0.0
    qg[~spec.gen_on] = 0.0
    analysis.power.generator = Cartesian(active=pg, reactive=qg)
    analysis._x0 = res.x
    analysis.method.dual = {
        "balance_active": res.y[:n],
        "balance_reactive": res.y[n:2 * n],
        "ineq": res.z,
        "ineq_tags": spec.ineq_tags,
    }
    return analysis


def set_initial_point(analysis: AcOptimalPowerFlow, source=None):
    spec = analysis._spec
    n, g = spec.n, spec.g
    system = analysis.system
    if source is None:
        x0 = np.zeros(spec.n_x)
        x0[:n] = system.bus.voltage.angle.array[:n]
        x0[n:2 * n] = system.bus.voltage.magnitude.array[:n]
        x0[2 * n:2 * n + g] = system.generator.output.active.array[:g]
        x0[2 * n + g:2 * n + 2 * g] = \
            system.generator.output.reactive.array[:g]
        spec.push_inside(x0)
        if spec.n_hp or spec.n_hq:
            spec.init_helpers(x0)
        analysis._x0 = x0
    else:
        x0 = np.asarray(analysis._x0).copy()
        x0[:n] = source.voltage.angle[:n]
        if hasattr(source.voltage, "magnitude"):
            x0[n:2 * n] = source.voltage.magnitude[:n]
        if getattr(source, "power", None) is not None and \
                len(getattr(source.power.generator, "active", [])) == g:
            x0[2 * n:2 * n + g] = source.power.generator.active
            if len(getattr(source.power.generator, "reactive", [])) == g:
                x0[2 * n + g:2 * n + 2 * g] = \
                    source.power.generator.reactive
        spec.push_inside(x0)
        if spec.n_hp or spec.n_hq:
            spec.init_helpers(x0)
        analysis._x0 = x0
