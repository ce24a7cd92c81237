"""AC power flow: Newton-Raphson, fast decoupled (BX/XB), Gauss-Seidel.

Redesign of /root/reference/src/powerFlow/acPowerFlow.jl. The
reference walks Y-bus columns in serial Julia loops and calls KLU/UMFPACK
(:645-911); here mismatches and the Jacobian are built as vectorized
segment-sums/scatters over the Y-bus entry list, the linear solve is the
mixed-precision dense path (ops/linalg.py), and the outer iteration is a
``lax.while_loop`` so the whole solve compiles to a single XLA program and
``vmap`` gives scenario batching for free.

State formulation: the Jacobian is the full 2n x 2n polar Jacobian with
inactive rows/columns (slack angle, non-PQ magnitudes) masked to identity.
This keeps shapes static under bus-type changes (no retrace when
reactive-limit handling flips PV->PQ) — the padding-friendly equivalent of
the reference's pq/pvpq index remapping (acPowerFlow.jl:89-175).

Iteration-count semantics match the reference driver exactly
(acPowerFlow.jl:1389-1433): compute mismatch, stop if max|dP|,max|dQ| < tol,
stop if the iteration limit is reached, otherwise solve and increment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..ops import linalg
from ..report.log import info
from ..system.model import model
from ..system.types import PowerSystem
from ..utils.errors import SlackDefinitionError


class AcArrays(NamedTuple):
    """Frozen device snapshot of the AC network for power-flow kernels."""

    rows: jax.Array     # i32[nnz] Y-bus entry row (bus of the injection eq.)
    cols: jax.Array     # i32[nnz] Y-bus entry column
    yg: jax.Array       # f64[nnz] Re(Y)
    yb: jax.Array       # f64[nnz] Im(Y)
    diag: jax.Array     # i32[n]   position of the diagonal entry per bus
    bus_type: jax.Array  # i32[n]  1 PQ, 2 PV, 3 slack
    slack: jax.Array    # i32 scalar
    p_sched: jax.Array  # f64[n] supply - demand, active
    q_sched: jax.Array  # f64[n] supply - demand, reactive


def ac_entry_host(system: PowerSystem):
    """Host-side (rows, cols, vals, diag) of the Y-bus entry list — the
    numpy source of truth for every compile step. Routing/compile code
    reads THIS rather than pulling device arrays back to the host."""
    model(system, "ac")
    coo = system.model.ac.nodal.tocoo()
    order = np.lexsort((coo.col, coo.row))
    rows = coo.row[order].astype(np.int32)
    cols = coo.col[order].astype(np.int32)
    vals = coo.data[order]
    diag = np.flatnonzero(rows == cols).astype(np.int32)
    return rows, cols, vals, diag


def compile_ac_arrays(system: PowerSystem) -> AcArrays:
    rows, cols, vals, diag = ac_entry_host(system)
    n = system.bus.number
    return AcArrays(
        rows=jnp.asarray(rows),
        cols=jnp.asarray(cols),
        yg=jnp.asarray(vals.real),
        yb=jnp.asarray(vals.imag),
        diag=jnp.asarray(diag),
        bus_type=jnp.asarray(system.bus.layout.type.array[:n], dtype=jnp.int32),
        slack=jnp.asarray(system.bus.layout.slack, dtype=jnp.int32),
        p_sched=jnp.asarray(system.bus.supply.active.array[:n]
                            - system.bus.demand.active.array[:n]),
        q_sched=jnp.asarray(system.bus.supply.reactive.array[:n]
                            - system.bus.demand.reactive.array[:n]),
    )


# --------------------------------------------------------------------------
# Pure kernels
# --------------------------------------------------------------------------

def _injections(arr: AcArrays, vm, va):
    """Per-bus P, Q injections plus the per-entry trig terms (reused by the
    Jacobian). Equivalent of the closed-form equation library sweep
    (backend/equations.jl:101-144) as segment sums over Y entries."""
    n = vm.shape[0]
    vi = vm[arr.rows]
    vj = vm[arr.cols]
    th = va[arr.rows] - va[arr.cols]
    sin_t = jnp.sin(th)
    cos_t = jnp.cos(th)
    # t1 = Vi Vj (G cos + B sin) -> P terms ; t2 = Vi Vj (G sin - B cos) -> Q
    vv = vi * vj
    t1 = vv * (arr.yg * cos_t + arr.yb * sin_t)
    t2 = vv * (arr.yg * sin_t - arr.yb * cos_t)
    p = jax.ops.segment_sum(t1, arr.rows, num_segments=n)
    q = jax.ops.segment_sum(t2, arr.rows, num_segments=n)
    return p, q, t1, t2


def _mismatch(arr: AcArrays, vm, va):
    """Reference mismatch! (acPowerFlow.jl:645-685): active residuals on all
    non-slack buses, reactive residuals on PQ buses; returns max-abs pair."""
    n = vm.shape[0]
    p, q, _, _ = _injections(arr, vm, va)
    not_slack = jnp.arange(n) != arr.slack
    is_pq = arr.bus_type == 1
    mp = jnp.where(not_slack, p - arr.p_sched, 0.0)
    mq = jnp.where(is_pq, q - arr.q_sched, 0.0)
    del_p = jnp.max(jnp.abs(mp))
    del_q = jnp.max(jnp.abs(jnp.where(is_pq, mq, 0.0)))
    return mp, mq, del_p, del_q


def _nr_jacobian(arr: AcArrays, vm, va, p, q):
    """Full 2n x 2n polar Jacobian with masked identity rows/cols."""
    n = vm.shape[0]
    vi = vm[arr.rows]
    vj = vm[arr.cols]
    th = va[arr.rows] - va[arr.cols]
    sin_t = jnp.sin(th)
    cos_t = jnp.cos(th)
    gc_bs = arr.yg * cos_t + arr.yb * sin_t    # G cos + B sin
    gs_bc = arr.yg * sin_t - arr.yb * cos_t    # G sin - B cos

    off = arr.rows != arr.cols
    h = jnp.where(off, vi * vj * gs_bc, 0.0)       # dP/dθj
    nn = jnp.where(off, vi * gc_bs, 0.0)           # dP/dVj
    jj = jnp.where(off, -vi * vj * gc_bs, 0.0)     # dQ/dθj
    ll = jnp.where(off, vi * gs_bc, 0.0)           # dQ/dVj

    jac = jnp.zeros((2 * n, 2 * n), dtype=vm.dtype)
    r = arr.rows
    c = arr.cols
    jac = jac.at[r, c].add(h)
    jac = jac.at[r, n + c].add(nn)
    jac = jac.at[n + r, c].add(jj)
    jac = jac.at[n + r, n + c].add(ll)

    gii = arr.yg[arr.diag]
    bii = arr.yb[arr.diag]
    i = jnp.arange(n)
    jac = jac.at[i, i].add(-q - bii * vm**2)
    jac = jac.at[i, n + i].add(p / vm + gii * vm)
    jac = jac.at[n + i, i].add(p - gii * vm**2)
    jac = jac.at[n + i, n + i].add(q / vm - bii * vm)

    # slack-angle and non-PQ-magnitude rows/cols -> identity (the dense
    # equivalent of the reference's removeRowColumn masking, sparse.jl:155-203)
    m = jnp.concatenate([(i != arr.slack), arr.bus_type == 1]).astype(vm.dtype)
    jac = m[:, None] * jac * m[None, :] + jnp.diag(1.0 - m)
    return jac, m


def _nr_step(arr: AcArrays, vm, va, kind: str):
    """One Newton-Raphson solve: returns updated state."""
    n = vm.shape[0]
    p, q, _, _ = _injections(arr, vm, va)
    i = jnp.arange(n)
    not_slack = i != arr.slack
    is_pq = arr.bus_type == 1
    mp = jnp.where(not_slack, p - arr.p_sched, 0.0)
    mq = jnp.where(is_pq, q - arr.q_sched, 0.0)

    jac, m = _nr_jacobian(arr, vm, va, p, q)
    rhs = jnp.concatenate([mp, mq]) * m
    dx = linalg.solve(linalg.factorize(jac, kind), rhs)
    va_new = va - jnp.where(not_slack, dx[:n], 0.0)
    vm_new = vm - jnp.where(is_pq, dx[n:], 0.0)
    return vm_new, va_new


_nr_step_jit = jax.jit(_nr_step, static_argnames="kind")


@partial(jax.jit, static_argnames=("kind", "max_iter"))
def _nr_solve(arr: AcArrays, vm, va, tol: float, max_iter: int, kind: str):
    """Full NR driver as one XLA program (lax.while_loop)."""

    mp, mq, del_p, del_q = _mismatch(arr, vm, va)

    def cond(carry):
        vm, va, it, del_p, del_q = carry
        converged = (del_p < tol) & (del_q < tol)
        return (~converged) & (it < max_iter)

    def body(carry):
        vm, va, it, _, _ = carry
        vm, va = _nr_step(arr, vm, va, kind)
        _, _, del_p, del_q = _mismatch(arr, vm, va)
        return vm, va, it + 1, del_p, del_q

    vm, va, it, del_p, del_q = jax.lax.while_loop(
        cond, body, (vm, va, jnp.int64(0), del_p, del_q))
    converged = (del_p < tol) & (del_q < tol)
    return vm, va, it, del_p, del_q, converged


# --------------------------------------------------------------------------
# Analysis objects (host-side, reference AcPowerFlow wrappers)
# --------------------------------------------------------------------------

@dataclass
class Polar:
    magnitude: np.ndarray
    angle: np.ndarray


@dataclass
class MethodState:
    name: str
    factorization: str = linalg.LU
    iteration: int = 0
    converged: bool = False
    max_mismatch_active: float = np.inf
    max_mismatch_reactive: float = np.inf


@dataclass
class AcPowerFlow:
    system: PowerSystem
    voltage: Polar
    method: MethodState
    arrays: AcArrays
    power: Optional[object] = None
    current: Optional[object] = None
    signature: dict = field(default_factory=dict)

    def _refresh_arrays(self):
        """Signature staleness protocol: rebuild the device snapshot when the
        system moved past the captured revision (reference acPowerFlow.jl:
        802-811, 890-895 decides rebuild vs refactorize; the dense path
        treats both as a snapshot refresh)."""
        rev = self.system.model.revision
        sig = self.signature
        if sig and (sig.get("type") != rev.type
                    or sig.get("slack") != rev.slack):
            # The pinned-row VALUES are device state too: when the pin set
            # moves (bus type change, slack re-designation) the live state
            # must re-seed PV/slack magnitudes from generator setpoints and
            # move the angle datum to the new slack's stored angle — a
            # uniform shift that keeps the warm start (flows are datum-
            # invariant) while matching a fresh build's reference exactly
            # (reference changeSlackBus!, acPowerFlow.jl:1334-1358).
            magnitude, angle = initialize_ac_power_flow(self.system)
            bus = self.system.bus
            n = bus.number
            vm = np.asarray(self.voltage.magnitude, dtype=float).copy()
            va = np.asarray(self.voltage.angle, dtype=float).copy()
            pinned = np.asarray(bus.layout.type[:n]) != 1
            vm[pinned] = magnitude[pinned]
            slack = bus.layout.slack
            va = va + (angle[slack] - va[slack])
            self.voltage.magnitude = vm
            self.voltage.angle = va
        if (sig.get("ac_model") != rev.ac_model
                or sig.get("ac_pattern") != rev.ac_pattern
                or sig.get("type") != rev.type
                or sig.get("injection") != rev.injection
                or sig.get("slack") != rev.slack):
            if self.method.name in ("fast_newton_raphson_bx",
                                    "fast_newton_raphson_xb"):
                from .fast_decoupled import compile_fnr_arrays
                self.arrays = compile_fnr_arrays(
                    self.system, self.method.name.endswith("bx"))
            elif self.method.name == "gauss_seidel":
                from .gauss_seidel import compile_gs_arrays
                self.arrays = compile_gs_arrays(self.system)
            elif self.method.name == "newton_raphson_bbd":
                from .newton_bbd import compile_nr_bbd
                self.arrays, self._bbd_layout = compile_nr_bbd(
                    self.system, self._bbd_n_blocks)
            elif self.method.name.startswith("fast_newton_raphson_bbd"):
                from .fast_decoupled import compile_fnr_bbd
                self.arrays, self._bbd_factors = compile_fnr_bbd(
                    self.system, self.method.name.endswith("bx"),
                    self._bbd_n_blocks)
            else:
                self.arrays = compile_ac_arrays(self.system)
            sig["ac_model"] = rev.ac_model
            sig["ac_pattern"] = rev.ac_pattern
            sig["type"] = rev.type
            sig["injection"] = rev.injection
            sig["slack"] = rev.slack


def initialize_ac_power_flow(system: PowerSystem):
    """Bus-type repair + start voltages (reference acPowerFlow.jl:1312-1331).

    PV buses without in-service generators become PQ; PV/slack magnitudes are
    seeded from the first in-service generator's setpoint; the slack is
    re-designated if it lost its generators (changeSlackBus!, :1334-1358).
    """
    bus = system.bus
    n = bus.number
    magnitude = bus.voltage.magnitude.array[:n].copy()
    angle = bus.voltage.angle.array[:n].copy()

    for i in range(n):
        has_gen = i in bus.supply.generator and bus.supply.generator[i]
        if not has_gen and bus.layout.type[i] == 2:
            bus.layout.type[i] = 1
            system.type_changed()
        if has_gen and bus.layout.type[i] != 1:
            first = bus.supply.generator[i][0]
            magnitude[i] = system.generator.voltage.magnitude[first]

    change_slack_bus(system)
    return magnitude, angle


def change_slack_bus(system: PowerSystem):
    """Reference changeSlackBus! (acPowerFlow.jl:1334-1358)."""
    bus = system.bus
    slack = bus.layout.slack
    if slack in bus.supply.generator and bus.supply.generator[slack]:
        return
    bus.layout.type[slack] = 1
    system.type_changed()
    for i in range(bus.number):
        if bus.layout.type[i] == 2 and bus.supply.generator.get(i):
            bus.layout.type[i] = 3
            system.type_changed()
            bus.layout.slack = i
            system.slack_changed()
            info("No in-service generator found at the slack bus. "
                 f"The bus labeled {bus.label.label(i)} is the new slack bus.")
            break
    if bus.layout.type[bus.layout.slack] == 1:
        raise SlackDefinitionError(
            "No generator buses with an in-service generator are available; "
            "a slack bus cannot be designated.")


def newton_raphson(system: PowerSystem,
                   factorization: str = linalg.LU) -> AcPowerFlow:
    """Construct a Newton-Raphson AC power flow analysis
    (reference newtonRaphson, acPowerFlow.jl:39-87)."""
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays = compile_ac_arrays(system)
    rev = system.model.revision
    return AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState("newton_raphson", factorization),
        arrays=arrays,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )


def mismatch(analysis: AcPowerFlow):
    """Reference mismatch!: returns (max|dP|, max|dQ|)."""
    analysis._refresh_arrays()
    if analysis.method.name in ("fast_newton_raphson_bx",
                                "fast_newton_raphson_xb"):
        from .fast_decoupled import fnr_mismatch
        return fnr_mismatch(analysis)
    if analysis.method.name == "gauss_seidel":
        from .gauss_seidel import gs_mismatch
        return gs_mismatch(analysis)
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    _, _, del_p, del_q = _mismatch(analysis.arrays, vm, va)
    analysis.method.max_mismatch_active = float(del_p)
    analysis.method.max_mismatch_reactive = float(del_q)
    return float(del_p), float(del_q)


def solve(analysis: AcPowerFlow):
    """Reference solve!: one iteration of the active method."""
    analysis._refresh_arrays()
    if analysis.method.name in ("fast_newton_raphson_bx",
                                "fast_newton_raphson_xb"):
        from .fast_decoupled import fnr_solve_step
        return fnr_solve_step(analysis)
    if analysis.method.name == "gauss_seidel":
        from .gauss_seidel import gs_solve_step
        return gs_solve_step(analysis)
    vm = jnp.asarray(analysis.voltage.magnitude)
    va = jnp.asarray(analysis.voltage.angle)
    vm, va = _nr_step_jit(
        analysis.arrays, vm, va, analysis.method.factorization)
    analysis.voltage.magnitude = np.asarray(vm)
    analysis.voltage.angle = np.asarray(va)
    analysis.method.iteration += 1


def set_initial_point(target: AcPowerFlow, source=None):
    """Warm start (reference setInitialPoint!, acPowerFlow.jl:1226-1309):
    from the system's stored start voltages, or from another analysis."""
    system = target.system
    n = system.bus.number
    if source is None:
        magnitude, angle = initialize_ac_power_flow(system)
        target.voltage.magnitude = magnitude
        target.voltage.angle = angle
    else:
        target.voltage.magnitude = np.array(source.voltage.magnitude[:n])
        if hasattr(source.voltage, "angle"):
            target.voltage.angle = np.array(source.voltage.angle[:n])
