"""Timing and profiling surface (SURVEY §5 tracing/profiling row).

The reference leans on Julia's ``@time``/BenchmarkTools culture and prints
wall times in its verbose solver output; it has no deeper profiler of its
own. This framework needs two levels:

* **host spans** — named wall-clock sections (build / compile / iterate /
  postprocess) accumulated per analysis and printable as a table. Driver
  code wraps its phases in ``span`` so every solve carries its own timing
  breakdown (``analysis.method.timings``) without external tooling.
* **device traces** — ``trace(logdir)`` wraps ``jax.profiler`` so a real
  solve can be captured and inspected in XProf/TensorBoard (HLO-level
  fusion, device-memory traffic, per-kernel device time). This is the
  path used to verify kernels against speed-of-light, not host timers.

Spans measure *host-observed* wall time: a jitted call that returns
without blocking contributes its dispatch cost only, so drivers that want
honest numbers block on results inside the span (ours do — every driver
ends its iterate span at a ``block_until_ready``/host readback).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timings:
    """Named wall-clock accumulators: ``{name: [count, total_seconds]}``."""

    spans: dict = field(default_factory=dict)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            cnt, tot = self.spans.get(name, (0, 0.0))
            self.spans[name] = (cnt + 1, tot + dt)

    def add(self, name: str, seconds: float):
        cnt, tot = self.spans.get(name, (0, 0.0))
        self.spans[name] = (cnt + 1, tot + seconds)

    def total(self, name: str) -> float:
        return self.spans.get(name, (0, 0.0))[1]

    def report(self, file=None) -> str:
        """Fixed-width table of accumulated spans (longest first)."""
        rows = sorted(self.spans.items(), key=lambda kv: -kv[1][1])
        wname = max([len("Phase")] + [len(k) for k, _ in rows])
        lines = [f"{'Phase':<{wname}}  {'Calls':>6}  {'Total [s]':>10}  "
                 f"{'Mean [ms]':>10}"]
        for name, (cnt, tot) in rows:
            mean_ms = 1e3 * tot / max(cnt, 1)
            lines.append(f"{name:<{wname}}  {cnt:>6}  {tot:>10.4f}  "
                         f"{mean_ms:>10.3f}")
        out = "\n".join(lines)
        if file is not None:
            print(out, file=file)
        return out


#: process-wide default registry (drivers record here too, so a session's
#: cumulative picture is one ``default_timings.report()`` away)
default_timings = Timings()


@contextmanager
def span(name: str, timings: Timings | None = None):
    """Time a section into ``timings`` (or the process-wide registry)."""
    target = timings if timings is not None else default_timings
    with target.span(name):
        yield


def trace(logdir: str):
    """Capture a device-level profiler trace to ``logdir`` (XProf /
    TensorBoard format) as a context manager. Wraps
    ``jax.profiler.trace``; a profiler failure raises."""
    import jax

    return jax.profiler.trace(logdir)


def annotate(name: str):
    """Device-trace annotation for a code region (shows up as a named
    range in XProf). Usable as a context manager."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def gpu_report() -> dict:
    """The GPU(s) a measurement runs on: JAX's view (platform, device
    kind, count, version) and each card's name and power limit as
    ``nvidia-smi`` reports them. Raises ``RuntimeError`` unless JAX's
    first device is a GPU: a measurement never falls back to the CPU."""
    import subprocess

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX's first device is "
                           f"{devices[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "count": len(devices), "jax": jax.__version__,
            "cards": [line.strip() for line in smi.strip().splitlines()]}
