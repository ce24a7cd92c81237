"""Global configuration for the juliagrid_tpu framework.

The reference framework (JuliaGrid) works in float64 throughout, so the
framework-wide default dtype is f64 and results match the reference
oracles to their tolerances. Dense factorizations run in f32 with f64
iterative refinement (see ops/linalg.py).

Importing the package also points JAX's persistent compilation cache at
a fixed directory inside the checkout, ``<repo>/.jax_cache``, unless
``JAX_COMPILATION_CACHE_DIR`` names one (JAX then reads it itself). The
path is part of the cache key, so it must not move between runs.

Mirrors the reference's ``@config`` macro and ``ConfigTemplate``
(/root/reference/src/backend/internal.jl:299-312, definition/internal.jl:236).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import jax

# Enable x64 once at import. Opt out with JGTPU_NO_X64=1 (e.g. pure-f32 benches).
if not os.environ.get("JGTPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


@dataclass
class Config:
    """Live global configuration (the reference's ``template.config``)."""

    #: solver progress verbosity 0..3 (reference @config(verbose=...))
    verbose: int = 0
    #: default label key type for new elements: ``int`` or ``str``
    label_type: type = int
    #: dtype for device state arrays (f64 default for oracle parity)
    dtype: str = "float64"


config = Config()


def set_config(**kwargs) -> None:
    """Equivalent of the reference ``@config`` macro."""
    for k, v in kwargs.items():
        if not hasattr(config, k):
            raise KeyError(f"unknown config key: {k}")
        setattr(config, k, v)


def default_config() -> None:
    """Reset global config (part of the reference ``@default`` macro)."""
    global config
    config.verbose = 0
    config.label_type = int
    config.dtype = "float64"
