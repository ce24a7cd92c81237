"""How the package and its entry scripts behave in a fresh process:
where the compile cache goes, that importing needs no h5py, and that the
GPU-only scripts refuse to report anything from a CPU."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(code_or_args, env_update=None, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_update or {})
    args = code_or_args if isinstance(code_or_args, list) \
        else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("given", [None, "named"])
def test_compile_cache_dir(given, tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if given else {}
    out = _run("import jax, juliagrid_tpu; "
               "print(jax.config.jax_compilation_cache_dir)", env)
    assert out.returncode == 0, out.stderr
    want = str(tmp_path) if given else str(ROOT / ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want


def test_import_and_solve_without_h5py():
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "import juliagrid_tpu as jg\n"
        "pf = jg.newton_raphson(jg.power_system('tests/data/case14.m'))\n"
        "jg.power_flow(pf)\n"
        "assert pf.method.converged\n"
        "pegase = jg.power_system('tests/data/case1354pegase.npz')\n"
        "assert pegase.bus.number == 1354\n"
        "print('ok', pf.method.iteration)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("ok")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_cpu(script):
    out = _run([script])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "{" not in out.stdout
