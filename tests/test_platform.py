"""The capability test, the compile-cache location, and the imports that
only some features need."""

import os
import subprocess
import sys

import jax
import pytest

from newsched_tpu.utils import platform


@pytest.mark.parametrize("backend,expect", [("gpu", True), ("cpu", False),
                                            ("rocm", False)])
def test_gpu_backend_is_the_one_capability_test(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert platform.gpu_backend() is expect


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="measures the GPU"):
        platform.require_gpu()


def _cache_dir_in_child(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax; from newsched_tpu.utils.platform import "
            "enable_compile_cache; enable_compile_cache(); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_the_checkout(tmp_path):
    got = _cache_dir_in_child(None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".jax_cache")


def test_compile_cache_env_var_wins(tmp_path):
    assert _cache_dir_in_child(str(tmp_path)) == str(tmp_path)


def test_main_path_imports_no_optional_package():
    """Building and compiling a flagship model imports neither PyYAML,
    pyzmq, orbax nor matplotlib."""
    code = ("import sys; from newsched_tpu import models; "
            "from newsched_tpu.runtime.compile import compile_flowgraph; "
            "fg, _ = models.fm_channelizer(nchans=8, taps_per_arm=4, "
            "batch_size=1024, fused=True); compile_flowgraph(fg, 128); "
            "print(sorted(m for m in ('yaml', 'zmq', 'orbax', 'matplotlib') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_require_names_the_missing_package():
    from newsched_tpu.utils.optional import require

    with pytest.raises(ImportError, match="pip install no-such-pkg"):
        require("no_such_module_xyz", "no-such-pkg", "a feature")
    assert require("json", "json", "x").dumps([1]) == "[1]"
