"""The execution-path switch, the compile-cache helper, and chip_smoke.py's
refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from wah_tpu import WahCodec, backend

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,path", [("cpu", "xla"), ("gpu", "xla")])
def test_execution_path_by_platform(platform, path):
    assert backend.execution_path(platform) == path


def test_default_path_follows_this_platform():
    assert backend.execution_path() == "xla"  # the tests run on the CPU
    assert WahCodec().path == "xla"
    assert backend.resolve("auto") == backend.resolve(None) == "xla"


@pytest.mark.parametrize("kernel", ["pallas", "mosaic", "triton", ""])
def test_unknown_paths_are_refused(kernel):
    with pytest.raises(ValueError):
        backend.resolve(kernel)
    with pytest.raises(ValueError):
        WahCodec(kernel=kernel)


def test_compile_cache_uses_the_variable_when_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = backend.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert backend.enable_compile_cache() == path  # fixed, not fresh
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def _run_smoke(cwd, env):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run_smoke(REPO, env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = _run_smoke(tmp_path, env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
