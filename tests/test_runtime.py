"""Entry-point set-up (hgmm.utils.runtime): the compile cache and the GPU
check that every measuring entry point makes."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from hgmm.utils import runtime

REPO = Path(__file__).resolve().parents[1]


def test_compile_cache_honours_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no directory of
    its own (JAX reads the variable itself)."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert runtime.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = runtime.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        runtime.require_gpu()


def test_require_gpu_cpu_option():
    assert runtime.require_gpu(cpu_ok=True).platform == "cpu"
    assert runtime.device_record() == {
        "platform": "cpu", "kind": "cpu", "count": len(jax.devices()),
    }


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_without_gpu(script):
    """On a host without a GPU the entry points exit non-zero, say why,
    and print no result on stdout."""
    r = subprocess.run(
        [sys.executable, str(REPO / script)], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert r.stdout.strip() == ""
