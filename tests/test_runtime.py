"""Entry-point set-up: the compile-cache rule and the GPU requirement."""

import os

import jax
import pytest

from ti_raytrace_tpu.core import runtime


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_cache_honours_env_and_sets_nothing(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert runtime.setup_compile_cache() == "/some/where"
    assert config_updates == []


def test_cache_defaults_to_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == os.path.join(runtime.REPO, ".cache", "jax")
    assert config_updates == [("jax_compilation_cache_dir", path)]


def test_require_gpu_refuses_the_cpu():
    assert runtime.device_info()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_bench_stops_without_a_gpu(monkeypatch):
    import bench

    monkeypatch.setattr(runtime, "setup_compile_cache", lambda: "")
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main([])


def test_cli_stops_without_a_gpu(monkeypatch, tmp_path):
    from ti_raytrace_tpu.examples import run

    monkeypatch.setattr(runtime, "setup_compile_cache", lambda: "")
    with pytest.raises(RuntimeError, match="no GPU"):
        run.main(["cornell_box", "--size", "8", "--frames", "1",
                  "--out", str(tmp_path / "x.png")])
