"""What the program runs on: compile cache placement, the peaks table, and
chip_smoke.py's refusal to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import jax

from nestmc.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def captured_config(monkeypatch):
    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.append((k, v))
    )
    return calls


def test_cache_env_is_honoured(monkeypatch, captured_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert device.enable_compile_cache() == "/somewhere/else"
    assert captured_config == []          # nothing else is set


def test_cache_default_is_fixed_inside_the_checkout(monkeypatch,
                                                    captured_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert captured_config == [("jax_compilation_cache_dir", path)]
    assert device.enable_compile_cache() == path      # same every call
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_peaks_known_and_unknown():
    assert device.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert device.hbm_peak("cpu") is None
    assert device.hbm_peak("some future card") is None


def test_sweep_cost_has_no_speed_of_light_for_unknown_device():
    from nestmc.config import RunConfig, SamplerConfig
    from nestmc.models import make_eight_schools
    from nestmc.utils.profiling import sweep_cost

    model, data = make_eight_schools()
    out = sweep_cost(model, data, SamplerConfig(run=RunConfig(chains=4)))
    assert out["device_kind"] == jax.devices()[0].device_kind
    assert out["sol_sweeps_per_sec_hbm"] is None
    assert out["flops_per_sweep"] >= 0.0


def test_device_summary_names_the_platform():
    s = device.device_summary()
    assert s["platform"] == jax.devices()[0].platform
    assert s["count"] == len(jax.devices())


def _smoke(cwd, *args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_chip_smoke_refuses_without_gpu(args):
    r = _smoke(REPO, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
