"""CLI surface: list-presets, run with overrides, metric JSON, bad input."""

import json
import os
import subprocess
import sys

import pytest

ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
}
PY = sys.executable


def run_cli(*args, check=True):
    return subprocess.run(
        [PY, "-m", "nestmc", *args],
        capture_output=True, text=True, env=ENV,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        check=check,
    )


def test_list_presets():
    out = run_cli("list-presets").stdout
    for name in ("eight-schools", "hier-logistic-1k", "ragged-10k",
                 "mala-100k"):
        assert name in out


def test_run_with_overrides_and_metric_json():
    r = run_cli(
        "run", "--preset", "eight-schools", "--chains", "4",
        "--warmup", "20", "--draws", "20", "--quiet", "--metric-json",
    )
    line = r.stdout.strip().splitlines()[-1]
    res = json.loads(line)
    assert res["unit"] == "ESS/s/chip"
    assert res["value"] > 0
    assert "worst_rhat" in res


def test_run_human_output():
    r = run_cli(
        "run", "--preset", "eight-schools", "--chains", "4",
        "--warmup", "20", "--draws", "20", "--quiet",
    )
    assert "worst R-hat" in r.stdout
    assert "mu" in r.stdout


def test_unknown_preset_fails():
    r = run_cli("run", "--preset", "nope", check=False)
    assert r.returncode != 0


def test_resume_without_checkpoint_fails():
    r = run_cli(
        "run", "--preset", "eight-schools", "--resume",
        "--checkpoint-dir", "/tmp/nestmc-definitely-missing",
        check=False,
    )
    assert r.returncode == 2
    assert "no checkpoint" in r.stderr


def test_save_draws_and_compare(tmp_path):
    a = str(tmp_path / "a.npz")
    b = str(tmp_path / "b.npz")
    for path, seed in ((a, "1"), (b, "2")):
        run_cli(
            "run", "--preset", "hier-logistic-100", "--chains", "4",
            "--warmup", "30", "--draws", "60", "--seed", seed, "--quiet",
            "--collect", "mu,beta:4,group_loglik",
            "--save-draws", path,
        )
    import numpy as np

    with np.load(a) as z:
        assert z["group_loglik"].shape == (4, 60, 100)
        assert z["beta"].shape[2] == 4
    r = run_cli("compare", a, b, "--method", "waic")
    rows = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(rows) == 2 and rows[0]["elpd_diff"] == 0.0
    r2 = run_cli("compare", a, b)  # PSIS-LOO default
    assert "k_hat>0.7" in r2.stdout


def test_compare_missing_unit_errors(tmp_path):
    p = str(tmp_path / "c.npz")
    run_cli(
        "run", "--preset", "eight-schools", "--chains", "4",
        "--warmup", "10", "--draws", "10", "--quiet",
        "--save-draws", p,
    )
    r = run_cli("compare", p, check=False)
    assert r.returncode == 2
    assert "group_loglik" in r.stderr
