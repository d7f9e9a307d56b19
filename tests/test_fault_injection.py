"""Fault injection: SIGKILL the sampler mid-run, resume from the last
checkpoint via the CLI, and verify the resumed run completes and reports.

SURVEY.md section 5.3: restart-based recovery is the idiomatic accelerator
batch-job failure model; tests/test_checkpoint.py proves bitwise-identical continuation
in-process, this test proves the cross-PROCESS path (serialize -> kill ->
new process -> deserialize -> continue).
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
}
PY = sys.executable
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kill_and_resume(tmp_path):
    ckdir = str(tmp_path / "ck")
    args = [
        PY, "-m", "nestmc", "run", "--preset", "eight-schools",
        "--chains", "4", "--warmup", "40", "--draws", "4000",
        "--segment-size", "20", "--checkpoint-dir", ckdir,
        "--checkpoint-every", "1", "--quiet",
    ]
    proc = subprocess.Popen(
        args, env=ENV, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    # wait for at least one sampling-phase checkpoint, then kill -9
    deadline = time.time() + 300
    target = None
    while time.time() < deadline:
        tags = [
            f for f in os.listdir(ckdir)
            if f.startswith("meta_sample") and f.endswith(".json")
        ] if os.path.isdir(ckdir) else []
        if tags:
            target = sorted(tags)[-1]
            break
        if proc.poll() is not None:
            out, err = proc.communicate()
            raise AssertionError(
                f"sampler exited before checkpointing: {err.decode()[-800:]}"
            )
        time.sleep(0.2)
    assert target is not None, "no sampling checkpoint appeared in time"
    proc.send_signal(signal.SIGKILL)
    proc.wait()

    # resume runs only the REMAINDER of the draw budget (the CLI subtracts
    # the checkpoint's draws_done); shrink the total so the test is fast.
    # (a meta_*.json.tmp is a checkpoint still being written)
    latest = sorted(
        f for f in os.listdir(ckdir)
        if f.startswith("meta_sample") and f.endswith(".json")
    )[-1]
    with open(os.path.join(ckdir, latest)) as f:
        done = json.load(f)["draws_done"]
    r = subprocess.run(
        [
            PY, "-m", "nestmc", "run", "--preset", "eight-schools",
            "--chains", "4", "--warmup", "40", "--draws", str(done + 40),
            "--segment-size", "20", "--checkpoint-dir", ckdir,
            "--resume", "--quiet", "--metric-json",
        ],
        env=ENV, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert "resuming from" in r.stderr
    assert f"running the remaining 40 of {done + 40}" in r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["total_ess"] > 0
