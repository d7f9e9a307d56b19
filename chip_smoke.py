"""Quickest proof that nestmc runs on the GPU: `python chip_smoke.py`.

Default run (one card), phases in order; any failure exits non-zero and
no result line is printed:

1. device   - JAX must report a GPU (never continues on the CPU); prints
              the device kind and count, the JAX version, and the card's
              name and power limit (nvidia-smi).
2. parity   - each obs-pass GPU kernel against the jnp reference
              (ops/loglik.py) at real widths: the judged cell
              (C=1024, G=1000, n=50, p=4) for the logistic family and
              config 3 (C=512, S=4000, n=10, p=3) for the Poisson family;
              and the jnp reference on the GPU against the same function
              on the CPU (a float32 contraction that silently ran in TF32
              would show here).
3. judged   - the judged preset end to end through nestmc.engine.sample,
              as bench.py runs it: 1,024 chains, 1,500 warmup + 4,096
              draws, frozen-metric Newton, streaming all-parameter split
              R-hat, which must be < 1.01.
4. tests    - `pytest -m gpu` in this same process (a second JAX process
              could not reserve the card's memory).

`python chip_smoke.py --four-cards` runs only the two sharded deployments
(ragged-10k chain-sharded over 4 cards; mala-100k on a 2 x 2 chains x
groups mesh) at full width for a short fixed schedule, each on the 4-card
mesh and twice on one card with the same seed, and compares draws and
carry within the tolerance stated at FOUR_CARD_CASES.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# float32 reductions over <= 64 terms in another order: the kernel and the
# reference agree to a few ulps of the sums; a TF32 contraction (10-bit
# mantissa) would be off by ~1e-3 relative
PARITY_RTOL = 1e-4
CARD = "card ?"


def say(*parts):
    print(f"[{CARD}]", *parts, flush=True)


def phase_device():
    import jax

    global CARD
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devs[0].platform!r}); refusing to run", file=sys.stderr)
        raise SystemExit(2)
    from nestmc.utils.device import card_info, enable_compile_cache

    card = card_info()
    if card is None:
        print("chip_smoke: nvidia-smi gave no card name", file=sys.stderr)
        raise SystemExit(2)
    CARD = card.splitlines()[0]
    print(card, flush=True)
    say(f"device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__} compile_cache={enable_compile_cache()}")
    return devs


def _rel_err(got, want):
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    return float(diff.max()), float((diff / np.maximum(np.abs(want),
                                                       1.0)).max())


def phase_parity():
    import jax

    from benchmarks.loglik_kernels import _case
    from nestmc.ops.dispatch import KERNEL_FAMILIES, padded_obs_pass

    cells = {
        "logistic": (1024, 1000, 50, 4),
        "poisson": (512, 4000, 10, 3),
    }
    cpu = jax.devices("cpu")[0]
    for family, (C, G, n, p) in cells.items():
        args = _case(family, C, G, n, p)
        ref = padded_obs_pass(family, "jnp")
        # the reference itself: GPU vs CPU, value+grad+Hessian
        on_gpu = jax.jit(ref[2])(*args)
        on_cpu = jax.jit(ref[2])(*jax.device_put(args, cpu))
        for name, a, b in zip(("v", "g", "h"), on_gpu, on_cpu):
            ae, re = _rel_err(a, b)
            say(f"parity jnp gpu-vs-cpu {family} {name} C={C} G={G} n={n} "
                f"p={p}: max_abs={ae:.3e} max_rel={re:.3e} "
                f"tol_rel={PARITY_RTOL:g} float32 Precision.HIGHEST")
            assert re <= PARITY_RTOL, (family, name, re)
        if family not in KERNEL_FAMILIES:
            continue
        ker = padded_obs_pass(family, "triton", dense=True)
        for outputs, kf, rf in zip(("v", "vg", "vgh"), ker, ref):
            got = jax.jit(kf)(*args)
            want = jax.jit(rf)(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [_rel_err(a, b) for a, b in zip(got, want)]
            ae = max(e[0] for e in errs)
            re = max(e[1] for e in errs)
            say(f"parity triton-vs-jnp {family} {outputs} C={C} G={G} "
                f"n={n} p={p}: max_abs={ae:.3e} max_rel={re:.3e} "
                f"tol_rel={PARITY_RTOL:g} float32 Precision.HIGHEST")
            assert re <= PARITY_RTOL, (family, outputs, re)


def phase_judged():
    import jax
    import numpy as np

    from nestmc.engine import sample
    from nestmc.kernels.gibbs import make_sweep
    from nestmc.presets import get_preset

    model, data, cfg = get_preset("judged", seed=0)
    n_dev = len(jax.devices())
    assert cfg.run.chains == 1024 * n_dev and cfg.run.full_rhat
    say(f"judged: G={data.num_groups} n={data.y.shape[1]} "
        f"p={data.num_covariates} chains={cfg.run.chains} "
        f"warmup={cfg.run.warmup} draws={cfg.run.draws} "
        f"loglik={model.loglik_impls['selected']}")
    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    wall = time.perf_counter() - t0
    for name, v in post.draws.items():
        assert np.all(np.isfinite(np.asarray(v))), name
    worst = post.worst_rhat()
    t = post.timings
    sweeps = cfg.run.warmup + cfg.run.draws
    compile_s = t.get("warmup_compile_s", 0.0) + t.get("sample_compile_s", 0.0)
    ess_sum = post.total_ess() / t["sample_s"] / n_dev
    ess_min = post.min_ess() / t["sample_s"] / n_dev
    say(f"judged: wall={wall:.2f}s warmup={t['warmup_s']:.3f}s "
        f"sample={t['sample_s']:.3f}s compile={compile_s:.2f}s "
        f"sweeps/s={sweeps / (t['warmup_s'] + t['sample_s']):.1f} "
        f"sample_sweeps/s={cfg.run.draws / t['sample_s']:.1f}")
    say(f"judged: sum-ESS/s/chip={ess_sum:.1f} min-ESS/s/chip={ess_min:.1f} "
        f"worst_all_param_rhat={worst:.5f} (gate < 1.01)")
    sweep = make_sweep(model, cfg)
    step = jax.jit(lambda s, d: sweep(s, d, adapt=False))
    mem = step.lower(post.final_state, data).compile().memory_analysis()
    say(f"judged: sampling-step memory_analysis: {mem}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"judged: peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    assert worst < 1.01, f"worst all-param split R-hat {worst:.5f} >= 1.01"


def phase_tests():
    import pytest

    os.environ["NESTMC_GPU_TESTS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main([
        "-q", "-m", "gpu", os.path.join(here, "tests"),
        "-p", "no:cacheprovider",
    ])
    say(f"pytest -m gpu exit code {int(rc)}")
    assert int(rc) == 0, f"pytest -m gpu failed ({int(rc)})"


# (preset, (chain_shards, group_shards) on four cards). Each preset runs
# on the 4-card mesh, on one card, and on one card again with the same
# seed. On the CPU chain sharding is bitwise (tests/test_four_cards.py);
# on the GPU neither preset can be: ragged-10k's segment sums are
# scatter-adds whose float32 order is not fixed from run to run (the two
# one-card runs differ too), and mala-100k's group psum sums partials in
# another order. A sum that moves by a few ulps flips an MH decision whose
# log-ratio sits that close to its uniform, and the flipped chain follows
# another path from then on. So the 4-card run must agree with the
# one-card run as closely as the one-card run agrees with itself: for
# every draw and carry leaf at most FOUR_CARD_FRAC of the entries may
# differ beyond 1e-4 (relative, floor 1), and the leaf's means over chains
# must agree to FOUR_CARD_MEAN (relative, floor 1; one flipped chain of
# C >= 512 moves a mean by |jump| / C). Readings on H100s, 10 + 10
# sweeps: ragged-10k, one card against itself, worst fraction 4.9e-3 to
# 5.2e-3 and chain-mean error 1.8e-3 to 3.1e-3; 4 cards against one,
# 5.5e-3 to 1.0e-2 and 3.1e-3. mala-100k: one card is bitwise
# reproducible; 4 cards against one, 1.6e-2 and 5.8e-3.
FOUR_CARD_CASES = (
    ("ragged-10k", (4, 1)),
    ("mala-100k", (2, 2)),
)
FOUR_CARD_FRAC = 2e-2
FOUR_CARD_MEAN = 1e-2
FOUR_CARD_SCHEDULE = dict(warmup=10, draws=10, segment_size=10,
                          log_every_segment=False)


def run_preset(name, shards, scale=1.0, schedule=None):
    """Sample preset ``name`` with its seed on a (chain_shards,
    group_shards) mesh for a short fixed schedule; returns the posterior."""
    import dataclasses

    from nestmc.config import ShardingConfig
    from nestmc.engine import sample
    from nestmc.presets import get_preset, override_run

    model, data, cfg = get_preset(name, seed=0, scale=scale)
    cfg = override_run(cfg, **(schedule or FOUR_CARD_SCHEDULE))
    cfg = dataclasses.replace(cfg, sharding=ShardingConfig(
        chain_shards=shards[0], group_shards=shards[1]))
    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    say(f"{name}: G={data.num_groups} chains={cfg.run.chains} mesh "
        f"chains x groups = {shards[0]} x {shards[1]}, "
        f"{time.perf_counter() - t0:.1f}s (compile included) "
        f"loglik={model.loglik_impls['selected']}")
    return post


def compare(label, a, b):
    """Draws and final carry of ``a`` against ``b``, leaf by leaf; prints
    each and returns (bitwise, worst fraction of entries beyond 1e-4,
    worst chain-mean relative error)."""
    import jax
    import numpy as np

    def leaves(post):
        return {
            **{f"draws.{k}": v for k, v in post.draws.items()},
            **{f"position.{k}": v
               for k, v in post.final_state.position.items()},
        }

    other = leaves(b)
    all_same = True
    worst_frac = worst_mean = 0.0
    for k, v in leaves(a).items():
        x = np.asarray(jax.device_get(v), np.float64)
        y = np.asarray(jax.device_get(other[k]), np.float64)
        assert x.shape == y.shape and np.all(np.isfinite(x)), k
        same = np.array_equal(x, y)
        all_same &= same
        diff = np.abs(x - y)
        frac = float(np.mean(diff > 1e-4 * np.maximum(np.abs(y), 1.0)))
        mx, my = x.mean(axis=0), y.mean(axis=0)
        mean_err = float(np.max(np.abs(mx - my)
                                / np.maximum(np.abs(my), 1.0)))
        worst_frac = max(worst_frac, frac)
        worst_mean = max(worst_mean, mean_err)
        say(f"{label}: {k} bitwise={same} max_abs_diff={diff.max():.3e} "
            f"frac_entries_beyond_1e-4={frac:.3e} "
            f"chain_mean_rel_err={mean_err:.3e}")
    say(f"{label}: bitwise={all_same} worst_frac={worst_frac:.3e} "
        f"worst_chain_mean_rel_err={worst_mean:.3e}")
    return all_same, worst_frac, worst_mean


def four_cards(cases=FOUR_CARD_CASES, scale: float = 1.0, schedule=None):
    """Each sharded deployment on the 4-card mesh against one card, and
    one card against itself. Every case runs and prints before any is
    judged."""
    verdicts = []
    for name, shards in cases:
        four = run_preset(name, shards, scale, schedule)
        one = run_preset(name, (1, 1), scale, schedule)
        again = run_preset(name, (1, 1), scale, schedule)
        compare(f"{name} 1-card vs 1-card", again, one)
        verdicts.append((name, compare(f"{name} 4-card vs 1-card", four,
                                       one)))
    for name, (_, frac, mean) in verdicts:
        ok = frac <= FOUR_CARD_FRAC and mean <= FOUR_CARD_MEAN
        say(f"{name}: 4-card vs 1-card worst_frac={frac:.3e} "
            f"(limit {FOUR_CARD_FRAC:g}), worst_chain_mean_rel_err="
            f"{mean:.3e} (limit {FOUR_CARD_MEAN:g}): "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, f"{name}: 4-card and 1-card results disagree"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="only the 4-card vs 1-card comparison of the two "
                         "sharded presets (needs 4 GPUs)")
    args = ap.parse_args(argv)
    devs = phase_device()
    if args.four_cards:
        if len(devs) != 4:
            print(f"chip_smoke --four-cards: needs 4 GPUs, have "
                  f"{len(devs)}", file=sys.stderr)
            return 2
        four_cards()
    else:
        for phase in (phase_parity, phase_judged, phase_tests):
            t0 = time.perf_counter()
            phase()
            say(f"phase {phase.__name__[6:]} ok "
                f"({time.perf_counter() - t0:.1f}s)")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
