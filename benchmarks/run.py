"""Benchmark harness: run any preset (or all), emit structured JSON.

    python -m benchmarks.run --preset hier-logistic-1k
    python -m benchmarks.run --all --scale 0.25 --out results

Metric conventions (fixed; see bench.py): ESS measured on retained draws
only; sampling wall-time as denominator; compile + warmup reported
separately; both sum-ESS and min-ESS rates emitted; worst split R-hat must
be printed next to any throughput number.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import time


def git_revision() -> str | None:
    """Short commit hash, or None in a copy that is not a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def run_preset(
    name: str, scale: float, seed: int,
    chain_shards: int | None = None, group_shards: int | None = None,
    algorithm: str | None = None,
    run_seed: int | None = None,
    **overrides,
) -> dict:
    import dataclasses

    import jax

    from nestmc.engine import sample
    from nestmc.presets import get_preset, override_run
    from nestmc.utils.device import card_info, device_summary

    model, data, cfg = get_preset(name, seed=seed, scale=scale)
    if run_seed is not None:
        # sampler-RNG seed only; the preset's synthetic data stays fixed
        overrides["seed"] = run_seed
    overrides = {k: v for k, v in overrides.items() if v is not None}
    if overrides:
        cfg = override_run(cfg, **overrides)
    if algorithm is not None:
        cfg = dataclasses.replace(
            cfg, kernel=dataclasses.replace(cfg.kernel, algorithm=algorithm)
        )
    shard_over = {
        k: v for k, v in
        (("chain_shards", chain_shards), ("group_shards", group_shards))
        if v is not None
    }
    if shard_over:
        cfg = dataclasses.replace(
            cfg,
            sharding=dataclasses.replace(cfg.sharding, **shard_over),
        )
    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    wall = time.perf_counter() - t0
    n_chips = jax.device_count()
    sample_s = max(post.timings.get("sample_s", wall), 1e-9)
    total_sweeps = cfg.run.warmup + cfg.run.draws * max(1, cfg.run.thin)
    hot_s = post.timings.get("warmup_s", 0.0) + sample_s
    return {
        "preset": name,
        "scale": scale,
        "model": model.name,
        "loglik_impl": model.loglik_impls.get("selected", "jnp"),
        "device": device_summary(),
        "card": card_info(),
        "n_devices": n_chips,
        "chains": cfg.run.chains,
        "warmup": cfg.run.warmup,
        "draws": cfg.run.draws,
        "total_ess": post.total_ess(),
        "min_ess": post.min_ess(),
        "min_ess_floor": post.min_ess_argmin(),
        "worst_rhat": post.worst_rhat(),
        # self-describing convergence coverage (VERDICT r2 weak #1): "all"
        # means the streamed full-parameter split-R-hat accumulators gate
        # every sampled unit of every block; "collected" means only the
        # retained scalars were checked.
        "rhat_coverage": "all" if post.full_rhat is not None
        else "collected",
        "full_rhat_thin": cfg.run.full_rhat_thin,
        "ess_per_sec_per_chip": post.total_ess() / sample_s / n_chips,
        "min_ess_per_sec_per_chip": post.min_ess() / sample_s / n_chips,
        # measured min over ALL params (streamed cross-chain estimator +
        # 95% lower bound; None unless the run streamed full_rhat)
        "min_ess_all_params": post.min_ess_all_params(),
        # SURVEY section 3.5's original convention (warmup IN the
        # denominator) alongside the fixed sampling-phase convention; the
        # two diverge most on small configs, where warmup is a large
        # share of the wall time
        "ess_per_sec_per_chip_incl_warmup":
            post.total_ess() / hot_s / n_chips,
        "sweeps_per_sec": total_sweeps / max(hot_s, 1e-9),
        "accept_rates": {
            k: float(v.mean()) for k, v in post.accept_rates.items()
        },
        "timings": {k: round(v, 4) for k, v in post.timings.items()},
        "wall_s": round(wall, 2),
        "config": post.config,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--run-seed", type=int,
        help="override RunConfig.seed ONLY (chain init + proposal RNG), "
             "keeping the preset's synthetic data fixed — isolates "
             "sampler-seed variance (e.g. of a gate margin) from "
             "data-realization variance",
    )
    ap.add_argument("--out", help="directory for result JSON files")
    # schedule overrides (convergence campaigns tune these per config
    # without touching the preset definitions)
    ap.add_argument("--chains", type=int)
    ap.add_argument("--warmup", type=int)
    ap.add_argument("--draws", type=int)
    ap.add_argument("--segment-size", type=int)
    ap.add_argument("--chain-shards", type=int)
    ap.add_argument("--group-shards", type=int)
    # kernel overrides (A/B experiments without touching the presets)
    ap.add_argument(
        "--algorithm", choices=["rwmh", "mala", "newton"],
        help="override KernelConfig.algorithm for the preset",
    )
    ap.add_argument(
        "--full-rhat-thin", type=int,
        help="fold every k-th retained draw into the streaming R-hat "
             "accumulators (RunConfig.full_rhat_thin); cuts the Welford "
             "pass's HBM traffic by k on huge-G runs",
    )
    ap.add_argument(
        "--full-rhat", action="store_true",
        help="stream split R-hat over EVERY sampled unit of every block "
             "(not just collected scalars); worst_rhat then covers the "
             "full parameter vector and rhat_coverage='all'",
    )
    args = ap.parse_args()

    from nestmc.presets import PRESETS

    names = list(PRESETS) if args.all else [args.preset]
    if not names or names[0] is None:
        ap.error("--preset NAME or --all required")

    from nestmc.utils.device import enable_compile_cache

    enable_compile_cache()
    meta = {
        "host": platform.node(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git": git_revision(),
    }
    results = []
    for name in names:
        res = run_preset(
            name, args.scale, args.seed,
            chains=args.chains, warmup=args.warmup, draws=args.draws,
            run_seed=args.run_seed,
            segment_size=args.segment_size,
            full_rhat=args.full_rhat or None,
            full_rhat_thin=args.full_rhat_thin,
            chain_shards=args.chain_shards,
            group_shards=args.group_shards,
            algorithm=args.algorithm,
        )
        res["meta"] = meta
        print(json.dumps(res, default=str))
        results.append(res)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = os.path.join(
                args.out,
                f"{name}_{meta['git'] or 'nogit'}_"
                f"{time.strftime('%Y%m%d_%H%M%S')}.json",
            )
            with open(fn, "w") as f:
                json.dump(res, f, indent=2, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
