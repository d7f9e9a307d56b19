"""Verification run for the two contested diagnostic conventions
(VERDICT r3 items 4 + 8), in ONE judged-shape (or config-5-shape) run:

1. **min-ESS floor coverage**: the min-ESS convention's floor claim
   ("log_tau[1] is the slowest parameter") was an extrapolation from ~40
   collected scalars out of 4,008. This run collects a SEEDED RANDOM
   sample of per-unit parameter blocks (RunConfig.collect now takes
   explicit index tuples) alongside mu/log_tau and checks whether any
   sampled scalar's bulk ESS undercuts the log_tau floor. Round 5
   (VERDICT r4 item 2): EVERY per-unit block is sampled (config 3 gets
   beta_g groups AND beta_s subjects), and when the data carries ragged
   group sizes the sample is STRATIFIED across size quantiles so the
   small-n groups — the plausible slowest mixers — are represented
   (config 4). Sampled floors remain upper bounds on the true minimum;
   results state the coverage fraction explicitly.

2. **R-hat statistic asymmetry**: the streamed full-parameter gate uses
   classic split R-hat while collected-scalar diagnostics use the
   stricter rank-normalized+folded variant. On the same collected draws
   this computes BOTH and reports the worst-case per-scalar delta.

    /opt/venv/bin/python -m benchmarks.verify_floor [--preset judged]
        [--sample-groups 64] [--chains N] [--out results]

Defaults run the exact judged configuration (preset 'judged' ==
bench.py); `--preset mala-100k` verifies config 5's floor the same way.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="judged")
    ap.add_argument("--sample-groups", type=int, default=64,
                    help="seeded random beta group units to collect "
                         "(64 groups x p coords = the 'few hundred random "
                         "betas' check at judged p=4)")
    ap.add_argument("--sample-seed", type=int, default=2026)
    ap.add_argument("--chains", type=int)
    ap.add_argument("--warmup", type=int)
    ap.add_argument("--draws", type=int)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="results")
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from nestmc.diagnostics import rhat, split_rhat
    from nestmc.engine import sample
    from nestmc.presets import get_preset, override_run

    model, data, cfg = get_preset(args.preset, seed=0, scale=args.scale)
    overrides = {
        k: v for k, v in (
            ("chains", args.chains), ("warmup", args.warmup),
            ("draws", args.draws),
        ) if v is not None
    }
    if overrides:
        cfg = override_run(cfg, **overrides)

    def _stratified(rng, n_units, k, sizes):
        """k unit indices stratified across size quantiles (small units
        guaranteed representation); uniform when sizes are constant."""
        k = min(k, n_units)
        sizes = None if sizes is None else np.asarray(sizes)
        if sizes is None or len(sizes) != n_units or sizes.min() == sizes.max():
            return tuple(sorted(
                int(i) for i in rng.choice(n_units, size=k, replace=False)
            ))
        order = np.argsort(sizes, kind="stable")
        strata = np.array_split(order, min(8, k))
        picked = []
        per = max(1, k // len(strata))
        for s in strata:
            take = min(per, len(s))
            picked.extend(rng.choice(s, size=take, replace=False).tolist())
        pool = np.setdiff1d(np.arange(n_units), np.asarray(picked, int))
        if len(picked) < k and len(pool):
            picked.extend(rng.choice(
                pool, size=min(k - len(picked), len(pool)), replace=False
            ).tolist())
        return tuple(sorted(int(i) for i in picked[:k]))

    # every per-unit parameter block in this preset's model (config 3 has
    # two: beta_g groups and beta_s subjects); each gets its own seeded
    # sample. Ragged group sizes (config 4) stratify the group-unit block.
    unit_blocks = [
        b for b in model.blocks
        if b.name.startswith("beta") and b.units and b.units > 1
    ]
    group_sizes = getattr(data, "sizes", None)
    if callable(group_sizes):  # RaggedData.sizes is a method
        group_sizes = group_sizes()
    if group_sizes is not None:
        group_sizes = np.asarray(group_sizes)
        if group_sizes.ndim != 1:
            group_sizes = None
    rng = np.random.default_rng(args.sample_seed)
    collect = dict(cfg.run.collect)
    sampled_idx, coverage = {}, {}
    for b in unit_blocks:
        sz = group_sizes if (
            group_sizes is not None and len(np.asarray(group_sizes)) == b.units
        ) else None
        idx = _stratified(rng, b.units, args.sample_groups, sz)
        sampled_idx[b.name] = idx
        coverage[b.name] = {
            "sampled": len(idx), "total": b.units,
            "fraction": len(idx) / b.units,
            "stratified_by_size": sz is not None,
        }
        collect[b.name] = idx
    cfg = override_run(cfg, collect=collect)
    if not cfg.run.full_rhat:
        # force full-R-hat streaming so the MEASURED all-param ESS floor
        # (posterior.min_ess_all_params) exists even for presets that do
        # not bake it (configs 3/4); thin=4 matches the config-5
        # convention and keeps the jnp Welford traffic ~1/4 (the thinned-
        # subsequence ESS is conservative — streaming_ess_finalize doc).
        cfg = override_run(cfg, full_rhat=True, full_rhat_thin=4)

    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    wall = time.perf_counter() - t0

    diag = post.diagnostics()
    sample_s = post.timings["sample_s"]
    n_dev = jax.device_count()

    # ---- 1. floor coverage over the random unit samples ----
    # "collected-scalar floor": min bulk ESS over every collected block
    # that is NOT one of the sampled unit blocks (mu + the log_tau levels)
    scalar_ess = {
        n: np.asarray(diag[n]["ess_bulk"])
        for n in diag if n not in sampled_idx
    }
    tau_block = min(scalar_ess, key=lambda n: float(scalar_ess[n].min()))
    tau_ess = scalar_ess[tau_block]
    tau_floor = float(tau_ess.min())
    floor = post.min_ess_argmin()
    per_block = {}
    beta_min = float("inf")
    beta_min_block, beta_min_unit, beta_min_coord = None, None, []
    for name, uidx in sampled_idx.items():
        e = np.asarray(diag[name]["ess_bulk"])
        mi = np.unravel_index(int(e.argmin()), e.shape)
        per_block[name] = {
            "min_ess": float(e.min()),
            "min_unit": int(uidx[int(mi[0])]),
            "min_coord": [int(i) for i in mi[1:]],
            "scalars": int(e.size),
            **coverage[name],
        }
        if float(e.min()) < beta_min:
            beta_min = float(e.min())
            beta_min_block = name
            beta_min_unit = int(uidx[int(mi[0])])
            beta_min_coord = [int(i) for i in mi[1:]]
    floor_holds = beta_min > tau_floor

    # ---- 2. classic vs rank-normalized+folded R-hat on the same draws ----
    # Chunk over scalars: rank normalization sorts the pooled (C*D) draws
    # per scalar and costs ~24 f32 copies of a (C, D) buffer per scalar in
    # eager temporaries, so the chunk is sized to a ~2 GB budget from the
    # run's actual (C, D) — the former fixed 16-scalar chunk OOM'd the
    # chip at config 3's 512 x 16384 schedule.
    stats = {}
    worst_delta = 0.0
    for name, x in post.draws.items():
        arr = np.asarray(x)
        C, D = arr.shape[:2]
        per_scalar = 24 * C * D * 4
        csize = max(1, int((2 << 30) // per_scalar))
        flat = arr.reshape(C, D, -1)
        classic_parts, ranknorm_parts = [], []
        for s in range(0, flat.shape[-1], csize):
            chunk = jnp.asarray(flat[:, :, s:s + csize])
            classic_parts.append(np.asarray(split_rhat(chunk)))
            ranknorm_parts.append(np.asarray(rhat(chunk)))
        classic = np.concatenate(classic_parts)
        ranknorm = np.concatenate(ranknorm_parts)  # rank-norm + folded
        stats[name] = {
            "classic_max": float(classic.max()),
            "ranknorm_max": float(ranknorm.max()),
            "max_abs_delta": float(np.abs(ranknorm - classic).max()),
        }
        worst_delta = max(worst_delta, stats[name]["max_abs_delta"])

    # ---- 3. streaming all-param ESS floor (round 5, VERDICT r4 item 5) --
    # when the preset streams full_rhat, the cross-chain estimator gives a
    # MEASURED min over ALL params (not a sampled upper bound); cross-check
    # it in situ: the same statistic on the collected sampled scalars vs
    # their FFT+Geyer bulk ESS (different estimators; ratio ~1 expected on
    # near-Gaussian posteriors)
    from nestmc.diagnostics import cross_chain_ess

    floor_all = post.min_ess_all_params()
    xcheck = {}
    for name in sampled_idx:
        cc = np.asarray(cross_chain_ess(post.draws[name])[0])
        fft = np.asarray(diag[name]["ess_bulk"])
        ratio = cc / np.maximum(fft, 1e-9)
        xcheck[name] = {
            "median_cc_over_fft": float(np.median(ratio)),
            "min_ratio": float(ratio.min()),
            "max_ratio": float(ratio.max()),
        }

    result = {
        "preset": args.preset,
        "chains": cfg.run.chains,
        "warmup": cfg.run.warmup,
        "draws": cfg.run.draws,
        "sample_seed": args.sample_seed,
        "streaming_all_param_floor": floor_all,
        "streaming_all_param_floor_per_sec_per_chip": (
            None if floor_all is None
            else floor_all["ess_lb"] / sample_s / n_dev
        ),
        "cross_chain_vs_fft_ess": xcheck,
        "sampled_blocks": per_block,
        "tau_floor_block": tau_block,
        "tau_floor_ess": tau_floor,
        "tau_floor_index": [int(i) for i in np.unravel_index(
            int(tau_ess.argmin()), tau_ess.shape)],
        # global argmin over EVERYTHING collected (incl. the unit samples)
        "global_floor": floor,
        "beta_sample_min_ess": beta_min,
        "beta_sample_min_block": beta_min_block,
        "beta_sample_min_group": beta_min_unit,
        "beta_sample_min_coord": beta_min_coord,
        "floor_holds": bool(floor_holds),
        "beta_over_tau_ratio": beta_min / max(tau_floor, 1e-9),
        "min_ess_per_sec_per_chip": min(beta_min, tau_floor)
        / sample_s / n_dev,
        "rhat_statistics": stats,
        "rhat_worst_abs_delta": worst_delta,
        "worst_rhat_all_params": post.worst_rhat(),
        "timings": {k2: round(v, 3) for k2, v in post.timings.items()},
        "wall_s": round(wall, 1),
    }
    print(json.dumps(result, indent=2))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        from benchmarks.run import git_revision

        git = git_revision() or "nogit"
        ts = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(
            args.out, f"verify-floor-{args.preset}_{git}_{ts}.json"
        )
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"[verify_floor] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
