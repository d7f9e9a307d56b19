"""Driver benchmark: the judged metric on the judged model.

Runs the 1k-group hierarchical logistic model (BASELINE.json:2) on the
first JAX backend's devices and prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Metric: effective samples/sec/chip = sum of bulk-ESS over all collected
scalar parameters / sampling wall-seconds / chips. Conventions (fixed once,
SURVEY.md section 7.3 item 6): compile time excluded (reported separately in
stderr), warmup time excluded from the denominator, ESS measured on retained
draws only, collected params = mu (4) + log_tau (4) + first 8 groups' beta
(32) = 40 scalars. Every line names the device it ran on (platform, kind,
count, and the card's name and power limit where nvidia-smi exists).
"""

import json
import os
import sys
import time


def main() -> int:
    os.environ.setdefault("NESTMC_BENCH", "1")
    import jax

    import nestmc  # noqa: F401  (enables partitionable RNG)
    from nestmc.utils.device import (
        card_info,
        device_summary,
        enable_compile_cache,
    )
    from nestmc.config import (
        KernelConfig,
        RunConfig,
        SamplerConfig,
        ShardingConfig,
    )
    from nestmc.engine import sample
    from nestmc.models import make_hier_logistic, synth_logistic

    enable_compile_cache()
    n_dev = jax.device_count()
    device = device_summary()
    card = card_info()

    # The judged model: 1k groups x 50 obs, p=4.
    data, _ = synth_logistic(jax.random.key(2000), G=1000, n=50, p=4)
    chains_per_chip = int(
        os.environ.get("NESTMC_BENCH_CHAINS_PER_CHIP", 1024)
    )
    warmup = int(os.environ.get("NESTMC_BENCH_WARMUP", 1500))
    draws = int(os.environ.get("NESTMC_BENCH_DRAWS", 4096))
    # Frozen-metric Newton: Laplace-proposal group updates with the
    # likelihood Hessian refreshed during warmup and frozen for the
    # sampling phase (KernelConfig.newton_freeze), so the sampling obs pass
    # costs the same as MALA's while beta mixes near-IID, and the joint
    # (mu, tau) interweave runs parameter-free off the same metric.
    algorithm = os.environ.get("NESTMC_BENCH_ALGORITHM", "newton")
    # conjugate invgamma tau: an exact Gibbs draw of the tau block
    tau_prior = os.environ.get("NESTMC_BENCH_TAU_PRIOR", "invgamma")
    asis_repeats = int(os.environ.get("NESTMC_BENCH_ASIS_REPEATS", 1))
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(
            chains=chains_per_chip * n_dev,
            warmup=warmup,
            draws=draws,
            seed=0,
            segment_size=2048,
            collect={"mu": None, "log_tau": None, "beta": 8},
            # stream split R-hat over EVERY unit of every block (all 1000
            # groups' betas, not just the 8 collected) so the <1.01 gate
            # below covers all parameters (SURVEY.md section 3.5)
            full_rhat=True,
            log_every_segment=False,
        ),
        sharding=ShardingConfig(chain_shards=n_dev),
    )
    model = make_hier_logistic(
        data, tau_prior=tau_prior, asis_repeats=asis_repeats
    )

    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    wall = time.perf_counter() - t0

    sample_s = post.timings["sample_s"]
    total_ess = post.total_ess()
    min_ess = post.min_ess()
    floor = post.min_ess_argmin()
    # worst split R-hat over ALL parameters (streamed full_rhat covers every
    # beta unit; the diagnostics pass covers the collected scalars)
    worst_rhat = post.worst_rhat()
    value = total_ess / sample_s / n_dev
    min_ess_rate = min_ess / sample_s / n_dev

    print(
        f"[bench] device={device['platform']}/{device['kind']} "
        f"devices={n_dev} card={card} "
        f"chains={cfg.run.chains} wall={wall:.1f}s "
        f"sample={sample_s:.2f}s warmup={post.timings['warmup_s']:.2f}s "
        f"compile={post.timings.get('warmup_compile_s', 0) + post.timings.get('sample_compile_s', 0):.1f}s "
        f"total_ess={total_ess:.0f} min_ess={min_ess:.0f} "
        f"worst_rhat={worst_rhat:.4f} "
        f"sweeps/s={(warmup + draws) / (post.timings['warmup_s'] + sample_s):.0f}",
        file=sys.stderr,
    )
    if floor is not None:
        # attribute the min-ESS floor so it is an actionable target, not
        # just a rate (VERDICT r2 item 2)
        print(
            f"[bench] min-ESS floor: block={floor['block']} "
            f"index={floor['index']} ess={floor['ess']:.0f}",
            file=sys.stderr,
        )
    # measured min ESS over ALL parameters (cross-chain mean-functional
    # estimator on the streamed full-R-hat accumulators + one-sided 95%
    # lower confidence bound) — the floor is no longer an extrapolation
    # from collected scalars (VERDICT r4 item 5)
    floor_all = post.min_ess_all_params()
    if floor_all is not None:
        print(
            f"[bench] all-param ESS floor (cross-chain): "
            f"block={floor_all['block']} index={floor_all['index']} "
            f"ess={floor_all['ess']:.0f} ess_lb95={floor_all['ess_lb']:.0f}",
            file=sys.stderr,
        )

    # Convergence gate (SURVEY.md section 3.5 / BASELINE.json:5): the
    # throughput number is meaningless if the chains have not converged.
    assert worst_rhat < 1.01, (
        f"worst split R-hat {worst_rhat:.4f} >= 1.01 over all parameters — "
        "benchmark rejected"
    )

    print(json.dumps({
        "metric": "effective_samples_per_sec_per_chip "
                  "(1k-group hierarchical logistic; worst split R-hat over "
                  f"ALL {4 + 4 + 1000 * 4} params {worst_rhat:.4f}; "
                  "sum-of-bulk-ESS over 40 collected scalars convention; "
                  f"min-ESS convention: {min_ess_rate:.0f}/s/chip)",
        "value": round(value, 1),
        "unit": "ESS/s/chip",
        "device": device,
        "card": card,
        "min_ess_per_sec_per_chip": round(min_ess_rate, 1),
        "worst_rhat_all_params": round(worst_rhat, 5),
        "min_ess_floor": (
            f"{floor['block']}{list(floor['index'])}" if floor else None
        ),
        # measured over ALL 4008 params via the streamed cross-chain
        # estimator (mean-functional; see nestmc/diagnostics.py): the
        # min-ESS convention's floor with a 95% lower confidence bound
        "min_ess_all_params": (
            round(floor_all["ess"], 1) if floor_all else None
        ),
        "min_ess_all_params_lb95_per_sec_per_chip": (
            round(floor_all["ess_lb"] / sample_s / n_dev, 1)
            if floor_all else None
        ),
        "min_ess_all_floor": (
            f"{floor_all['block']}{list(floor_all['index'])}"
            if floor_all else None
        ),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
