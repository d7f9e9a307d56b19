"""Attribute the judged config's min-ESS floor: is log_tau's mixing capped
by its conjugate sufficient statistic?

tau_k's Gibbs draw is invgamma(a + G/2, b + s2_k/2) with s2_k = sum_g
(beta_gk - mu_k)^2, so between-draw dependence of log_tau can only come
through s2 (plus the interweaving moves, which also act through beta).
Comparing per-coordinate bulk ESS of log_tau vs the derived log_s2
(models/hier_logistic.py ModelSpec.derived) therefore separates:

  ESS(log_tau) ~= ESS(log_s2)  -> the floor IS beta-spread mixing; better
                                  tau moves cannot lift it (structural cap)
  ESS(log_tau) << ESS(log_s2)  -> the tau moves themselves waste mixing;
                                  a better move (more ASIS passes, etc.)
                                  has headroom

    /opt/venv/bin/python -m benchmarks.floor_cap [--chains 1024]

Defaults mirror bench.py's judged configuration (round 3: fused frozen-
metric Newton step + conjugate invgamma tau + joint Laplace interweave;
--algorithm mala reproduces the round-2 measurement).
"""

from __future__ import annotations

import argparse
import json
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=1500)
    ap.add_argument("--draws", type=int, default=4096)
    ap.add_argument(
        "--algorithm", default="newton", choices=["rwmh", "mala", "newton"]
    )
    args = ap.parse_args()

    import jax
    import numpy as np

    from nestmc.config import KernelConfig, RunConfig, SamplerConfig
    from nestmc.diagnostics import ess
    from nestmc.engine import sample
    from nestmc.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(jax.random.key(2000), G=1000, n=50, p=4)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm=args.algorithm),
        run=RunConfig(
            chains=args.chains, warmup=args.warmup, draws=args.draws,
            seed=0, segment_size=4096,
            collect={"log_tau": None, "log_s2": None},
            log_every_segment=False,
        ),
    )
    t0 = time.perf_counter()
    post = sample(model, data, cfg)
    wall = time.perf_counter() - t0

    lt = np.asarray(post.draws["log_tau"])   # (C, T, p)
    ls = np.asarray(post.draws["log_s2"])    # (C, T, p)
    p = lt.shape[-1]
    rows = []
    for k in range(p):
        e_tau = float(ess(lt[..., k]))
        e_s2 = float(ess(ls[..., k]))
        rows.append({
            "k": k,
            "ess_log_tau": round(e_tau, 1),
            "ess_log_s2": round(e_s2, 1),
            "ratio_tau_over_s2": round(e_tau / max(e_s2, 1e-9), 3),
        })
    print(json.dumps({
        "algorithm": args.algorithm,
        "chains": args.chains,
        "draws": args.draws,
        "pooled_draws": int(lt.shape[0] * lt.shape[1]),
        "per_coordinate": rows,
        "sample_s": round(post.timings["sample_s"], 2),
        "wall_s": round(wall, 1),
    }, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
