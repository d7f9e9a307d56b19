"""The fused Triton obs-pass kernel against the jnp path, alone and end to end.

    python -m benchmarks.loglik_kernels [--end-to-end PRESET ...] [--out FILE]

On the GPU, for each likelihood family at the widths of the cell it serves
(logistic: the judged cell, C=1024 chains, G=1000 groups, n=50, p=4;
poisson: config 3, C=512, S=4000 subjects, n=10, p=3) and each output set
("v", "vg", "vgh"), it times
  - the jnp reference as the models run it (value; value+grad through
    jax.vjp; the fused jnp value+grad+Hessian of ops/loglik.py),
  - the kernel,
and prints the kernel's largest absolute and relative error against the
reference. Times are host-clock medians of back-to-back calls ending in
block_until_ready; the first call's time (compile included) is reported
apart.

``--end-to-end judged nested-poisson-1k nested-poisson-1k-newton`` then
samples each named preset with its model built on each implementation in
turn (kernel, jnp, jnp, kernel, same data and seed) and prints sweeps/s
and ESS/s of each run.
Exits non-zero off the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _time(fn, args, iters=40, reps=5):
    """(median seconds per call, seconds of the first call)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))          # compile + warm
    first = time.perf_counter() - t0
    best = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best.append((time.perf_counter() - t0) / iters)
    best.sort()
    return best[len(best) // 2], first


def _err(a, b):
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    diff = np.abs(a - b)
    rel = diff / np.maximum(np.abs(b), 1.0)
    return float(diff.max()), float(rel.max())


def _case(family, C, G, n, p, seed=0):
    import jax
    import jax.numpy as jnp

    k = jax.random.split(jax.random.key(seed), 4)
    x = jax.random.normal(k[0], (G, n, p), jnp.float32)
    x = x.at[:, :, 0].set(1.0)
    if family == "poisson":
        x = 0.5 * x
        beta = 0.3 * jax.random.normal(k[1], (C, G, p), jnp.float32)
        y = jax.random.poisson(k[2], 2.0, (G, n)).astype(jnp.float32)
    else:
        beta = 0.5 * jax.random.normal(k[1], (C, G, p), jnp.float32)
        y = jax.random.bernoulli(k[2], 0.5, (G, n)).astype(jnp.float32)
    mask = jnp.ones((G, n), jnp.float32)
    return beta, x, y, mask


def _references(family):
    import jax

    from nestmc.ops.dispatch import padded_obs_pass

    return {k: jax.jit(f) for k, f in
            zip(("v", "vg", "vgh"), padded_obs_pass(family, "jnp"))}


def run() -> list[dict]:
    import functools

    import jax

    from nestmc.ops.loglik_triton import fused_loglik
    from nestmc.utils.device import card_info, device_summary

    dev = device_summary()
    card = card_info()
    rows = []
    cells = {
        "logistic": (1024, 1000, 50, 4),
        "poisson": (512, 4000, 10, 3),
    }
    for family, (C, G, n, p) in cells.items():
        args = _case(family, C, G, n, p)
        refs = _references(family)
        for outputs in ("v", "vg", "vgh"):
            t_ref, first_ref = _time(refs[outputs], args)
            fn = jax.jit(functools.partial(
                fused_loglik, family=family, outputs=outputs, dense=True))
            t_ker, first_ker = _time(fn, args)
            got = fn(*args)
            want = refs[outputs](*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [_err(a, b) for a, b in zip(got, want)]
            row = {
                "family": family, "outputs": outputs,
                "C": C, "G": G, "n": n, "p": p,
                "jnp_us": t_ref * 1e6, "jnp_first_call_s": first_ref,
                "kernel_us": t_ker * 1e6, "kernel_first_call_s": first_ker,
                "max_abs_err": max(e[0] for e in errs),
                "max_rel_err": max(e[1] for e in errs),
                "device": dev, "card": card,
            }
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _rebuild(preset, data, impl):
    from nestmc.models import make_hier_logistic, make_nested_poisson

    if preset in ("judged", "hier-logistic-1k"):
        return make_hier_logistic(data, tau_prior="invgamma",
                                  loglik_impl=impl)
    if preset in ("nested-poisson-1k", "nested-poisson-1k-newton"):
        return make_nested_poisson(data, tau_prior="invgamma",
                                   loglik_impl=impl)
    raise ValueError(f"no end-to-end A/B for preset {preset!r}")


def end_to_end(preset: str, order=("triton", "jnp", "jnp", "triton"),
               **overrides) -> list[dict]:
    """Sample ``preset`` once per entry of ``order``, the model built on
    that obs-pass implementation; same data, seed and schedule."""
    import jax

    from nestmc.engine import sample
    from nestmc.presets import get_preset, override_run
    from nestmc.utils.device import card_info, device_summary

    _, data, cfg = get_preset(preset, seed=0)
    if overrides:
        cfg = override_run(cfg, **overrides)
    n_dev = jax.device_count()
    rows = []
    for impl in order:
        model = _rebuild(preset, data, impl)
        t0 = time.perf_counter()
        post = sample(model, data, cfg)
        wall = time.perf_counter() - t0
        t = post.timings
        row = {
            "preset": preset, "loglik_impl": model.loglik_impls["selected"],
            "chains": cfg.run.chains, "warmup": cfg.run.warmup,
            "draws": cfg.run.draws, "wall_s": wall,
            "warmup_s": t["warmup_s"], "sample_s": t["sample_s"],
            "compile_s": t.get("warmup_compile_s", 0.0)
            + t.get("sample_compile_s", 0.0),
            "warmup_sweeps_per_s": cfg.run.warmup / t["warmup_s"],
            "sample_sweeps_per_s": cfg.run.draws * max(1, cfg.run.thin)
            / t["sample_s"],
            "sum_ess_per_s_per_chip": post.total_ess() / t["sample_s"]
            / n_dev,
            "min_ess_per_s_per_chip": post.min_ess() / t["sample_s"] / n_dev,
            "worst_rhat": post.worst_rhat(),
            "device": device_summary(), "card": card_info(),
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--end-to-end", nargs="*", default=[],
                    metavar="PRESET",
                    help="A/B the obs-pass implementations end to end on "
                         "these presets (judged, nested-poisson-1k, "
                         "nested-poisson-1k-newton)")
    ap.add_argument("--order", default="triton,jnp,jnp,triton",
                    help="implementations in run order for --end-to-end")
    ap.add_argument("--draws", type=int,
                    help="sampling draws of each end-to-end run (default: "
                         "the preset's)")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args()

    import jax

    from nestmc.utils.device import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print("loglik_kernels: no GPU; nothing measured", file=sys.stderr)
        return 1
    enable_compile_cache()
    rows = run()
    for preset in args.end_to_end:
        rows += end_to_end(preset, order=tuple(args.order.split(",")),
                           **({"draws": args.draws} if args.draws else {}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
