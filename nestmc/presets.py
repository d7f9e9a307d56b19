"""Named presets for the five BASELINE.json:7-11 benchmark configs.

Each preset builds (model, data, SamplerConfig) from a seed. Sizes follow the
driver spec; `scale` lets the CLI/benchmarks shrink a preset for smoke tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace

import jax

from nestmc.config import (
    KernelConfig,
    RunConfig,
    SamplerConfig,
    ShardingConfig,
)
from nestmc.models import (
    make_eight_schools,
    make_hier_logistic,
    make_nested_poisson,
    synth_logistic,
    synth_poisson3,
)


def _eight_schools(seed: int, scale: float):
    """Config 1 (BASELINE.json:7): 8-schools, 4 chains x 10k draws, RW-MH."""
    model, data = make_eight_schools()
    # one scan segment: at 4 chains the model sweeps >10k/s; per-segment
    # host syncs would dominate wall time otherwise (see config 2 note)
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="rwmh"),
        run=RunConfig(
            chains=4,
            warmup=max(100, int(1000 * scale)),
            draws=max(100, int(10_000 * scale)),
            seed=seed,
            segment_size=10_000,
        ),
    )
    return model, data, cfg


def _hier_logistic_100(seed: int, scale: float):
    """Config 2 (BASELINE.json:8): 100 groups x 50 obs, 64 chains.

    Frozen-metric Newton default: BASELINE.json:8 pins 'MH-within-Gibbs',
    which Newton-MH satisfies (it IS an MH block move, with a Laplace
    proposal); the Laplace proposal attacks the group-block mixing floor
    that adaptive RW-MH leaves. The RW state stays reproducible as
    `hier-logistic-100-rw`."""
    data, _ = synth_logistic(
        jax.random.key(seed + 1000), G=100, n=50, p=4
    )
    model = make_hier_logistic(data, tau_prior="invgamma")
    # one scan segment for the whole schedule: a small model sweeps
    # thousands of times a second, so per-segment host syncs would show
    # in its wall time
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(
            chains=64,
            warmup=max(50, int(1500 * scale)),
            draws=max(50, int(4096 * scale)),
            seed=seed,
            segment_size=4096,
            collect={"mu": None, "log_tau": None, "beta": 16},
        ),
    )
    return model, data, cfg


def _hier_logistic_100_rw(seed: int, scale: float):
    """Config 2 with adaptive RW-MH + a half-normal tau MH block."""
    _, data, cfg = _hier_logistic_100(seed, scale)
    model = make_hier_logistic(data)
    return model, data, dataclasses.replace(
        cfg, kernel=dataclasses.replace(cfg.kernel, algorithm="rwmh")
    )


def _hier_logistic_1k(seed: int, scale: float):
    """The judged-metric model (BASELINE.json:2,5): 1k groups, 256 chains.

    Frozen-metric Newton (as bench.py): Laplace group proposals off a
    carried {v, g, packed-H} cache, Hessian refreshed during warmup and
    frozen for sampling (KernelConfig.newton_freeze) so the sampling obs
    pass costs the same as MALA's while beta mixes near-IID; conjugate
    invgamma tau. The MALA variant is `hier-logistic-1k-mala`."""
    data, _ = synth_logistic(
        jax.random.key(seed + 2000), G=1000, n=50, p=4
    )
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(
            chains=256,
            warmup=max(50, int(1000 * scale)),
            draws=max(50, int(2048 * scale)),
            seed=seed,
            segment_size=2048,
            collect={"mu": None, "log_tau": None, "beta": 8},
        ),
    )
    return model, data, cfg


def _judged(seed: int, scale: float):
    """The EXACT bench.py configuration: the judged headline run, so
    `python -m benchmarks.run --preset judged` reproduces bench.py with no
    overrides.

    Differences from `hier-logistic-1k`: 1024 chains per chip, 1500/4096
    schedule, and full_rhat streaming ON so the <1.01 gate covers all
    4,008 parameters. Data key, model (invgamma tau, asis_repeats=1),
    kernel (frozen Newton), segment size and collect spec match bench.py
    exactly at seed=0."""
    data, _ = synth_logistic(
        jax.random.key(seed + 2000), G=1000, n=50, p=4
    )
    model = make_hier_logistic(data, tau_prior="invgamma")
    n_dev = len(jax.devices())
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(
            chains=(1024 * n_dev) if scale >= 1.0 else 8 * max(n_dev, 1),
            warmup=max(50, int(1500 * scale)),
            draws=max(50, int(4096 * scale)),
            seed=seed,
            segment_size=2048,
            collect={"mu": None, "log_tau": None, "beta": 8},
            full_rhat=True,
            log_every_segment=False,
        ),
        sharding=ShardingConfig(chain_shards=max(n_dev, 1)),
    )
    return model, data, cfg


def _nested_poisson_1k(seed: int, scale: float):
    """Config 3 (BASELINE.json:9): 3-level Poisson GLMM, 1k groups, 512 chains."""
    data, _ = synth_poisson3(
        jax.random.key(seed + 3000),
        G=max(8, int(1000 * min(scale * 10, 1.0))),
        subjects_per_group=4, n=10, p=3,
    )
    # inverse-gamma tau priors -> exact conjugate Gibbs draws for both
    # scale levels
    model = make_nested_poisson(data, tau_prior="invgamma")
    # 16384 draws: log_tau_g is the slowest mode and R-hat falls ~1/draws;
    # the adaptive-RW beta_s kernel is the one the spec pins
    cfg = SamplerConfig(
        kernel=KernelConfig(),
        run=RunConfig(
            chains=512 if scale >= 1.0 else 32,
            warmup=max(50, int(1000 * scale)),
            draws=max(50, int(16384 * scale)),
            seed=seed,
            segment_size=1024,
            collect={
                "mu": None, "log_tau_g": None, "log_tau_s": None,
                "beta_g": 8, "beta_s": 8,
            },
        ),
    )
    return model, data, cfg


def _ragged_10k(seed: int, scale: float):
    """Config 4 (BASELINE.json:10): ragged segment data, 10k groups,
    1024 chains sharded over the chains axis of the device mesh.

    Default kernel: frozen-metric Newton + conjugate invgamma tau
    (BASELINE.json:10 pins no kernel). The ragged obs pass is the one
    hier_logistic's 'auto' picks for segment data; with
    KernelConfig.newton_freeze (default) the Hessian passes only run
    during warmup. The MALA state stays reproducible as
    `ragged-10k-mala`."""
    G = max(64, int(10_000 * min(scale * 10, 1.0)))
    data, _ = synth_logistic(
        jax.random.key(seed + 4000), G=G, n=30, p=3, ragged=True
    )
    model = make_hier_logistic(data, tau_prior="invgamma")
    n_dev = len(jax.devices())
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(
            chains=1024 if scale >= 1.0 else 8 * max(n_dev, 1),
            warmup=max(50, int(800 * scale)),
            draws=max(50, int(2048 * scale)),
            seed=seed,
            segment_size=512,
            collect={"mu": None, "log_tau": None, "beta": 8},
        ),
        sharding=ShardingConfig(chain_shards=max(n_dev, 1)),
    )
    return model, data, cfg


def _ragged_10k_mala(seed: int, scale: float):
    """Config 4 with MALA (the lean O(C N)-memory value+grad obs pass)
    and the half-normal tau MH block + Langevin ASIS."""
    _, data, cfg = _ragged_10k(seed, scale)
    model = make_hier_logistic(data)
    return model, data, dataclasses.replace(
        cfg, kernel=dataclasses.replace(cfg.kernel, algorithm="mala")
    )


def _mala_100k(seed: int, scale: float):
    """Config 5 (BASELINE.json:11): MALA with fused log-density+grad,
    100k groups on a chains x groups mesh (2 x 2 on four cards)."""
    G = max(128, int(100_000 * min(scale * 20, 1.0)))
    data, _ = synth_logistic(
        jax.random.key(seed + 5000), G=G, n=20, p=3
    )
    model = make_hier_logistic(data)
    n_dev = len(jax.devices())
    gsh = 2 if (n_dev % 2 == 0 and n_dev > 1 and G % 2 == 0) else 1
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="mala"),
        run=RunConfig(
            chains=512 if scale >= 1.0 else 16,
            warmup=max(50, int(1500 * scale)),
            draws=max(50, int(4096 * scale)),
            seed=seed,
            collect={"mu": None, "log_tau": None, "beta": 8},
            # full-R-hat gating baked in. At G=100k the Welford state
            # (4x the position per fold) is itself a cost, so every 4th
            # retained draw is folded, post-sweep and cond-gated: 1024
            # thinned draws/chain drive the same split-R-hat gate.
            full_rhat=True,
            full_rhat_thin=4,
        ),
        sharding=ShardingConfig(
            chain_shards=max(n_dev // gsh, 1), group_shards=gsh
        ),
    )
    return model, data, cfg


def _mala_100k_newton(seed: int, scale: float):
    """Config-5 variant: frozen-metric Newton + conjugate invgamma tau at
    G=100k. Newton is NOT "MALA" (the BASELINE.json:11 pin), so
    `mala-100k` stays the default. Under the frozen metric a tail beta
    group needs more retained draws to pass the all-param gate than MALA
    does, so this preset bakes 8192 draws."""
    _, data, cfg = _mala_100k(seed, scale)
    model = make_hier_logistic(data, tau_prior="invgamma")
    return model, data, dataclasses.replace(
        cfg,
        kernel=dataclasses.replace(cfg.kernel, algorithm="newton"),
        # segment_size 256: whether a longer segment pays on a local
        # card is still to be measured (ROADMAP A8)
        run=dataclasses.replace(cfg.run, segment_size=256, draws=8192),
    )


def _nested_poisson_1k_mala(seed: int, scale: float):
    """Config-3 variant beyond the spec pin: MALA on beta_s.

    BASELINE.json:9 pins 'adaptive MH' (kept as the default preset's RW
    kernel; DESIGN.md 5a); beta_s carries a fused logp+grad cache, so
    MALA costs no extra obs passes per update."""
    model, data, cfg = _nested_poisson_1k(seed, scale)
    return model, data, dataclasses.replace(
        cfg, kernel=dataclasses.replace(cfg.kernel, algorithm="mala")
    )


def _nested_poisson_1k_newton(seed: int, scale: float):
    """Config-3 variant beyond the spec pin: NEWTON-MH on beta_s.

    The obs-level conditional gets the Laplace proposal built from the
    analytic Poisson curvature w = exp(eta) (zero extra transcendentals),
    and with KernelConfig.newton_freeze (default) the sampling-phase obs
    pass costs the same as MALA's. The tau_s interweave upgrades to the
    parameter-free p-dim Gauss-Newton Laplace move off the carried
    Hessian. Config 3's min-ESS floor (log_tau_g) is capped by beta_s's
    own mixing — this is the strongest beta_s kernel in the design
    space."""
    model, data, cfg = _nested_poisson_1k(seed, scale)
    return model, data, dataclasses.replace(
        cfg, kernel=dataclasses.replace(cfg.kernel, algorithm="newton")
    )


def _hier_logistic_1k_mala(seed: int, scale: float):
    """The 1k-group model with MALA group updates (carried gradient
    cache) + the bound-metric Langevin ASIS interweave; the default is
    frozen-metric Newton (see `_hier_logistic_1k`)."""
    model, data, cfg = _hier_logistic_1k(seed, scale)
    return model, data, dataclasses.replace(
        cfg, kernel=dataclasses.replace(cfg.kernel, algorithm="mala")
    )


PRESETS = {
    "eight-schools": _eight_schools,
    "hier-logistic-100": _hier_logistic_100,
    # alias: the newton variant IS the default
    "hier-logistic-100-newton": _hier_logistic_100,
    "hier-logistic-100-rw": _hier_logistic_100_rw,
    "hier-logistic-1k": _hier_logistic_1k,
    # alias: the newton variant IS the default
    "hier-logistic-1k-newton": _hier_logistic_1k,
    "hier-logistic-1k-mala": _hier_logistic_1k_mala,
    # byte-for-byte the bench.py judged headline
    "judged": _judged,
    "nested-poisson-1k": _nested_poisson_1k,
    "nested-poisson-1k-mala": _nested_poisson_1k_mala,
    "nested-poisson-1k-newton": _nested_poisson_1k_newton,
    "ragged-10k": _ragged_10k,
    # alias: the newton variant IS the default
    "ragged-10k-newton": _ragged_10k,
    "ragged-10k-mala": _ragged_10k_mala,
    "mala-100k": _mala_100k,
    "mala-100k-newton": _mala_100k_newton,
}


def get_preset(name: str, seed: int = 0, scale: float = 1.0):
    """(model, data, SamplerConfig) for a named preset."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name](seed, scale)


def override_run(cfg: SamplerConfig, **kwargs) -> SamplerConfig:
    return dataclasses.replace(cfg, run=replace(cfg.run, **kwargs))
