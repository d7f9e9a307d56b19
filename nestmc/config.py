"""Frozen dataclass configs (L8) — the knobs of the sampler.

Presets for the five BASELINE.json:7-11 benchmark configs live in
:mod:`nestmc.presets`. Configs serialize to dicts for provenance in result
JSON (benchmarks, checkpoints).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class KernelConfig:
    """MH kernel + adaptation knobs.

    algorithm: 'rwmh' (random-walk), 'mala' (gradient-based,
      BASELINE.json:11) or 'newton' (Laplace-proposal MH, kernels/newton.py);
      per-block override via Block.algorithm.
    target_accept: None -> per-block standard optimum (0.44 scalar RW /
      0.234 multivariate RW / 0.574 MALA, Roberts & Rosenthal).
    adapt_*: Robbins-Monro schedule log s += c*(t+t0)^-kappa * (alpha-target).
    precond: 'none' | 'diag' | 'full' — proposal preconditioning learned
      during warmup (frozen after): per-coordinate EMA variances, or the
      full Haario per-(chain, unit) EMA covariance (Cholesky-shaped noise;
      blocks with scalar units fall back to diag). RW-MH only for 'full';
      MALA uses diag at most.
    scale_per_unit: adapt one proposal scale per (chain, unit) instead of per
      chain — important for ragged group sizes.
    """

    algorithm: str = "rwmh"
    newton_freeze: bool = True  # Newton-MH: FREEZE the carried likelihood
    # Hessian at warmup end and run the sampling phase with it as a
    # constant metric. The sampling-phase obs pass then computes only
    # (value, grad) — MALA cost — while the proposal keeps the Laplace
    # map's curvature (measured near-Newton ESS/draw). Valid MH: during
    # sampling the frozen Hessian is a constant, so the proposal is a
    # deterministic function of the conditioning state (the warmup phase
    # refreshes it every accepted step exactly as before, alongside the
    # usual frozen-after-warmup RM scale adaptation).
    target_accept: float | None = None
    adapt_c: float = 1.0
    adapt_t0: float = 10.0
    adapt_kappa: float = 0.6
    precond: str = "none"
    precond_decay: float = 0.02
    precond_reg: float = 1e-6
    scale_per_unit: bool = True


@dataclass(frozen=True)
class RunConfig:
    """Chain/draw schedule.

    chains: total chains across all devices.
    warmup: adaptation sweeps (discarded).
    draws: retained draws per chain.
    thin: sweeps per retained draw.
    segment_size: draws per jit-scan segment (checkpoint/log boundary).
    collect: {block_name: None | k | (i, j, ...)} — None collects the full
      block, int k collects the first k units of a grouped block, a
      tuple/list of ints collects exactly those unit indices (e.g. a
      seeded random sample of groups for ESS-floor verification); None
      (the default) collects every block fully. Bound this for huge-G runs.
    """

    chains: int = 64
    warmup: int = 500
    draws: int = 1000
    thin: int = 1
    seed: int = 0
    segment_size: int = 500
    collect: dict | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0  # segments between checkpoints; 0 = off
    log_every_segment: bool = True
    full_rhat: bool = False
    # full_rhat: stream classic split R-hat over EVERY sampled block (all
    # units, not just collected ones) via per-(chain, half) Welford moments
    # in the sampling scan — O(params) memory, ~a few % sweep overhead.
    # Lets bench assert `all split R-hat < 1.01` without retaining huge
    # blocks (SURVEY.md section 3.5).
    full_rhat_thin: int = 1
    # full_rhat_thin: fold every k-th retained draw into the streaming
    # accumulators instead of every draw. Split R-hat on a thinned
    # subsequence estimates the same between/within variance ratio (fewer,
    # LESS autocorrelated samples — if anything the thinned estimate is
    # more conservative per sample), while the Welford pass's HBM traffic
    # drops by k: at G=100k the per-draw update reads+writes accumulators
    # 4x the position size per draw. Draws skipped by the gate cost one scalar
    # predicate — lax.cond skips the memory pass entirely.
    log_rhat: bool = False  # also log worst split R-hat of draws so far
    # (classic split R-hat on the cumulative collected draws; one extra
    # on-device reduction per segment, no extra host traffic beyond the
    # scalar)


@dataclass(frozen=True)
class ShardingConfig:
    """Device-mesh layout: mesh axes ('chains', 'groups').

    Chain parallelism is the data-parallel axis (zero hot-loop collectives);
    group parallelism is the tensor-parallel axis (one psum per population
    block update). chain_shards * group_shards must equal the device count
    in use; (1, 1) means single device.
    """

    chain_shards: int = 1
    group_shards: int = 1
    donate_carry: bool = True


@dataclass(frozen=True)
class SamplerConfig:
    kernel: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SamplerConfig":
        return SamplerConfig(
            kernel=KernelConfig(**d.get("kernel", {})),
            run=RunConfig(**d.get("run", {})),
            sharding=ShardingConfig(**d.get("sharding", {})),
        )


def rw_target_accept(unit_dim: int) -> float:
    """Roberts-Gelman-Gilks optimal RW-MH acceptance by dimension."""
    return 0.44 if unit_dim == 1 else 0.234


MALA_TARGET_ACCEPT = 0.574
