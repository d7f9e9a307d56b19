"""Geweke (2004) "getting it right" joint-distribution test.

Marginal-conditional simulator: (theta, y) ~ p(theta) p(y|theta) — exact.
Successive-conditional simulator: theta ~ p(theta) once, then alternate
y ~ p(y|theta) and theta ~ MCMC-transition(theta | y). If (and only if) the
transition leaves p(theta|y) invariant, both simulators draw from the same
joint; moments of test functions must agree by z-test.

The test runs C independent replicas fully batched (per-replica data via the
chain-batched calibration model) and includes a POWER check: a deliberately
broken kernel (missing Jacobian) must be detected.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.kernels.gibbs import make_sweep
from nestmc.kernels.state import init_kernel_state
from calibration_model import (
    make_broken_model,
    make_calibration_model,
    sample_y,
)

G, N = 4, 3
C = 512          # independent replicas
M = 400          # successive-conditional iterations
BURN = 100


def _test_functions(state, y):
    tau = jnp.exp(state["log_tau"])
    return {
        "mu": state["mu"],
        "mu2": state["mu"] ** 2,
        "tau": tau,
        "tau2": tau**2,
        "theta0": state["theta"][:, 0],
        "theta02": state["theta"][:, 0] ** 2,
        "theta_mean": jnp.mean(state["theta"], axis=1),
        "y00": y[:, 0, 0],
        "y2": jnp.mean(y**2, axis=(1, 2)),
        "ty": state["theta"][:, 0] * jnp.mean(y[:, 0], axis=-1),
    }


def _marginal_conditional(model, key, reps):
    ks, ky = jax.random.split(key)
    state = model.prior_sample(ks, None, reps)
    y = sample_y(ky, state["theta"], N)
    return _test_functions(state, y)


def _successive_conditional(model, key, algorithm="rwmh"):
    cfg = SamplerConfig(
        kernel=KernelConfig(scale_per_unit=True, algorithm=algorithm),
        run=RunConfig(chains=C, log_every_segment=False),
    )
    sweep = make_sweep(model, cfg)
    k0, k1, kinit = jax.random.split(key, 3)
    kstate = init_kernel_state(model, cfg, kinit, None)
    import dataclasses

    kstate = dataclasses.replace(
        kstate, position=model.prior_sample(k0, None, C)
    )

    def step(carry, key_t):
        kstate, y = carry
        y = sample_y(key_t, kstate.position["theta"], N)
        kstate = sweep(kstate, {"y": y}, adapt=False)
        stats = _test_functions(kstate.position, y)
        return (kstate, y), stats

    y0 = sample_y(k1, kstate.position["theta"], N)
    keys = jax.random.split(jax.random.key(99), M)
    (_, _), stats = jax.lax.scan(step, (kstate, y0), keys)
    # stats leaves: (M, C); drop burn-in, average over iterations per chain
    return {k: jnp.mean(v[BURN:], axis=0) for k, v in stats.items()}


def _geweke_zscores(model, seed=0, algorithm="rwmh"):
    mc = _marginal_conditional(model, jax.random.key(seed), reps=200_000)
    sc = _successive_conditional(
        model, jax.random.key(seed + 1), algorithm=algorithm
    )
    zs = {}
    for k in mc:
        m1 = float(jnp.mean(mc[k]))
        se1 = float(jnp.std(mc[k]) / np.sqrt(mc[k].shape[0]))
        # per-chain means are independent across the C replicas
        m2 = float(jnp.mean(sc[k]))
        se2 = float(jnp.std(sc[k]) / np.sqrt(sc[k].shape[0]))
        zs[k] = (m1 - m2) / np.sqrt(se1**2 + se2**2 + 1e-12)
    return zs


@pytest.mark.slow
@pytest.mark.parametrize("algorithm", ["rwmh", "mala"])
def test_geweke_correct_sampler_passes(algorithm):
    """Validates the MH correction of BOTH kernels — for MALA this is the
    sharpest check of the asymmetric-proposal (Langevin) correction term."""
    model = make_calibration_model(G, N)
    zs = _geweke_zscores(model, algorithm=algorithm)
    worst = max(abs(z) for z in zs.values())
    assert worst < 5.0, f"Geweke z-scores ({algorithm}) {zs}"


@pytest.mark.slow
def test_geweke_grad_asis_passes():
    """Langevin (MALA) interweaving move: validates the z-fixed target,
    the chain-rule gradient, and the asymmetric-proposal correction that
    models/hier_logistic.py's asis_tau_move uses in grad mode. Fixed scale
    1.0 (the harness runs adapt=False): the same scale at which the
    broken-q power check below measures |z| = 12 — large drift and
    q-correction terms, so an error in either cannot hide (measured scan:
    s=0.3 -> broken-q z 3.3, s=0.6 -> 9.0, s=1.0 -> 12.3)."""
    model = make_calibration_model(G, N, grad_asis=True, asis_init_scale=1.0)
    zs = _geweke_zscores(model, seed=20)
    worst = max(abs(z) for z in zs.values())
    assert worst < 5.0, f"Geweke z-scores (grad-ASIS) {zs}"


@pytest.mark.slow
def test_geweke_grad_asis_broken_q_detected():
    """POWER check: the same Langevin move with the q-correction dropped
    (the exact class of bug a MALA-fied move can introduce) must fail."""
    model = make_calibration_model(
        G, N, grad_asis="broken-q", asis_init_scale=1.0
    )
    zs = _geweke_zscores(model, seed=21)
    worst = max(abs(z) for z in zs.values())
    assert worst > 6.0, (
        f"Geweke failed to detect a missing MALA q-correction: {zs}"
    )


@pytest.mark.slow
def test_geweke_detects_broken_jacobian():
    model = make_broken_model(G, N)
    zs = _geweke_zscores(model, seed=10)
    worst = max(abs(z) for z in zs.values())
    assert worst > 6.0, (
        f"Geweke failed to detect a missing Jacobian: z-scores {zs}"
    )
