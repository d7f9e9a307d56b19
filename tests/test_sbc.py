"""Simulation-based calibration (Talts et al. 2018).

For each of C replicas: draw theta-tilde from the prior, simulate data,
run the full engine (warmup + thinned sampling), and rank theta-tilde among
the L retained draws. If the sampler targets the right posterior, ranks are
uniform on {0..L}; chi-square test on binned ranks, per parameter.

Runs fully batched: replicas are chains, each with its own dataset
(chain-batched data dict). Exercises the REAL engine path (adaptation,
freeze, thinning, collection), unlike the kernel-level Geweke test.
"""

import numpy as np
import pytest
import scipy.stats as st

import jax
import jax.numpy as jnp

from nestmc.config import RunConfig, SamplerConfig
from nestmc.engine import sample
from calibration_model import make_calibration_model, sample_y

G, N = 4, 3
C = 512       # replicas
L = 127       # retained draws per replica (ranks in {0..127})
THIN = 4


@pytest.mark.slow
def test_sbc_ranks_uniform():
    model = make_calibration_model(G, N)
    kp, kd, ke = jax.random.split(jax.random.key(42), 3)
    truth = model.prior_sample(kp, None, C)
    data = {"y": sample_y(kd, truth["theta"], N)}

    cfg = SamplerConfig(
        run=RunConfig(
            chains=C, warmup=500, draws=L, thin=THIN, seed=7,
            log_every_segment=False,
        ),
    )
    post = sample(model, data, cfg, key=ke)

    failures = {}
    for name, tr in (
        ("mu", truth["mu"]),
        ("log_tau", truth["log_tau"]),
        ("theta", truth["theta"][:, 0]),
    ):
        draws = post.draws[name]
        if draws.ndim == 3:
            draws = draws[:, :, 0]
        ranks = np.asarray(jnp.sum(draws < tr[:, None], axis=1))
        # chi-square on 8 bins of {0..L}
        bins = 8
        width = (L + 1) / bins
        counts = np.bincount(
            (ranks / width).astype(int), minlength=bins
        )[:bins]
        expected = C / bins
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        pval = st.chi2.sf(chi2, bins - 1)
        if pval < 1e-3:
            failures[name] = (chi2, pval, counts.tolist())
    assert not failures, f"SBC rank uniformity failed: {failures}"


@pytest.mark.slow
def test_sbc_sampler_actually_conditions_on_data():
    """Companion check: SBC rank uniformity alone cannot distinguish the
    posterior from the prior (prior draws are also marginally calibrated).
    Assert the sampler CONTRACTS: per-replica posterior sd of theta must be
    well below the prior sd."""
    model = make_calibration_model(G, N)
    kp, kd, ke = jax.random.split(jax.random.key(43), 3)
    truth = model.prior_sample(kp, None, C)
    data = {"y": sample_y(kd, truth["theta"], N)}

    cfg = SamplerConfig(
        run=RunConfig(
            chains=C, warmup=300, draws=L, thin=THIN, seed=8,
            log_every_segment=False,
        ),
    )
    post = sample(model, data, cfg, key=jax.random.fold_in(ke, 2))
    post_draws = post.draws["theta"][:, :, 0]
    post_sd = float(jnp.mean(jnp.std(post_draws, axis=1)))
    prior_sd = float(jnp.std(truth["theta"][:, 0]))
    assert post_sd < 0.6 * prior_sd, (post_sd, prior_sd)
