"""hier_glm bernoulli/binomial delegation to the hier_logistic model.

The binomial likelihood reduces EXACTLY to the weighted-logistic one under
(y, mask) -> (y/m, m*mask) because the mask is a multiplicative f32 weight
on the per-obs (ll, score, curvature) triple in every obs pass. These tests
pin that identity against the delegate=False generic jnp path: conditionals
match up to the theta-independent binomial coefficient, the Newton hooks
match exactly in gradient/Hessian, the derived group_loglik restores the
true pmf scale, and a short end-to-end run agrees statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.scipy.special import gammaln

from nestmc.models.hier_glm import make_hier_glm, synth_glm


@pytest.fixture(scope="module")
def binom_setup():
    data, truth = synth_glm(
        jax.random.key(0), family="binomial", G=12, n=8, p=3, trials=7
    )
    deleg = make_hier_glm(data, family="binomial", tau_prior="invgamma")
    plain = make_hier_glm(
        data, family="binomial", tau_prior="invgamma", delegate=False
    )
    key = jax.random.key(1)
    state = plain.init_state(key, data, 5)
    return data, deleg, plain, state


def _log_binom(data):
    m = data.extra["trials"]
    return jnp.sum(
        (gammaln(m + 1.0) - gammaln(data.y + 1.0)
         - gammaln(m - data.y + 1.0)) * data.mask,
        axis=-1,
    )


def test_beta_conditional_matches_up_to_constant(binom_setup):
    data, deleg, plain, state = binom_setup
    v = state["beta"] + 0.1
    cf = deleg.cond_logdensity("beta", v, state, data)
    cp = plain.cond_logdensity("beta", v, state, data)
    np.testing.assert_allclose(
        np.asarray(cf + _log_binom(data)[None, :]), np.asarray(cp),
        rtol=2e-4, atol=2e-4,
    )


def test_hyper_conditionals_match_exactly(binom_setup):
    data, deleg, plain, state = binom_setup
    for name in ("mu", "log_tau"):
        v = state[name] + 0.05
        np.testing.assert_allclose(
            np.asarray(deleg.cond_logdensity(name, v, state, data)),
            np.asarray(plain.cond_logdensity(name, v, state, data)),
            rtol=2e-5, atol=2e-5,
        )


def test_joint_matches_up_to_constant(binom_setup):
    data, deleg, plain, state = binom_setup
    jf = deleg.joint_logdensity(state, data)
    jp = plain.joint_logdensity(state, data)
    const = float(jnp.sum(_log_binom(data)))
    np.testing.assert_allclose(
        np.asarray(jf) + const, np.asarray(jp), rtol=2e-4, atol=2e-3,
    )


def test_newton_hooks_match(binom_setup):
    data, deleg, plain, state = binom_setup
    v = state["beta"]
    sf, _ = deleg.cond_cached_newton["beta"]
    # plain's newton hook is the zero-self/full-rest split ONLY for
    # aux families; binomial is aux-free so self is the data likelihood
    sp, _ = plain.cond_cached_newton["beta"]
    vf, gf, hf = sf(v, data)
    vp, gp, hp = sp(v, data)
    np.testing.assert_allclose(
        np.asarray(vf + _log_binom(data)[None, :]), np.asarray(vp),
        rtol=2e-4, atol=2e-4,
    )
    np.testing.assert_allclose(np.asarray(gf), np.asarray(gp),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(hf), np.asarray(hp),
                               rtol=2e-4, atol=2e-4)


def test_group_loglik_restores_pmf_scale(binom_setup):
    data, deleg, plain, state = binom_setup
    gf = deleg.derived["group_loglik"](state)
    gp = plain.derived["group_loglik"](state)
    np.testing.assert_allclose(np.asarray(gf), np.asarray(gp),
                               rtol=2e-4, atol=2e-4)


def test_sample_data_stays_in_count_space(binom_setup):
    data, deleg, _, state = binom_setup
    d2 = deleg.sample_data(jax.random.key(3), state, data)
    y = np.asarray(d2.y)
    m = np.asarray(data.extra["trials"])
    assert (y >= 0).all() and (y <= m).all()
    np.testing.assert_allclose(y, np.round(y))  # counts, original space
    assert "trials" in d2.extra  # format preserved for the Geweke loop


def test_bernoulli_delegates_to_hier_logistic():
    data, _ = synth_glm(jax.random.key(2), family="bernoulli", G=10, n=6,
                        p=2)
    model = make_hier_glm(data, family="bernoulli")
    assert model.name == "hier_glm_bernoulli"
    # the delegate brings hier_logistic's joint (mu, tau) interweave
    assert set(model.joint_moves) == {"asis_tau"}
    assert model.joint_move_init_scale_grad == {"asis_tau": 1.0}
    plain = make_hier_glm(data, family="bernoulli", delegate=False)
    key = jax.random.key(4)
    state = plain.init_state(key, data, 4)
    # bernoulli has no binomial coefficient: conditionals match exactly
    v = state["beta"]
    np.testing.assert_allclose(
        np.asarray(model.cond_logdensity("beta", v, state, data)),
        np.asarray(plain.cond_logdensity("beta", v, state, data)),
        rtol=2e-4, atol=2e-4,
    )


def test_end_to_end_paths_agree_statistically():
    from nestmc.config import RunConfig, SamplerConfig
    from nestmc.engine import sample

    data, _ = synth_glm(
        jax.random.key(5), family="binomial", G=16, n=10, p=2, trials=6
    )
    cfg = SamplerConfig(run=RunConfig(
        chains=16, warmup=400, draws=600, seed=0,
        collect={"mu": None, "log_tau": None},
        log_every_segment=False,
    ))
    post_d = sample(
        make_hier_glm(data, "binomial", tau_prior="invgamma"), data, cfg
    )
    post_p = sample(
        make_hier_glm(data, "binomial", tau_prior="invgamma", delegate=False),
        data, cfg,
    )
    md, mp = post_d.mean("mu"), post_p.mean("mu")
    # pooled-draw MC noise at these schedules is ~0.02-0.05 per coord
    np.testing.assert_allclose(np.asarray(md), np.asarray(mp), atol=0.12)
    tf, tp = post_d.mean("log_tau"), post_p.mean("log_tau")
    np.testing.assert_allclose(np.asarray(tf), np.asarray(tp), atol=0.25)
