"""One MH step of the jnp block updates against a dense float64 reference.

For each model whose group block runs through the carried-cache split
(padded and bucketed hier_logistic, nested_poisson's beta_s, hier_glm's
Poisson beta) and each kernel (RW-MH, MALA, Newton-MH, frozen Newton), one
``*_update`` call is checked per (chain, unit) against an independent
recomputation: the conditional from a reference model built on the jnp
(segment) likelihood, gradients and Hessians by autodiff of that
conditional, the proposal map and the Gaussian proposal densities in
numpy float64, and the same external noise (the update's own key split).
Acceptance probabilities and the new state must agree.
"""

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.kernels.mala import mala_update
from nestmc.kernels.newton import newton_update
from nestmc.kernels.rwmh import rwmh_update
from nestmc.kernels.state import init_kernel_state

UPDATES = {"rwmh": rwmh_update, "mala": mala_update,
           "newton": newton_update, "newton_frozen": newton_update}
STEP = {"rwmh": 0.3, "mala": 0.3, "newton": 0.7, "newton_frozen": 0.7}


def _hier_logistic_padded():
    from nestmc.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(jax.random.key(0), G=4, n=8, p=3)
    mask = np.ones((4, 8), np.float32)
    mask[1, 5:] = 0.0
    data = dataclasses.replace(
        data, mask=jnp.asarray(mask), y=data.y * jnp.asarray(mask)
    )
    model = make_hier_logistic(data, tau_prior="invgamma")
    return data, model, model, "beta"


def _hier_logistic_bucket():
    from nestmc.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(jax.random.key(1), G=5, n=12, p=2,
                             ragged=True, min_obs=2)
    model = make_hier_logistic(data, tau_prior="invgamma",
                               loglik_impl="bucket")
    assert model.loglik_impls["selected"] == "bucket"
    ref = make_hier_logistic(data, tau_prior="invgamma", loglik_impl="jnp")
    return data, model, ref, "beta"


def _nested_poisson():
    from nestmc.models import make_nested_poisson, synth_poisson3

    data, _ = synth_poisson3(jax.random.key(2), G=2, subjects_per_group=2,
                             n=6, p=3)
    mask = np.ones((4, 6), np.float32)
    mask[2, 4:] = 0.0
    data = dataclasses.replace(
        data, mask=jnp.asarray(mask), y=data.y * jnp.asarray(mask)
    )
    model = make_nested_poisson(data, tau_prior="invgamma")
    return data, model, model, "beta_s"


def _hier_glm_poisson():
    from nestmc.models.hier_glm import make_hier_glm, synth_glm

    data, _ = synth_glm(jax.random.key(3), family="poisson", G=4, n=7, p=2)
    model = make_hier_glm(data, family="poisson", tau_prior="invgamma")
    return data, model, model, "beta"


MODELS = {
    "hier_logistic_padded": _hier_logistic_padded,
    "hier_logistic_bucket": _hier_logistic_bucket,
    "nested_poisson_beta_s": _nested_poisson,
    "hier_glm_poisson": _hier_glm_poisson,
}


def _dense_derivs(ref, name, value, pos, data):
    """Per-(chain, unit) conditional, gradient and NEGATIVE Hessian of the
    reference model, float64 numpy: (C, U), (C, U, p), (C, U, p, p)."""
    def cond(v):
        return ref.cond_logdensity(name, v, {**pos, name: v}, data)

    def total(v):
        return jnp.sum(cond(v))

    d = np.asarray(cond(value), np.float64)
    g = np.asarray(jax.grad(total)(value), np.float64)
    full = np.asarray(jax.hessian(total)(value), np.float64)
    C, U, p = value.shape
    H = np.empty((C, U, p, p))
    for c in range(C):
        for u in range(U):
            H[c, u] = -full[c, u, :, c, u, :]
    return d, g, H


@pytest.mark.parametrize("kernel", list(UPDATES))
@pytest.mark.parametrize("case", list(MODELS))
def test_one_step_matches_dense_reference(case, kernel):
    data, model, ref, name = MODELS[case]()
    algorithm = "newton" if kernel.startswith("newton") else kernel
    frozen = kernel == "newton_frozen"
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(chains=3, log_every_segment=False),
    )
    state = init_kernel_state(model, cfg, jax.random.key(4), data)
    pos = state.position
    block = model.block(name)
    log_scale = jnp.full_like(state.log_scale[name], math.log(STEP[kernel]))
    key = jax.random.key(11)
    kw = {"frozen": frozen} if algorithm == "newton" else {}
    new_value, alpha, _ = UPDATES[kernel](
        key, block, model, pos, log_scale, None, data,
        cache=state.cache[name], **kw,
    )

    value = pos[name]
    C, U, p = value.shape
    k_eps, k_u = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k_eps, value.shape, value.dtype),
                     np.float64)
    logu = np.asarray(jnp.log(jax.random.uniform(
        k_u, (C, U), value.dtype, minval=jnp.finfo(value.dtype).tiny
    )), np.float64)
    s = STEP[kernel]
    v0 = np.asarray(value, np.float64)
    d0, g0, H0 = _dense_derivs(ref, name, value, pos, data)
    if frozen:
        # frozen metric: the carried likelihood Hessian + the prior
        # precision, identical on both sides of the ratio
        h_lik = np.asarray(state.cache[name]["h"], np.float64)
        _, _, h_prior = model.cond_cached_newton[name][1](value, pos, data)
        h_prior = np.broadcast_to(np.asarray(h_prior, np.float64),
                                  h_lik.shape)
        from nestmc.ops.smallchol import unpack_dense

        Hf = np.asarray(unpack_dense(jnp.asarray(h_lik + h_prior), p),
                        np.float64)

    if kernel == "rwmh":
        prop = v0 + s * eps
    elif kernel == "mala":
        prop = v0 + 0.5 * s * s * g0 + s * eps
    else:
        prop = np.empty_like(v0)
        for c in range(C):
            for u in range(U):
                H = Hf[c, u] if frozen else H0[c, u]
                mean = v0[c, u] + np.linalg.solve(H, g0[c, u])
                L = np.linalg.cholesky(H)
                prop[c, u] = mean + s * np.linalg.solve(L.T, eps[c, u])
    d1, g1, H1 = _dense_derivs(ref, name, jnp.asarray(prop, jnp.float32),
                               pos, data)

    la = d1 - d0
    if kernel == "mala":
        fwd = prop - v0 - 0.5 * s * s * g0
        rev = v0 - prop - 0.5 * s * s * g1
        la = la + (np.sum(fwd ** 2, -1) - np.sum(rev ** 2, -1)) / (2 * s * s)
    elif algorithm == "newton":
        for c in range(C):
            for u in range(U):
                Ha = Hf[c, u] if frozen else H0[c, u]
                Hb = Hf[c, u] if frozen else H1[c, u]
                m0 = v0[c, u] + np.linalg.solve(Ha, g0[c, u])
                m1 = prop[c, u] + np.linalg.solve(Hb, g1[c, u])
                rf, rr = prop[c, u] - m0, v0[c, u] - m1
                la[c, u] += (
                    -0.5 * rr @ Hb @ rr / s**2 + 0.5 * rf @ Ha @ rf / s**2
                    + 0.5 * np.linalg.slogdet(Hb)[1]
                    - 0.5 * np.linalg.slogdet(Ha)[1]
                )
    a_ref = np.minimum(1.0, np.exp(la))
    np.testing.assert_allclose(np.asarray(alpha), a_ref, atol=5e-3)
    expect = np.where((logu < la)[..., None], prop, v0)
    np.testing.assert_allclose(np.asarray(new_value), expect, atol=5e-4)
