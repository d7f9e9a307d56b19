"""Newton-MH kernel (kernels/newton.py): obs-pass parity, one-step
cross-validation against independent dense linalg, the exact-Gibbs property
on Gaussian conditionals, cache-consistency, and an end-to-end run."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nestmc.config import KernelConfig, RunConfig, SamplerConfig
from nestmc.kernels.newton import newton_update
from nestmc.kernels.state import init_kernel_state
from nestmc.model import Block, ModelSpec
from nestmc.ops import smallchol as sc
from nestmc.ops.loglik import (
    logistic_logp_grad_hess_padded,
    logistic_logp_grad_hess_segment,
    logistic_loglik_padded,
    poisson_logp_grad_hess_padded,
    poisson_loglik_padded,
)
from nestmc.models import make_hier_logistic, synth_logistic


def _toy(C=3, G=4, n=6, p=3, seed=2):
    beta = jax.random.normal(jax.random.key(seed), (C, G, p))
    x = jax.random.normal(jax.random.key(seed + 1), (G, n, p))
    y = (jax.random.uniform(jax.random.key(seed + 2), (G, n)) < 0.5).astype(
        jnp.float32
    )
    mask = jnp.ones((G, n)).at[0, n - 2:].set(0.0)
    return beta, x, y, mask


def test_logistic_vgh_matches_autodiff():
    beta, x, y, mask = _toy()
    p = beta.shape[-1]
    v, g, h = logistic_logp_grad_hess_padded(beta, x, y, mask)
    np.testing.assert_allclose(
        np.asarray(v), np.asarray(logistic_loglik_padded(beta, x, y, mask)),
        atol=1e-5,
    )
    gref = jax.grad(
        lambda b: jnp.sum(logistic_loglik_padded(b, x, y, mask))
    )(beta)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gref), atol=1e-4)

    def ll_one(bvec, gi):
        eta = x[gi] @ bvec
        return jnp.sum((y[gi] * eta - jax.nn.softplus(eta)) * mask[gi])

    for c in range(beta.shape[0]):
        for gi in range(beta.shape[1]):
            Hd = -jax.hessian(ll_one)(beta[c, gi], gi)
            np.testing.assert_allclose(
                np.asarray(sc.unpack_dense(h[c, gi], p)), np.asarray(Hd),
                atol=1e-4,
            )


def test_poisson_vgh_matches_autodiff():
    beta, x, _, mask = _toy(seed=7)
    beta = 0.3 * beta
    x = 0.5 * x
    p = beta.shape[-1]
    y = jnp.abs(jnp.round(3.0 * jax.random.normal(
        jax.random.key(11), mask.shape
    )))
    v, g, h = poisson_logp_grad_hess_padded(beta, x, y, mask)
    np.testing.assert_allclose(
        np.asarray(v), np.asarray(poisson_loglik_padded(beta, x, y, mask)),
        atol=1e-5,
    )
    gref = jax.grad(
        lambda b: jnp.sum(poisson_loglik_padded(b, x, y, mask))
    )(beta)
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(gref), atol=1e-4
    )

    def ll_one(bvec, gi):
        eta = x[gi] @ bvec
        from jax.scipy.special import gammaln

        return jnp.sum(
            (y[gi] * eta - jnp.exp(eta) - gammaln(y[gi] + 1.0)) * mask[gi]
        )

    for c in range(beta.shape[0]):
        for gi in range(beta.shape[1]):
            Hd = -jax.hessian(ll_one)(beta[c, gi], gi)
            np.testing.assert_allclose(
                np.asarray(sc.unpack_dense(h[c, gi], p)), np.asarray(Hd),
                atol=1e-4,
            )


def test_segment_vgh_matches_padded():
    beta, x, y, mask = _toy(C=2, G=3, n=5, p=2, seed=4)
    # flatten the padded data into segment form
    keep = np.asarray(mask).astype(bool)
    seg = np.repeat(np.arange(3), keep.sum(axis=1))
    xs = jnp.asarray(np.asarray(x)[keep])
    ys = jnp.asarray(np.asarray(y)[keep])
    v0, g0, h0 = logistic_logp_grad_hess_padded(beta, x, y, mask)
    v1, g1, h1 = logistic_logp_grad_hess_segment(
        beta, xs, ys, jnp.asarray(seg), 3
    )
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h0), np.asarray(h1), atol=1e-5)


def test_pallas_vgh_parity_interpret():
    from nestmc.ops.loglik_triton import fused_loglik

    beta, x, y, mask = _toy(C=16, G=11, n=7, p=4, seed=9)
    mask = mask.at[3, :].set(0.0)  # an all-padded group row
    v0, g0, h0 = logistic_logp_grad_hess_padded(beta, x, y, mask)
    v1, g1, h1 = fused_loglik(
        beta, x, y, mask, family="logistic", outputs="vgh", interpret=True
    )
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h0), np.asarray(h1), atol=1e-5)
    dense = jnp.ones_like(mask)
    v0, g0, h0 = logistic_logp_grad_hess_padded(beta, x, y, dense)
    v1, g1, h1 = fused_loglik(
        beta, x, y, dense, family="logistic", outputs="vgh", dense=True,
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(h0), np.asarray(h1), atol=1e-5)


def test_pallas_poisson_vgh_parity_interpret():
    from nestmc.ops.loglik import poisson_logp_grad_hess_padded
    from nestmc.ops.loglik_triton import fused_loglik

    beta, x, _, mask = _toy(C=16, G=11, n=7, p=3, seed=13)
    beta = 0.3 * beta
    x = 0.5 * x
    y = jnp.abs(jnp.round(3.0 * jax.random.normal(
        jax.random.key(21), mask.shape
    )))
    mask = mask.at[5, :].set(0.0)  # an all-padded group row
    v0, g0, h0 = poisson_logp_grad_hess_padded(beta, x, y, mask)
    v1, g1, h1 = fused_loglik(
        beta, x, y, mask, family="poisson", outputs="vgh", interpret=True
    )
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(g0), np.asarray(g1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(h0), np.asarray(h1), atol=1e-4)


def test_one_step_matches_dense_linalg():
    """Cross-validate ONE newton_update against an independent dense
    reimplementation: jax.grad/jax.hessian of cond_logdensity for (g, H),
    numpy cholesky/solve for the proposal map, and the explicit Gaussian
    log-density ratio. Shares only the PRNG stream with the kernel."""
    data, _ = synth_logistic(jax.random.key(0), G=3, n=8, p=3)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=4, log_every_segment=False),
    )
    state = init_kernel_state(model, cfg, jax.random.key(1), data)
    block = model.block("beta")
    # damping c = 0.49 so acceptance is non-trivially inside (0, 1)
    log_scale = jnp.full_like(state.log_scale["beta"], math.log(0.7))
    key = jax.random.key(7)
    new_value, alpha, _ = newton_update(
        key, block, model, state.position, log_scale, None, data,
        cache=state.cache["beta"],
    )

    # --- independent recomputation ---
    C, G, p = state.position["beta"].shape
    beta = np.asarray(state.position["beta"], dtype=np.float64)
    pos = state.position

    def cond_one(bvec, c, g):
        full = pos["beta"].at[c, g].set(bvec)
        return model.cond_logdensity("beta", full, pos, data)[c, g]

    k_eps, k_u = jax.random.split(key)
    eps = np.asarray(
        jax.random.normal(k_eps, (C, G, p), jnp.float32), np.float64
    )
    logu = np.asarray(jnp.log(jax.random.uniform(
        k_u, (C, G), jnp.float32, minval=jnp.finfo(jnp.float32).tiny
    )), np.float64)
    sqc = 0.7

    def q_logpdf(a, mean, H, c):
        r = a - mean
        sign, ld = np.linalg.slogdet(H)
        return (
            -0.5 * r @ H @ r / c + 0.5 * ld - 0.5 * p * np.log(
                2 * np.pi * c
            )
        )

    alpha_np = np.asarray(alpha)
    newv_np = np.asarray(new_value)
    for c in range(C):
        for g in range(G):
            b0 = jnp.asarray(beta[c, g], jnp.float32)
            d0 = float(cond_one(b0, c, g))
            g0 = np.asarray(jax.grad(cond_one)(b0, c, g), np.float64)
            H0 = -np.asarray(jax.hessian(cond_one)(b0, c, g), np.float64)
            m0 = beta[c, g] + np.linalg.solve(H0, g0)
            L0 = np.linalg.cholesky(H0)
            prop = m0 + sqc * np.linalg.solve(L0.T, eps[c, g])
            bp = jnp.asarray(prop, jnp.float32)
            d1 = float(cond_one(bp, c, g))
            g1 = np.asarray(jax.grad(cond_one)(bp, c, g), np.float64)
            H1 = -np.asarray(jax.hessian(cond_one)(bp, c, g), np.float64)
            m1 = prop + np.linalg.solve(H1, g1)
            la = (
                d1 - d0
                + q_logpdf(beta[c, g], m1, H1, sqc**2)
                - q_logpdf(prop, m0, H0, sqc**2)
            )
            a_ext = min(1.0, np.exp(la))
            assert abs(a_ext - alpha_np[c, g]) < 5e-3, (c, g, la)
            expect = prop if logu[c, g] < la else beta[c, g]
            np.testing.assert_allclose(
                newv_np[c, g], expect, atol=5e-4, err_msg=str((c, g))
            )


def test_one_step_frozen_matches_dense_linalg():
    """Frozen-metric one step (KernelConfig.newton_freeze sampling phase)
    against an independent dense reimplementation: the metric is the
    CACHED likelihood Hessian + the (position-free) prior precision on
    BOTH sides — same proposal map forward, reverse mean built from the
    true gradient at the proposal but the frozen metric, and no
    log-determinant ratio."""
    data, _ = synth_logistic(jax.random.key(2), G=3, n=8, p=3)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=4, log_every_segment=False),
    )
    state = init_kernel_state(model, cfg, jax.random.key(1), data)
    block = model.block("beta")
    log_scale = jnp.full_like(state.log_scale["beta"], math.log(0.7))
    key = jax.random.key(9)
    new_value, alpha, new_cache = newton_update(
        key, block, model, state.position, log_scale, None, data,
        cache=state.cache["beta"], frozen=True,
    )
    assert new_cache["h"] is state.cache["beta"]["h"]

    C, G, p = state.position["beta"].shape
    beta = np.asarray(state.position["beta"], dtype=np.float64)
    pos = state.position
    h_lik = np.asarray(state.cache["beta"]["h"], np.float64)  # (C, G, T)
    inv_tau2 = np.asarray(
        jnp.exp(-2.0 * pos["log_tau"]), np.float64
    )                                                          # (C, p)

    def cond_one(bvec, c, g):
        full = pos["beta"].at[c, g].set(bvec)
        return model.cond_logdensity("beta", full, pos, data)[c, g]

    def unpack(hrow, c):
        H = np.zeros((p, p))
        t = 0
        for i in range(p):
            for j in range(i + 1):
                H[i, j] = H[j, i] = hrow[t]
                t += 1
        return H + np.diag(inv_tau2[c])

    k_eps, k_u = jax.random.split(key)
    eps = np.asarray(
        jax.random.normal(k_eps, (C, G, p), jnp.float32), np.float64
    )
    logu = np.asarray(jnp.log(jax.random.uniform(
        k_u, (C, G), jnp.float32, minval=jnp.finfo(jnp.float32).tiny
    )), np.float64)
    sqc = 0.7

    alpha_np = np.asarray(alpha)
    newv_np = np.asarray(new_value)
    for c in range(C):
        for g in range(G):
            H = unpack(h_lik[c, g], c)          # frozen metric, both sides
            b0 = jnp.asarray(beta[c, g], jnp.float32)
            d0 = float(cond_one(b0, c, g))
            g0 = np.asarray(jax.grad(cond_one)(b0, c, g), np.float64)
            m0 = beta[c, g] + np.linalg.solve(H, g0)
            L = np.linalg.cholesky(H)
            prop = m0 + sqc * np.linalg.solve(L.T, eps[c, g])
            bp = jnp.asarray(prop, jnp.float32)
            d1 = float(cond_one(bp, c, g))
            g1 = np.asarray(jax.grad(cond_one)(bp, c, g), np.float64)
            m1 = prop + np.linalg.solve(H, g1)
            r_rev = beta[c, g] - m1
            r_fwd = prop - m0
            la = d1 - d0 + (
                -0.5 * r_rev @ H @ r_rev / sqc**2
                + 0.5 * r_fwd @ H @ r_fwd / sqc**2
            )
            a_ext = min(1.0, np.exp(la))
            assert abs(a_ext - alpha_np[c, g]) < 5e-3, (c, g, la)
            expect = prop if logu[c, g] < la else beta[c, g]
            np.testing.assert_allclose(
                newv_np[c, g], expect, atol=5e-4, err_msg=str((c, g))
            )


@pytest.mark.parametrize("frozen", [False, True])
def test_gaussian_conditional_is_exact_gibbs(frozen):
    """On an exactly Gaussian conditional the Newton proposal at c = 1 IS
    the conditional: acceptance must be 1 and one step must produce exact
    conditional draws (mean/cov checked over many chains). The frozen
    variant is identical here — a Gaussian's Hessian is constant, so
    freezing it loses nothing (the design intuition behind
    KernelConfig.newton_freeze)."""
    C, G, p = 4096, 2, 3
    rng = np.random.default_rng(0)
    A = rng.normal(size=(G, p, p))
    prec = A @ np.swapaxes(A, -1, -2) + np.eye(p)   # (G, p, p) SPD
    t = rng.normal(size=(G, p))
    prec_j = jnp.asarray(prec, jnp.float32)
    prec_packed = sc.pack_dense(prec_j, p)[None]     # (1, G, T)
    t_j = jnp.asarray(t, jnp.float32)

    def self_vgh(value, data):
        diff = value - t_j[None]
        Av = jnp.einsum("gij,cgj->cgi", prec_j, diff)
        v = -0.5 * jnp.sum(diff * Av, axis=-1)
        return v, -Av, jnp.broadcast_to(
            prec_packed, value.shape[:2] + (sc.packed_dim(p),)
        )

    def rest_vgh(value, state, data):
        zero_v = jnp.zeros(value.shape[:2], value.dtype)
        return zero_v, jnp.zeros_like(value), jnp.zeros(
            value.shape[:2] + (sc.packed_dim(p),), value.dtype
        )

    block = Block("theta", (G, p), units=G)
    model = ModelSpec(
        name="gauss", blocks=(block,),
        cond_logdensity=lambda *a: None,
        joint_logdensity=lambda *a: None,
        init_state=lambda *a: None,
        cond_cached_newton={"theta": (self_vgh, rest_vgh)},
    )
    value = 3.0 + jax.random.normal(jax.random.key(3), (C, G, p))
    position = {"theta": value}
    log_scale = jnp.zeros((C, G), jnp.float32)
    cache = None
    if frozen:
        v0, g0, h0 = self_vgh(value, None)
        cache = {"v": v0, "g": g0, "h": h0}
    new_value, alpha, _ = newton_update(
        jax.random.key(5), block, model, position, log_scale, None, None,
        cache=cache, frozen=frozen,
    )
    assert float(jnp.min(alpha)) > 1.0 - 1e-3
    draws = np.asarray(new_value)             # (C, G, p) one-step draws
    cov_ref = np.linalg.inv(prec)
    for g in range(G):
        err_m = np.abs(draws[:, g].mean(axis=0) - t[g])
        se = np.sqrt(np.diag(cov_ref[g]) / C)
        assert np.all(err_m < 5 * se), (g, err_m, se)
        cov_emp = np.cov(draws[:, g].T)
        assert np.all(np.abs(cov_emp - cov_ref[g]) < 0.15), g


def test_cache_stays_consistent_through_sweeps():
    """After several full sweeps (newton beta + conjugate hypers + ASIS
    rescale), the carried {'v','g','h'} cache must equal a fresh obs pass
    at the current position — catches any path that moves beta without
    refreshing the cache (e.g. a stale Hessian after an ASIS accept, which
    would silently break detailed balance)."""
    from nestmc.kernels.gibbs import make_sweep

    data, _ = synth_logistic(jax.random.key(2), G=12, n=9, p=3)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=6, log_every_segment=False),
    )
    state = init_kernel_state(model, cfg, jax.random.key(3), data)
    sweep = jax.jit(lambda s: make_sweep(model, cfg)(s, data, adapt=True))
    for _ in range(5):
        state = sweep(state)
    self_vgh, _ = model.cond_cached_newton["beta"]
    v, g, h = self_vgh(state.position["beta"], data)
    np.testing.assert_allclose(
        np.asarray(state.cache["beta"]["v"]), np.asarray(v), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(state.cache["beta"]["g"]), np.asarray(g), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(state.cache["beta"]["h"]), np.asarray(h), atol=2e-4
    )


def test_end_to_end_newton_converges():
    data, truth = synth_logistic(jax.random.key(5), G=20, n=25, p=3)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=8, warmup=200, draws=500, segment_size=500,
                      log_every_segment=False),
    )
    from nestmc.diagnostics import split_rhat
    from nestmc.engine import sample

    post = sample(model, data, cfg)
    acc = float(jnp.mean(post.accept_rates["beta"]))
    assert acc > 0.7, acc                      # near-IID regime
    worst = max(
        float(jnp.max(split_rhat(v))) for v in post.draws.values()
    )
    assert worst < 1.05, worst
    mu_err = np.abs(
        np.asarray(jnp.mean(post.draws["mu"], axis=(0, 1)))
        - np.asarray(truth["mu"])
    )
    assert np.all(mu_err < 0.6), mu_err


def test_hookless_blocks_fall_back_to_mala():
    """A global algorithm='newton' must not crash on MH blocks without
    cond_cached_newton hooks (e.g. the half-normal log_tau block): they
    fall back to MALA (generic vjp gradient). Regression: KeyError
    'log_tau' on the ragged halfnormal preset."""
    from nestmc.engine import sample

    data, _ = synth_logistic(jax.random.key(4), G=12, n=8, p=3)
    model = make_hier_logistic(data, tau_prior="halfnormal")
    cfg = SamplerConfig(
        kernel=KernelConfig(algorithm="newton"),
        run=RunConfig(chains=8, warmup=60, draws=60,
                      log_every_segment=False),
    )
    post = sample(model, data, cfg)  # must not raise
    assert float(post.accept_rates["beta"].mean()) > 0.3
    assert float(post.accept_rates["log_tau"].mean()) > 0.05


def test_rejects_unsupported_unit_shapes():
    bad_unit_shape = (2, 2)
    block = Block("b", (3,) + bad_unit_shape, units=3)
    model = ModelSpec(
        name="bad", blocks=(block,),
        cond_logdensity=lambda *a: None,
        joint_logdensity=lambda *a: None,
        init_state=lambda *a: None,
        cond_cached_newton={"b": (None, None)},
    )
    with pytest.raises(ValueError):
        newton_update(
            jax.random.key(0), block, model,
            {"b": jnp.zeros((2, 3) + bad_unit_shape)},
            jnp.zeros((2, 3)), None, None,
        )
