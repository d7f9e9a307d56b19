"""Hierarchical logistic regression — the judged benchmark model.

    y_ij ~ Bernoulli(sigmoid(x_ij . beta_j))     i obs in group j
    beta_j ~ N(mu, diag(tau^2))                  group-level coefficients
    mu_k ~ N(0, prior_mu_scale^2)
    tau_k ~ HalfNormal(prior_tau_scale)          sampled as log tau + Jacobian

Configs: BASELINE.json:8 (100 groups x 50 obs, 64 chains) and the judged
metric's 1k-group variant (BASELINE.json:2,5); BASELINE.json:10 is the same
model over ragged/segment data at 10k groups.

The group-block conditional is `loglik + gprior` where loglik is the hot
(chains x groups x obs) reduction; implementation selected at construction
by ops/dispatch.py: 'jnp' (reference), 'triton' (fused GPU kernel), 'auto'
(the kernel on a GPU).
The population blocks (mu, log_tau) never touch the data — their conditional
reads only beta — so the expensive likelihood runs exactly twice per sweep.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from nestmc.data import NestedData, RaggedData
from nestmc.distributions import (
    log_scale_guard,
    logpdf_halfnormal,
    logpdf_normal,
)
from nestmc.model import Block, ModelSpec


def _resolve_loglik(data, impl: str):
    """Pick the likelihood implementation once, from the concrete data.

    Returns (value, value_grad, value_grad_hess, chosen_name), each
    function of (beta, data). Padded data: the choice of ops/dispatch.py
    ('triton' on a GPU, 'jnp' elsewhere; 'auto' decides). Ragged data:
      'jnp'     gather + segment_sum with O(C N) peak memory ('auto')
      'bucket'  size buckets through the padded obs pass (ops/bucket.py)
    """
    import numpy as np

    from nestmc.ops import loglik as L
    from nestmc.ops.dispatch import loglik_impl, padded_obs_pass

    if isinstance(data, RaggedData):
        if impl == "bucket":
            from nestmc.ops import bucket as B

            layout = B.BucketLayout.build(
                np.asarray(data.segment_ids), data.num_groups
            )
            pad = loglik_impl("logistic")

            def v(beta, d):
                return B.bucketed_logistic_loglik(
                    beta, d.x, d.y, layout, impl=pad)

            def vg(beta, d):
                return B.bucketed_logistic_logp_grad(
                    beta, d.x, d.y, layout, impl=pad)

            def vgh(beta, d):
                return B.bucketed_logistic_logp_grad_hess(
                    beta, d.x, d.y, layout, impl=pad)
            return v, vg, vgh, "bucket"
        if impl not in ("auto", "jnp"):
            raise ValueError(f"unknown ragged loglik impl {impl!r}")

        def v(beta, d):
            return L.logistic_loglik_segment(
                beta, d.x, d.y, d.segment_ids, d.num_groups)

        def vg(beta, d):
            return L.logistic_logp_grad_segment(
                beta, d.x, d.y, d.segment_ids, d.num_groups)

        def vgh(beta, d):
            return L.logistic_logp_grad_hess_segment(
                beta, d.x, d.y, d.segment_ids, d.num_groups)
        return v, vg, vgh, "jnp-segment"

    chosen = loglik_impl("logistic", impl)
    # mask == 1 exactly, not truthiness: the binomial delegation
    # (models/hier_glm.py) passes TRIALS-weighted masks whose values are
    # multiplicative likelihood weights
    dense = bool(np.all(np.asarray(data.mask) == 1.0))
    fv, fvg, fvgh = padded_obs_pass("logistic", chosen, dense=dense)

    def v(beta, d):
        return fv(beta, d.x, d.y, d.mask)

    def vg(beta, d):
        return fvg(beta, d.x, d.y, d.mask)

    def vgh(beta, d):
        return fvgh(beta, d.x, d.y, d.mask)
    return v, vg, vgh, chosen


def make_hier_logistic(
    data,
    prior_mu_scale: float = 5.0,
    prior_tau_scale: float = 2.0,
    loglik_impl: str = "auto",
    tau_prior: str = "halfnormal",
    tau_ig_shape: float = 2.0,
    tau_ig_scale: float = 0.5,
    asis_repeats: int = 1,
) -> ModelSpec:
    """tau_prior: 'halfnormal' (tau ~ HN(prior_tau_scale), per-coordinate
    MH on log tau) or 'invgamma' (tau^2 ~ InvGamma(shape, scale): log_tau
    becomes an EXACT conjugate Gibbs draw given beta — the normal-inverse-
    gamma update, ported from models/nested_poisson.py where it measured
    7x the tau ESS of half-normal + MH). The ASIS interweaving move stays
    in both variants: the conjugate draw targets tau | beta exactly but is
    still pinned to beta's empirical spread; interweaving breaks that
    coupling. asis_repeats: ASIS move repetitions per sweep (each costs
    one likelihood pass; tau mixing sets the min-ESS floor)."""
    G = data.num_groups
    p = data.num_covariates
    if tau_prior not in ("halfnormal", "invgamma"):
        raise ValueError(tau_prior)
    conj_tau = tau_prior == "invgamma"
    lik_fn, lik_value_and_grad, lik_value_grad_hess, chosen = (
        _resolve_loglik(data, loglik_impl)
    )

    _LOG_2PI = 1.8378770664093453

    def _tau_logprior(lt):
        """log p(log tau) elementwise, incl. the Jacobian to log space."""
        if conj_tau:
            from jax.scipy.special import gammaln

            a, b = tau_ig_shape, tau_ig_scale
            # tau^2 ~ IG(a, b); |d tau^2 / d log tau| = 2 e^{2 lt}
            return (
                a * jnp.log(b) - gammaln(a)
                - 2.0 * (a + 1.0) * lt - b * jnp.exp(-2.0 * lt)
                + jnp.log(2.0) + 2.0 * lt
            )
        return logpdf_halfnormal(jnp.exp(lt), prior_tau_scale) + lt

    def _tau_logprior_grad(lt):
        """d/d(log tau) of _tau_logprior, elementwise (analytic; drives
        the Langevin drift of the gradient ASIS move)."""
        if conj_tau:
            a, b = tau_ig_shape, tau_ig_scale
            return -2.0 * a + 2.0 * b * jnp.exp(-2.0 * lt)
        return 1.0 - jnp.exp(2.0 * lt) / prior_tau_scale**2

    def _tau_logprior_metric(lt):
        """-d^2/d(log tau)^2 of _tau_logprior, elementwise — the prior term
        of the Newton-ASIS metric. Positive for both priors (invgamma:
        4 b e^{-2 lt}; halfnormal: 2 e^{2 lt} / S^2)."""
        if conj_tau:
            return 4.0 * tau_ig_scale * jnp.exp(-2.0 * lt)
        return 2.0 * jnp.exp(2.0 * lt) / prior_tau_scale**2

    def _gprior(state):
        beta = state["beta"]                      # (C, G, p)
        mu = state["mu"][:, None, :]              # (C, 1, p)
        tau = jnp.exp(state["log_tau"])[:, None, :]
        return jnp.sum(logpdf_normal(beta, mu, tau), axis=-1)  # (C, G)

    def _gprior_perk_from_suff(s1, s2, mu, log_tau):
        """sum_g log N(beta_gk | mu_k, tau_k) PER COORDINATE k, from the
        sufficient stats s1 = sum_g beta, s2 = sum_g beta^2 (each (C, p)).

        Population blocks touch beta ONLY through (s1, s2); within one
        jit-traced sweep XLA CSE computes the (C,G,p) reductions once and
        every pop-block evaluation reuses them — O(C p) per proposal
        instead of O(C G p) (the suff-stat hyper-update of SURVEY.md
        section 3.2; the psum over a sharded groups axis happens once,
        inside the s1/s2 reductions). Coordinates are conditionally
        independent (diagonal prior), so log_tau updates per-coordinate
        (units = p) with its own scale and accept decision per k.
        """
        tau2 = jnp.exp(2.0 * log_tau)
        quad = s2 - 2.0 * mu * s1 + G * mu * mu     # (C, p)
        return -0.5 * quad / tau2 - G * log_tau - 0.5 * G * _LOG_2PI

    def _suff(beta):
        return jnp.sum(beta, axis=1), jnp.sum(beta**2, axis=1)

    def cond(name, value, state, data):
        state = {**state, name: value}
        if name == "beta":
            return lik_fn(state["beta"], data) + _gprior(state)
        s1, s2 = _suff(state["beta"])             # (C, p) — CSE'd per sweep
        if name == "mu":
            pprior = logpdf_normal(state["mu"], 0.0, prior_mu_scale)
            return _gprior_perk_from_suff(
                s1, s2, state["mu"], state["log_tau"]
            ) + pprior
        if name == "log_tau":
            pprior = (
                _tau_logprior(state["log_tau"])
                + log_scale_guard(state["log_tau"])
            )
            return _gprior_perk_from_suff(
                s1, s2, state["mu"], state["log_tau"]
            ) + pprior
        raise KeyError(name)

    def gprior_value_and_grad(value, state, data):
        """Closed-form per-group Gaussian prior value+grad wrt beta."""
        mu = state["mu"][:, None, :]
        inv_tau2 = jnp.exp(-2.0 * state["log_tau"])[:, None, :]
        diff = value - mu
        gp_val = jnp.sum(
            -0.5 * diff * diff * inv_tau2
            + 0.5 * jnp.log(inv_tau2) - 0.9189385332046727,
            axis=-1,
        )
        return gp_val, -diff * inv_tau2

    def gprior_vgh(value, state, data):
        """Prior part of the Newton split: the Gaussian prior's negative
        Hessian is the constant precision diagonal diag(1/tau^2), packed
        (C, 1, T) to broadcast over groups."""
        from nestmc.ops.smallchol import pack_diag

        gp_val, gp_grad = gprior_value_and_grad(value, state, data)
        inv_tau2 = jnp.exp(-2.0 * state["log_tau"])      # (C, p)
        return gp_val, gp_grad, pack_diag(inv_tau2, p)[:, None, :]

    # Data-constant packed Hessian BOUND 0.25 sum_i x x^T per group
    # (logistic curvature w = s(1-s) <= 1/4): the preconditioning metric
    # of the joint metric-ASIS move in grad (MALA) mode — built once here
    # from the concrete data, zero runtime obs passes.
    import numpy as np_

    _xn = np_.asarray(data.x, np_.float64)
    if isinstance(data, RaggedData):
        _seg = np_.asarray(data.segment_ids)
        _bound_cols = []
        for _i in range(p):
            for _j in range(_i + 1):
                _col = np_.zeros(G)
                np_.add.at(_col, _seg, 0.25 * _xn[:, _i] * _xn[:, _j])
                _bound_cols.append(_col)
        xxt_bound = jnp.asarray(
            np_.stack(_bound_cols, axis=-1), jnp.float32
        )                                                # (G, T)
    else:
        _mn = np_.asarray(data.mask, np_.float64)
        xxt_bound = jnp.asarray(np_.stack([
            0.25 * np_.sum(_mn * _xn[:, :, _i] * _xn[:, :, _j], axis=1)
            for _i in range(p) for _j in range(_i + 1)
        ], axis=-1), jnp.float32)                        # (G, T)

    def cond_value_and_grad(name, value, state, data):
        """Full fused value+grad of the beta conditional (MALA fallback
        when the grad cache is off). None for other blocks -> generic vjp."""
        if name != "beta":
            return None
        ll, gll = lik_value_and_grad(value, data)
        gp_val, gp_grad = gprior_value_and_grad(value, state, data)
        return ll + gp_val, gll + gp_grad

    def asis_tau_move(key, position, cache, scale, data, frozen=False):
        """ASIS interweaving move (Yu & Meng 2011): MH on log_tau in the
        NON-CENTERED parameterization with z = (beta - mu)/tau held fixed,
        so beta rescales jointly with tau: beta' = mu + (tau'/tau)(beta-mu).

        Centered Gibbs mixes tau slowly because tau | beta is pinned to the
        empirical spread of beta; this move changes that spread directly
        (one likelihood evaluation, current likelihood read from the carried
        cache). Target ratio with z fixed:
          lik(beta') - lik(beta) + log p(tau') - log p(tau)  (+ Jacobians)
        (the z-prior is unchanged by construction).

        When the MALA gradient cache is live (``cache['beta']`` holds
        {'v','g'}) the proposal upgrades from random-walk to LANGEVIN on the
        z-fixed target F(lt) = sum_g lik_g(mu + e^lt z) + log p(lt): the
        chain rule gives F'(lt)_k = sum_g dlik/dbeta_gk (beta_gk - mu_k)
        + d log p/d lt_k, so the drift at the current point reads the
        CARRIED gradient (zero extra obs passes — grad at the proposal is
        computed anyway to refresh the cache) and the asymmetric-proposal
        q-correction uses both. Validated one-step against autodiff of the
        joint (tests/test_asis_grad.py) and by the Geweke grad-ASIS tier
        incl. a dropped-q power check (tests/test_geweke.py).
        """
        k1, k2 = jax.random.split(key)
        beta, mu, lt = position["beta"], position["mu"], position["log_tau"]
        C = lt.shape[0]
        eps = jax.random.normal(k1, lt.shape, lt.dtype)
        diff = beta - mu[:, None, :]                   # tau * z, (C, G, p)
        lik_cache = cache.get("beta")
        grad_mode = isinstance(lik_cache, dict)        # MALA/Newton cache
        newton_mode = grad_mode and "h" in lik_cache   # also carries -Hess

        q = 2 * p                                      # joint (mu, lt) dim

        def _asis_joint_grad(g_lik, d, mu_at, lt_at):
            """(C, 2p) gradient of the z-fixed target F(mu, lt) =
            sum_g lik_g(mu + e^{lt} z) + log p(mu) + log p(lt), by the
            chain rule off the likelihood gradient: dF/dmu_k = sum_g g_gk
            - mu_k/S0^2, dF/dlt_k = sum_g g_gk d_gk + prior'."""
            gsum = jnp.sum(g_lik, axis=1)              # (C, p)
            gd = jnp.sum(g_lik * d, axis=1)            # (C, p)
            return jnp.concatenate([
                gsum - mu_at / prior_mu_scale**2,
                gd + _tau_logprior_grad(lt_at),
            ], axis=-1)

        def _asis_joint_metric(h_packed, d, lt_at):
            """Packed (C, 2p(2p+1)/2) Gauss-Newton metric of the z-fixed
            joint target, ordered theta = (mu_0..mu_{p-1}, lt_0..lt_{p-1}):
              M[mu_k,  mu_l ] = sum_g h_g,kl            + delta_kl / S0^2
              M[lt_k,  mu_l ] = sum_g h_g,kl d_gk
              M[lt_k,  lt_l ] = sum_g h_g,kl d_gk d_gl + delta_kl (-pr'')
            = sum_g J_g^T (-H_g) J_g + prior precision, J_g = [I, diag(d_g)]
            — PSD by construction plus a PD prior diagonal. The exact -F''
            adds an indefinite delta_kl sum_g (-g_gk d_gk) term; ANY
            deterministic positive-definite position-function is a valid
            MH metric, so the PSD Gauss-Newton form is used."""
            from nestmc.ops.smallchol import packed_index

            pm = _tau_logprior_metric(lt_at)           # (C, p)
            cols = [None] * (q * (q + 1) // 2)

            def hkl(k, l):
                return h_packed[..., packed_index(k, l)]

            for i in range(q):
                for j in range(i + 1):
                    if i < p:                          # (mu_i, mu_j)
                        m = jnp.sum(hkl(i, j), axis=1)
                        if i == j:
                            m = m + 1.0 / prior_mu_scale**2
                    elif j < p:                        # (lt_{i-p}, mu_j)
                        k = i - p
                        m = jnp.sum(hkl(k, j) * d[..., k], axis=1)
                    else:                              # (lt_{i-p}, lt_{j-p})
                        k, l = i - p, j - p
                        m = jnp.sum(
                            hkl(k, l) * d[..., k] * d[..., l], axis=1
                        )
                        if k == l:
                            m = m + pm[..., k]
                    cols[packed_index(i, j)] = m
            return jnp.stack([
                jnp.broadcast_to(m, d.shape[:1]) for m in cols
            ], axis=-1)

        if grad_mode:
            # JOINT (mu, tau) METRIC ASIS: the scale interweave (Yu &
            # Meng's ASIS for tau) and the location interweave (for mu,
            # whose centered conjugate draw re-tethers it to beta-bar) as
            # ONE per-chain 2p-dim move on the z-fixed target, at zero
            # extra obs passes. Two proposal grades by what the cache
            # carries:
            #  - newton_mode (Newton-MH beta kernel): full Laplace proposal
            #    N(theta + M^{-1} F', M^{-1}) with the TRUE Gauss-Newton
            #    metric from the carried Hessian — parameter-free (no
            #    adapted scale: kernels/gibbs.py resolves the target to
            #    None); measured acceptance ~0.94 at the judged shape.
            #  - grad mode (MALA beta kernel): PRECONDITIONED Langevin
            #    theta + (s^2/2) Mb^{-1} F' + s Mb^{-1/2} eps with the
            #    data-constant Hessian BOUND Mb built from
            #    xxt_bound = 0.25 sum_i x x^T (the logistic w <= 1/4 bound)
            #    — no Hessian is ever computed; s adapts to 0.574. Strictly
            #    generalizes the round-3 scalar Langevin ASIS (metric I,
            #    tau only) with curvature-shaped, mu-including steps.
            from nestmc.ops.smallchol import (
                chol_packed, half_logdet, lt_vec, solve_upper_t, spd_solve,
            )

            eps_q = jax.random.normal(k1, (C, q), lt.dtype)
            h_src = lik_cache["h"] if newton_mode else xxt_bound[None]
            f_old = _asis_joint_grad(lik_cache["g"], diff, mu, lt)
            m_metric_old = _asis_joint_metric(h_src, diff, lt)
            L_old = chol_packed(m_metric_old, q)
            th_old = jnp.concatenate([mu, lt], axis=-1)
            if newton_mode:
                drift = 1.0
                s = 1.0
            else:
                s = scale                              # (C, 1) adapted
                drift = 0.5 * s * s
            mean_old = th_old + drift * spd_solve(L_old, f_old, q)
            th_new = mean_old + s * solve_upper_t(L_old, eps_q, q)
            mu_new, lt_new = th_new[:, :p], th_new[:, p:]
        else:
            lt_new = lt + scale * eps                  # (C, p)
        ratio = jnp.exp(lt_new - lt)[:, None, :]       # tau'/tau
        base_mu = mu_new if grad_mode else mu          # shift + rescale
        beta_new = base_mu[:, None, :] + diff * ratio
        if grad_mode:
            lik_old = lik_cache["v"]
            if newton_mode and not frozen:
                # the carried -Hessian must track beta: the rescale
                # invalidates it, so the eval pass recomputes it in the
                # same obs pass (w shares the gradient's sigmoid) — it
                # also supplies the reverse-side metric below
                lik_new, grad_new, hess_new = lik_value_grad_hess(
                    beta_new, data
                )
            else:
                # frozen newton: the carried Hessian is a CONSTANT metric
                # (KernelConfig.newton_freeze sampling phase) — the eval
                # pass drops to logp+grad and the metric stays put
                lik_new, grad_new = lik_value_and_grad(beta_new, data)
                if newton_mode:
                    hess_new = lik_cache["h"]
            diff_new = diff * ratio                    # e^{lt'} z
            h_src_new = hess_new if newton_mode else xxt_bound[None]
            f_new = _asis_joint_grad(grad_new, diff_new, mu_new, lt_new)
            m_metric_new = _asis_joint_metric(h_src_new, diff_new, lt_new)
            L_new = chol_packed(m_metric_new, q)
            mean_new = th_new + drift * spd_solve(L_new, f_new, q)
            w_rev = lt_vec(L_new, th_old - mean_new, q)
            # forward whitened residual is exactly s * eps_q by
            # construction; the 1/(2 s^2) normalization cancels the s
            inv_2s2 = 0.5 if newton_mode else 0.5 / (s * s)[:, 0]
            q_corr = (
                -inv_2s2 * jnp.sum(w_rev * w_rev, axis=-1)
                + half_logdet(L_new, q)
                + 0.5 * jnp.sum(eps_q * eps_q, axis=-1)
                - half_logdet(L_old, q)
            )
        else:
            lik_new = lik_fn(beta_new, data)           # (C, G)
            lik_old = lik_cache
            if lik_old is None:
                lik_old = lik_fn(beta, data)
            q_corr = 0.0
        prior_delta = jnp.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt),
            axis=-1,
        )
        if grad_mode:
            prior_delta = prior_delta + jnp.sum(
                -0.5 * (mu_new * mu_new - mu * mu) / prior_mu_scale**2,
                axis=-1,
            )
        log_alpha = (
            jnp.sum(lik_new - lik_old, axis=-1) + prior_delta + q_corr
        )
        logu = jnp.log(jax.random.uniform(
            k2, (C,), lt.dtype, minval=jnp.finfo(lt.dtype).tiny
        ))
        accept = logu < log_alpha
        acc3 = accept[:, None, None]
        pos_up = {
            "beta": jnp.where(acc3, beta_new, beta),
            "log_tau": jnp.where(accept[:, None], lt_new, lt),
            **(
                {"mu": jnp.where(accept[:, None], mu_new, mu)}
                if grad_mode else {}
            ),
        }
        cache_up = {}
        if grad_mode:
            cache_up["beta"] = {
                "v": jnp.where(accept[:, None], lik_new, lik_old),
                "g": jnp.where(acc3, grad_new, lik_cache["g"]),
                **(
                    {"h": lik_cache["h"] if frozen
                     else jnp.where(acc3, hess_new, lik_cache["h"])}
                    if newton_mode else {}
                ),
            }
        elif lik_cache is not None:
            cache_up["beta"] = jnp.where(accept[:, None], lik_new, lik_old)
        alpha = jnp.where(
            jnp.isnan(log_alpha), 0.0,
            jnp.exp(jnp.minimum(log_alpha, 0.0)),
        )
        return pos_up, cache_up, alpha

    def gibbs_mu(key, state, data):
        """EXACT conjugate draw of mu | beta, tau (per coordinate):
        beta_gk ~ N(mu_k, tau_k), mu_k ~ N(0, prior_mu_scale^2) =>
        mu_k | . ~ N(s1_k/tau_k^2 / prec, 1/prec),
        prec = G/tau_k^2 + 1/prior_mu_scale^2."""
        s1, _ = _suff(state["beta"])
        inv_tau2 = jnp.exp(-2.0 * state["log_tau"])
        prec = G * inv_tau2 + 1.0 / prior_mu_scale**2
        mean = s1 * inv_tau2 / prec
        eps = jax.random.normal(key, mean.shape, mean.dtype)
        return mean + eps / jnp.sqrt(prec)

    def gibbs_log_tau(key, state, data):
        """EXACT conjugate draw (invgamma variant): per (chain, coordinate)
        tau_k^2 | beta, mu ~ InvGamma(a + G/2, b + quad_k/2), sampled as
        rate / Gamma(shape) and returned as log tau.

        The clip to [-12, 12] approximates the guard-truncated conditional
        that the MH blocks' log_scale_guard defines; the truncated mass at
        these hyperparameters is immeasurable (|log tau| = 12 is >100 sd
        out), so the two conditionals agree to numerical precision. Same
        convention as nested_poisson's conjugate draws."""
        s1, s2 = _suff(state["beta"])
        mu = state["mu"]
        quad = s2 - 2.0 * mu * s1 + G * mu * mu
        a = tau_ig_shape + 0.5 * G
        b = tau_ig_scale + 0.5 * quad
        g = jax.random.gamma(key, a, shape=quad.shape, dtype=quad.dtype)
        return jnp.clip(0.5 * (jnp.log(b) - jnp.log(g)), -12.0, 12.0)

    def joint(state, data):
        return (
            jnp.sum(lik_fn(state["beta"], data), axis=-1)
            + jnp.sum(_gprior(state), axis=-1)
            + jnp.sum(logpdf_normal(state["mu"], 0.0, prior_mu_scale), axis=-1)
            + jnp.sum(_tau_logprior(state["log_tau"]), axis=-1)
        )

    def init_state(key, data, chains):
        k1, k2, k3 = jax.random.split(key, 3)
        return {
            "beta": 0.5 * jax.random.normal(k1, (chains, G, p)),
            "mu": 0.5 * jax.random.normal(k2, (chains, p)),
            "log_tau": -0.5 + 0.3 * jax.random.normal(k3, (chains, p)),
        }

    def prior_sample(key, data, chains):
        k1, k2, k3 = jax.random.split(key, 3)
        mu = prior_mu_scale * jax.random.normal(k1, (chains, p))
        if conj_tau:
            g = jax.random.gamma(k2, tau_ig_shape, (chains, p))
            tau = jnp.sqrt(tau_ig_scale / g)
        else:
            tau = prior_tau_scale * jnp.abs(
                jax.random.normal(k2, (chains, p))
            )
        beta = mu[:, None, :] + tau[:, None, :] * jax.random.normal(
            k3, (chains, G, p)
        )
        return {"beta": beta, "mu": mu, "log_tau": jnp.log(tau)}

    def sample_data(key, state, data):
        beta = state["beta"][0]  # (G, p)
        if isinstance(data, RaggedData):
            eta = jnp.einsum("np,np->n", jnp.take(beta, data.segment_ids, 0),
                             data.x, precision=jax.lax.Precision.HIGHEST)
            y = jax.random.bernoulli(key, jax.nn.sigmoid(eta))
            return RaggedData(
                y=y.astype(data.y.dtype), segment_ids=data.segment_ids,
                num_groups=data.num_groups, x=data.x, extra=data.extra,
            )
        eta = jnp.einsum("gnp,gp->gn", data.x, beta,
                         precision=jax.lax.Precision.HIGHEST)
        y = jax.random.bernoulli(key, jax.nn.sigmoid(eta))
        return NestedData(
            y=y.astype(data.y.dtype) * data.mask, mask=data.mask,
            sizes=data.sizes, x=data.x, extra=data.extra,
        )

    return ModelSpec(
        name="hier_logistic",
        blocks=(
            Block("beta", (G, p), units=G, init_scale=0.3),
            Block("mu", (p,), units=p, init_scale=0.2),      # conjugate draw
            # per-coordinate MH; O(C p) via suff stats, so repeat it —
            # within-conditional RW autocorrelation was the mixing
            # bottleneck at G=1000 (measured R-hat 1.14 with repeats=1)
            Block("log_tau", (p,), units=p, init_scale=0.2, repeats=4),
        ),
        cond_logdensity=cond,
        joint_logdensity=joint,
        init_state=init_state,
        prior_sample=prior_sample,
        sample_data=sample_data,
        loglik_impls={"selected": chosen},
        # beta's conditional = lik(beta) + gprior(beta, mu, tau); lik depends
        # on no other block, so the kernel carries it across sweeps — one
        # likelihood evaluation per sweep instead of two.
        cond_cached={
            "beta": (
                lambda v, data: lik_fn(v, data),
                lambda v, state, data: _gprior({**state, "beta": v}),
            ),
        },
        gibbs_draws={
            "mu": gibbs_mu,
            **({"log_tau": gibbs_log_tau} if conj_tau else {}),
        },
        # asis_repeats=0 drops the interweaving move entirely (each pass
        # costs one obs-pass likelihood eval; under the Newton kernel beta
        # mixes near-IID so tau's conjugate draw may no longer need it —
        # measured A/B drives the default per config)
        joint_moves=(
            {"asis_tau": asis_tau_move} if asis_repeats > 0 else {}
        ),
        # each repeat costs one obs-pass likelihood eval (~half the sweep);
        # tau mixing is the min-ESS floor on the judged config, so extra
        # interweaving repeats trade sweep cost for tau ESS/sweep
        # (DESIGN.md §3a)
        joint_move_repeats={"asis_tau": max(1, int(asis_repeats))},
        # The ASIS log-alpha sums likelihood deltas over all G groups, so
        # the optimal step is ~ (p G)^(-1/2) (Fisher info grows linearly in
        # G): at G=100k a 0.1 start left the move at 1.6% acceptance for
        # the whole 150-sweep warmup (round-1 mala-100k artifact) while
        # this start lands within one e-fold of the adapted scale.
        joint_move_init_scale={
            "asis_tau": 2.38 / math.sqrt(p * max(G, 1)),
        },
        # grad mode runs the move metric-preconditioned (Hessian-bound
        # Mb), so the optimal step is O(1), not O((pG)^{-1/2}); the bound
        # overestimates curvature ~1.3-2x, so RM settles slightly above 1
        joint_move_init_scale_grad={"asis_tau": 1.0},
        # RW optimum under rwmh; the MALA optimum once the grad cache
        # makes the move Langevin (resolved by kernels/gibbs.py)
        joint_move_target_accept={"asis_tau": "auto"},
        cond_value_and_grad=cond_value_and_grad,
        cond_cached_grad={
            "beta": (lik_value_and_grad, gprior_value_and_grad),
        },
        cond_cached_newton={
            "beta": (lik_value_grad_hess, gprior_vgh),
        },
        # log of tau's conjugate sufficient statistic s2_k = sum_g
        # (beta_gk - mu_k)^2: tau's draw is invgamma(a + G/2, b + s2/2), so
        # ESS(log_s2) is the structural cap on ESS(log_tau) — collect it
        # (opt-in via RunConfig.collect) to attribute the min-ESS floor to
        # beta-spread mixing vs the quality of the tau moves themselves.
        derived={
            "log_s2": lambda pos: jnp.log(
                jnp.sum(
                    (pos["beta"] - pos["mu"][:, None, :]) ** 2, axis=1
                )
            ),
            # per-group log-likelihood (C, G) for WAIC / PSIS-LOO
            # (nestmc/compare.py); closes over the BUILD-time data, and
            # costs one extra obs pass per retained draw when collected —
            # leave it out of `collect` on throughput-critical runs
            "group_loglik": lambda pos: lik_fn(pos["beta"], data),
        },
    )


def synth_logistic(
    key, G: int = 100, n: int = 50, p: int = 4,
    ragged: bool = False, min_obs: int = 5,
    dtype=jnp.float32,
):
    """Synthetic hierarchical-logistic data with known generating params."""
    import numpy as np

    kx, kb, ky, kn, km, kt = jax.random.split(key, 6)
    mu = 0.5 * jax.random.normal(km, (p,))
    tau = 0.3 + 0.3 * jnp.abs(jax.random.normal(kt, (p,)))
    beta = mu + tau * jax.random.normal(kb, (G, p))
    x = jax.random.normal(kx, (G, n, p), dtype=dtype)
    # intercept column keeps the design realistic
    x = x.at[:, :, 0].set(1.0)
    # HIGHEST: the same seed must draw the same data on every platform
    # (a GPU would otherwise run this contraction in TF32)
    eta = jnp.einsum("gnp,gp->gn", x, beta,
                     precision=jax.lax.Precision.HIGHEST)
    y = jax.random.bernoulli(ky, jax.nn.sigmoid(eta)).astype(dtype)
    truth = {"mu": mu, "tau": tau, "beta": beta}
    if not ragged:
        data = NestedData(
            y=y, mask=jnp.ones((G, n), jnp.float32),
            sizes=jnp.full((G,), n, jnp.int32), x=x, extra={},
        )
        return data, truth
    sizes = np.asarray(
        jax.random.randint(kn, (G,), min_obs, n + 1)
    )
    # vectorized flatten (a per-group python loop costs minutes at G=10k)
    y_np, x_np = np.asarray(y), np.asarray(x)
    keep = np.arange(n)[None, :] < sizes[:, None]          # (G, n)
    seg = np.repeat(np.arange(G, dtype=np.int32), sizes)
    data = RaggedData(
        y=jnp.asarray(y_np[keep], dtype=dtype),
        segment_ids=jnp.asarray(seg),
        num_groups=G,
        x=jnp.asarray(x_np[keep], dtype=dtype),
    )
    return data, truth
