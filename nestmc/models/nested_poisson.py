"""Three-level nested Poisson GLMM — BASELINE.json:9 (config 3).

    y_si  ~ Poisson(exp(x_si . beta_s))        obs i within subject s
    beta_s ~ N(beta_{g(s)}, diag(tau_s^2))      subjects within groups
    beta_g ~ N(mu, diag(tau_g^2))
    mu_k ~ N(0, prior_mu_scale^2); tau_* ~ HalfNormal(prior_tau_scale)

Gibbs blocks (all batched over chains):
  beta_s: S independent units — obs-level likelihood + subject prior;
  beta_g: G independent units — segment-sum of its subjects' prior terms
          (subject->group via ``segment_sum``) + group prior; NO data touch;
  mu, log_tau_g, log_tau_s: population scalars.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from nestmc.data import NestedData3
from nestmc.distributions import (
    log_scale_guard,
    logpdf_halfnormal,
    logpdf_normal,
)
from nestmc.model import Block, ModelSpec


def _segsum_cs_to_cg(arr_cs, subject_group, num_groups):
    # (C, S) -> (C, G)
    return jax.ops.segment_sum(
        arr_cs.T, subject_group, num_segments=num_groups,
        indices_are_sorted=True,
    ).T


def _resolve_loglik(data: NestedData3, impl: str):
    """(value, value_grad, value_grad_hess, chosen) of the subject-level
    Poisson obs pass, each f(beta_s, data, lgamma_y); the implementation
    is chosen by ops/dispatch.py ('triton' on a GPU, 'jnp' elsewhere)."""
    import numpy as np

    from nestmc.ops.dispatch import loglik_impl, padded_obs_pass

    chosen = loglik_impl("poisson", impl)
    dense = bool(np.all(np.asarray(data.mask) == 1.0))
    fns = padded_obs_pass("poisson", chosen, dense=dense)

    def bind(f):
        def g(beta_s, d, lgamma_y):
            return f(beta_s, d.x, d.y, d.mask, lgamma_y)
        return g
    return (*(bind(f) for f in fns), chosen)


def make_nested_poisson(
    data: NestedData3,
    prior_mu_scale: float = 2.0,
    prior_tau_scale: float = 1.0,
    loglik_impl: str = "auto",
    tau_prior: str = "halfnormal",
    tau_ig_shape: float = 2.0,
    tau_ig_scale: float = 0.25,
    asis_tau_g_repeats: int = 4,
    asis_tau_s_repeats: int = 2,
) -> ModelSpec:
    """tau_prior: 'halfnormal' (tau ~ HN(prior_tau_scale), per-coordinate
    MH on log tau) or 'invgamma' (tau^2 ~ InvGamma(shape, scale): the taus
    become EXACT conjugate Gibbs draws given the level below — the
    normal-inverse-gamma conjugate update of SURVEY.md section 3.2 — which
    removes the scale blocks from the mixing budget entirely).

    asis_tau_g_repeats / asis_tau_s_repeats: interweaving-move repetitions
    per sweep. tau_g's move is O(C S p) elementwise (touches no data, so
    repeats are nearly free) and log_tau_g is the slowest mode at config-3
    scale; tau_s's move costs one obs-likelihood pass per repeat."""
    S = data.num_subjects
    G = data.num_groups
    p = data.num_covariates
    if tau_prior not in ("halfnormal", "invgamma"):
        raise ValueError(tau_prior)
    conj_tau = tau_prior == "invgamma"
    lik_fn, lik_vg, lik_vgh, chosen = _resolve_loglik(data, loglik_impl)

    def _lik(beta_s, d):
        # lgamma(y+1) is computed from the TRACED data (not baked in as a
        # closure constant) so group-axis data sharding flows through the
        # jit boundary; it is O(S n) vs the O(C S n) likelihood, and XLA
        # hoists the loop-invariant table out of the scan body.
        return lik_fn(beta_s, d, gammaln(d.y + 1.0))

    def _tau_logprior(lt):
        """log p(log tau) elementwise, incl. the Jacobian to log space."""
        if conj_tau:
            # tau^2 ~ IG(a, b); lt = log tau => tau^2 = e^{2 lt},
            # |d tau^2 / d lt| = 2 e^{2 lt}
            a, b = tau_ig_shape, tau_ig_scale
            return (
                a * jnp.log(b) - gammaln(a)
                - 2.0 * (a + 1.0) * lt - b * jnp.exp(-2.0 * lt)
                + jnp.log(2.0) + 2.0 * lt
            )
        return logpdf_halfnormal(jnp.exp(lt), prior_tau_scale) + lt

    def _tau_logprior_grad(lt):
        """d/d(log tau) of _tau_logprior, elementwise (analytic; drives
        the Langevin drift of the interweaving moves)."""
        if conj_tau:
            a, b = tau_ig_shape, tau_ig_scale
            return -2.0 * a + 2.0 * b * jnp.exp(-2.0 * lt)
        return 1.0 - jnp.exp(2.0 * lt) / prior_tau_scale**2

    def _tau_logprior_metric(lt):
        """-d^2/d(log tau)^2 of _tau_logprior — the prior term of the
        Laplace interweave's metric; positive for both priors."""
        if conj_tau:
            return 4.0 * tau_ig_scale * jnp.exp(-2.0 * lt)
        return 2.0 * jnp.exp(2.0 * lt) / prior_tau_scale**2

    def _sprior(state, d):
        # beta_s | beta_g: (C, S)
        bg = jnp.take(state["beta_g"], d.subject_group, axis=1)  # (C,S,p)
        tau_s = jnp.exp(state["log_tau_s"])[:, None, :]
        return jnp.sum(logpdf_normal(state["beta_s"], bg, tau_s), axis=-1)

    def _gprior(state):
        mu = state["mu"][:, None, :]
        tau_g = jnp.exp(state["log_tau_g"])[:, None, :]
        return jnp.sum(logpdf_normal(state["beta_g"], mu, tau_g), axis=-1)

    def _pprior(state):
        return (
            jnp.sum(logpdf_normal(state["mu"], 0.0, prior_mu_scale), axis=-1)
            + jnp.sum(_tau_logprior(state["log_tau_s"]), axis=-1)
            + jnp.sum(_tau_logprior(state["log_tau_g"]), axis=-1)
        )

    _LOG_2PI = 1.8378770664093453

    # Sufficient statistics (C, p): CSE'd once per jit-traced sweep; the
    # only cross-shard reductions the population updates need (one psum
    # each when subjects/groups are sharded). Coordinates are conditionally
    # independent (diagonal priors) -> hyper blocks update per-coordinate
    # (units = p) with their own scales and accept decisions.
    def _suff_g(state):
        bg = state["beta_g"]
        return jnp.sum(bg, axis=1), jnp.sum(bg**2, axis=1)

    def _dev2_s(state, d):
        bg_s = jnp.take(state["beta_g"], d.subject_group, axis=1)
        dev = state["beta_s"] - bg_s
        return jnp.sum(dev * dev, axis=1)  # (C, p)

    def cond(name, value, state, data):
        state = {**state, name: value}
        if name == "beta_s":
            return _lik(state["beta_s"], data) + _sprior(state, data)
        if name == "beta_g":
            return (
                _segsum_cs_to_cg(
                    _sprior(state, data), data.subject_group, G
                )
                + _gprior(state)
            )
        if name in ("mu", "log_tau_g"):
            s1, s2 = _suff_g(state)
            mu, lt = state["mu"], state["log_tau_g"]
            quad = s2 - 2.0 * mu * s1 + G * mu * mu
            base = (
                -0.5 * quad * jnp.exp(-2.0 * lt) - G * lt
                - 0.5 * G * _LOG_2PI
            )  # (C, p) per-coordinate
            if name == "mu":
                return base + logpdf_normal(mu, 0.0, prior_mu_scale)
            return base + _tau_logprior(lt) + log_scale_guard(lt)
        if name == "log_tau_s":
            d2 = _dev2_s(state, data)
            lt = state["log_tau_s"]
            return (
                -0.5 * d2 * jnp.exp(-2.0 * lt) - S * lt - 0.5 * S * _LOG_2PI
                + _tau_logprior(lt) + log_scale_guard(lt)
            )
        raise KeyError(name)

    def lik_value_and_grad(value, data_):
        """(loglik (C,S), grad (C,S,p)) of the obs likelihood only."""
        return lik_vg(value, data_, gammaln(data_.y + 1.0))

    def sprior_value_and_grad(value, state, data_):
        bg_s = jnp.take(state["beta_g"], data_.subject_group, axis=1)
        inv_tau2 = jnp.exp(-2.0 * state["log_tau_s"])[:, None, :]
        diff = value - bg_s
        val = jnp.sum(
            -0.5 * diff * diff * inv_tau2
            + 0.5 * jnp.log(inv_tau2) - 0.9189385332046727,
            axis=-1,
        )
        return val, -diff * inv_tau2

    def lik_value_grad_hess(value, data_):
        """(loglik (C,S), grad (C,S,p), packed -Hessian (C,S,T)) of the
        obs likelihood — the Newton-MH obs pass (kernels/newton.py). The
        Poisson curvature w = exp(eta) is the rate the gradient already
        computed: zero extra transcendentals."""
        return lik_vgh(value, data_, gammaln(data_.y + 1.0))

    def sprior_vgh(value, state, data_):
        """Subject-prior part of the Newton split: the Gaussian prior's
        negative Hessian is the constant precision diagonal
        diag(1/tau_s^2), packed (C, 1, T) to broadcast over subjects."""
        from nestmc.ops.smallchol import pack_diag

        val, grad = sprior_value_and_grad(value, state, data_)
        inv_ts2 = jnp.exp(-2.0 * state["log_tau_s"])     # (C, p)
        return val, grad, pack_diag(inv_ts2, p)[:, None, :]

    def gibbs_mu(key, state, data):
        """Exact conjugate draw of mu | beta_g, tau_g (per coordinate)."""
        s1, _ = _suff_g(state)
        inv_tau2 = jnp.exp(-2.0 * state["log_tau_g"])
        prec = G * inv_tau2 + 1.0 / prior_mu_scale**2
        mean = s1 * inv_tau2 / prec
        eps = jax.random.normal(key, mean.shape, mean.dtype)
        return mean + eps / jnp.sqrt(prec)

    def _gibbs_tau(key, quad, n_units):
        """Exact conjugate draw of log tau given the quadratic suff stat:
        tau^2 | . ~ InvGamma(a + n/2, b + quad/2), per (chain, coordinate);
        sampled as b' / Gamma(a') and clipped to the log-scale guard bounds."""
        a = tau_ig_shape + 0.5 * n_units
        b = tau_ig_scale + 0.5 * quad
        g = jax.random.gamma(key, a, shape=quad.shape, dtype=quad.dtype)
        lt = 0.5 * (jnp.log(b) - jnp.log(g))
        return jnp.clip(lt, -12.0, 12.0)

    def gibbs_log_tau_g(key, state, data):
        s1, s2 = _suff_g(state)
        mu = state["mu"]
        quad = s2 - 2.0 * mu * s1 + G * mu * mu
        return _gibbs_tau(key, quad, G)

    def gibbs_log_tau_s(key, state, data):
        return _gibbs_tau(key, _dev2_s(state, data), S)

    def gibbs_beta_g(key, state, data):
        """EXACT conjugate draw of beta_g | beta_s, mu, tau_s, tau_g.

        beta_g touches no data (beta_s ~ N(beta_g, tau_s), beta_g ~
        N(mu, tau_g): all Gaussian), so its full conditional is
        N((S_g/tau_s^2 + mu/tau_g^2)/prec, 1/prec) per (group, coordinate),
        prec = n_subjects(g)/tau_s^2 + 1/tau_g^2 — acceptance 1, removes the
        middle level's random-walk bottleneck entirely."""
        # per-group sums of beta_s: (C, G, p)
        s_g = jax.ops.segment_sum(
            jnp.swapaxes(state["beta_s"], 0, 1), data.subject_group,
            num_segments=G, indices_are_sorted=True,
        )
        s_g = jnp.swapaxes(s_g, 0, 1)
        inv_ts2 = jnp.exp(-2.0 * state["log_tau_s"])[:, None, :]
        inv_tg2 = jnp.exp(-2.0 * state["log_tau_g"])[:, None, :]
        # (G,) subject counts from the TRACED data (loop-invariant; XLA
        # hoists it out of the scan body)
        subj_counts = data.subjects_per_group().astype(jnp.float32)
        prec = subj_counts[None, :, None] * inv_ts2 + inv_tg2
        mean = (s_g * inv_ts2 + state["mu"][:, None, :] * inv_tg2) / prec
        eps = jax.random.normal(key, mean.shape, mean.dtype)
        return mean + eps / jnp.sqrt(prec)

    def asis_tau_g_move(key, position, cache, scale, data_):
        """ASIS interweaving for (tau_g, beta_g): rescale beta_g about mu
        with z_g fixed. beta_s is unchanged, so the data likelihood is
        untouched — the target ratio is the subject-prior change (beta_s |
        beta_g') plus the tau_g prior/Jacobian. O(C S p) elementwise, no
        likelihood evaluation.

        ALWAYS a LAPLACE proposal (parameter-free, no adapted scale —
        joint_move_target_accept pins None): the z-fixed target's gradient
        AND Gauss-Newton metric are analytic Gaussian algebra (no data
        touch). Per coordinate k (coordinates factorize — the metric is
        diagonal):
          F'(lt)_k  = sum_s dev_sk / tau_s^2 * (beta_g'(s) - mu)_sk + pr'
          M(lt)_k   = sum_s (beta_g'(s) - mu)_sk^2 / tau_s^2 + (-pr'')
        (the PSD Gauss-Newton form of -F''; any deterministic PD
        position-function is a valid metric), proposal
        lt' = lt + F'/M + eps/sqrt(M) with the full asymmetric correction
        including the log-determinant ratio. Validated one-step against
        autodiff of the joint + dense reference (tests/test_asis_grad3.py)
        and by the Geweke-3 tier."""
        k1, k2 = jax.random.split(key)
        bg, mu, lt = position["beta_g"], position["mu"], position["log_tau_g"]
        bs, lts = position["beta_s"], position["log_tau_s"]
        C = lt.shape[0]
        inv_ts2 = jnp.exp(-2.0 * lts)[:, None, :]      # (C, 1, p)
        diff_g = bg - mu[:, None, :]                   # tau_g * z, (C, G, p)

        def _quad_grad_metric(bg_eff, lt_at):
            """(Σ_s -dev²/2τs² (C,), F' (C, p), M (C, p)) of the z-fixed
            target at the rescale bg_eff; the -S log tau_s terms are
            constant across the move and cancel in differences."""
            bg_s = jnp.take(bg_eff, data_.subject_group, axis=1)
            dev = bs - bg_s
            d_s = bg_s - mu[:, None, :]
            val = jnp.sum(-0.5 * dev * dev * inv_ts2, axis=(1, 2))
            grad = (
                jnp.sum(dev * inv_ts2 * d_s, axis=1)
                + _tau_logprior_grad(lt_at)
            )
            metric = (
                jnp.sum(d_s * d_s * inv_ts2, axis=1)
                + _tau_logprior_metric(lt_at)
            )
            return val, grad, metric

        val_old, g_old, m_old = _quad_grad_metric(bg, lt)
        eps = jax.random.normal(k1, lt.shape, lt.dtype)
        mean_old = lt + g_old / m_old
        lt_new = mean_old + eps / jnp.sqrt(m_old)
        ratio = jnp.exp(lt_new - lt)[:, None, :]
        bg_new = mu[:, None, :] + diff_g * ratio
        val_new, g_new, m_new = _quad_grad_metric(bg_new, lt_new)
        mean_new = lt_new + g_new / m_new
        rev = lt - mean_new
        q_corr = jnp.sum(
            -0.5 * rev * rev * m_new + 0.5 * jnp.log(m_new)
            + 0.5 * eps * eps - 0.5 * jnp.log(m_old),
            axis=-1,
        )
        prior_delta = jnp.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt), axis=-1,
        )
        log_alpha = val_new - val_old + prior_delta + q_corr
        logu = jnp.log(jax.random.uniform(
            k2, (C,), lt.dtype, minval=jnp.finfo(lt.dtype).tiny
        ))
        accept = logu < log_alpha
        pos_up = {
            "beta_g": jnp.where(accept[:, None, None], bg_new, bg),
            "log_tau_g": jnp.where(accept[:, None], lt_new, lt),
        }
        alpha = jnp.where(
            jnp.isnan(log_alpha), 0.0,
            jnp.exp(jnp.minimum(log_alpha, 0.0)),
        )
        return pos_up, {}, alpha

    def asis_tau_s_move(key, position, cache, scale, data_, frozen=False):
        """ASIS interweaving for (tau_s, beta_s): rescale beta_s about its
        group mean with z_s fixed. Changes beta_s, so one likelihood
        evaluation (refreshing the carried cache).

        With the MALA gradient cache live ({'v','g'}) the proposal is
        LANGEVIN on the z-fixed target, drift from the carried likelihood
        gradient: F'(lt)_k = sum_s dlik/dbeta_sk (beta_s - beta_g(s))_sk
        + d log p(tau_s)/d lt_k — zero extra obs passes (the proposal-side
        gradient refreshes the cache anyway). One-step-validated against
        autodiff (tests/test_asis_grad3.py).

        With the NEWTON cache live ({'v','g','h'}) the move upgrades to a
        parameter-free LAPLACE proposal (no adapted scale; gibbs.py
        resolves the 'auto' target to None): the p-dim Gauss-Newton metric
        of the z-fixed target reads the carried packed likelihood Hessian
        M_kl = sum_s h_s,kl d_sk d_sl + delta_kl (-pr''), d = beta_s -
        beta_g(s) — PSD by construction plus the PD prior diagonal (the
        same construction as hier_logistic's joint metric-ASIS move).
        frozen (KernelConfig.newton_freeze sampling phase): the carried
        Hessian is a constant — the eval pass drops to logp+grad and the
        metric passes through untouched."""
        k1, k2 = jax.random.split(key)
        bs, lt = position["beta_s"], position["log_tau_s"]
        C = lt.shape[0]
        bg_s = jnp.take(position["beta_g"], data_.subject_group, axis=1)
        diff = bs - bg_s                               # tau_s * z, (C, S, p)
        eps = jax.random.normal(k1, lt.shape, lt.dtype)
        lik_cache = cache.get("beta_s")
        grad_mode = isinstance(lik_cache, dict)
        newton_mode = grad_mode and "h" in lik_cache
        if newton_mode:
            from nestmc.ops.smallchol import (
                chol_packed, half_logdet, lt_vec, packed_index,
                solve_upper_t, spd_solve,
            )

            def _metric(h_packed, d, lt_at):
                """Packed (C, T) Gauss-Newton metric of the z-fixed
                target: M_kl = sum_s h_s,kl d_sk d_sl + delta_kl (-pr'')."""
                pm = _tau_logprior_metric(lt_at)       # (C, p)
                cols = []
                for i in range(p):
                    for j in range(i + 1):
                        m = jnp.sum(
                            h_packed[..., packed_index(i, j)]
                            * d[..., i] * d[..., j], axis=1,
                        )
                        if i == j:
                            m = m + pm[..., i]
                        cols.append(m)
                return jnp.stack(cols, axis=-1)

            f_old = (
                jnp.sum(lik_cache["g"] * diff, axis=1)
                + _tau_logprior_grad(lt)
            )                                          # (C, p)
            m_old = _metric(lik_cache["h"], diff, lt)
            L_old = chol_packed(m_old, p)
            mean_old = lt + spd_solve(L_old, f_old, p)
            lt_new = mean_old + solve_upper_t(L_old, eps, p)
        elif grad_mode:
            s2 = scale * scale                         # (C, 1)
            g_old = (
                jnp.sum(lik_cache["g"] * diff, axis=1)
                + _tau_logprior_grad(lt)
            )                                          # (C, p)
            lt_new = lt + 0.5 * s2 * g_old + scale * eps
        else:
            lt_new = lt + scale * eps
        ratio = jnp.exp(lt_new - lt)[:, None, :]
        bs_new = bg_s + diff * ratio
        if grad_mode:
            lik_old = lik_cache["v"]
            if newton_mode and not frozen:
                lik_new, grad_new, hess_new = lik_value_grad_hess(
                    bs_new, data_
                )
            else:
                lik_new, grad_new = lik_value_and_grad(bs_new, data_)
                if newton_mode:
                    hess_new = lik_cache["h"]          # constant metric
            if newton_mode:
                diff_new = diff * ratio
                f_new = (
                    jnp.sum(grad_new * diff_new, axis=1)
                    + _tau_logprior_grad(lt_new)
                )
                m_new = _metric(hess_new, diff_new, lt_new)
                L_new = chol_packed(m_new, p)
                mean_new = lt_new + spd_solve(L_new, f_new, p)
                w_rev = lt_vec(L_new, lt - mean_new, p)
                # forward whitened residual is exactly eps by construction
                q_corr = (
                    -0.5 * jnp.sum(w_rev * w_rev, axis=-1)
                    + half_logdet(L_new, p)
                    + 0.5 * jnp.sum(eps * eps, axis=-1)
                    - half_logdet(L_old, p)
                )
            else:
                g_new = (
                    jnp.sum(grad_new * diff * ratio, axis=1)
                    + _tau_logprior_grad(lt_new)
                )
                fwd = lt_new - lt - 0.5 * s2 * g_old   # = scale * eps
                rev = lt - lt_new - 0.5 * s2 * g_new
                q_corr = jnp.sum(fwd * fwd - rev * rev, axis=-1) / (
                    2.0 * s2[:, 0]
                )
        else:
            lik_new = _lik(bs_new, data_)
            lik_old = lik_cache
            if lik_old is None:
                lik_old = _lik(bs, data_)
            q_corr = 0.0
        prior_delta = jnp.sum(
            _tau_logprior(lt_new) + log_scale_guard(lt_new)
            - _tau_logprior(lt), axis=-1,
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
            "beta_s": jnp.where(acc3, bs_new, bs),
            "log_tau_s": jnp.where(accept[:, None], lt_new, lt),
        }
        cache_up = {}
        if grad_mode:
            cache_up["beta_s"] = {
                "v": jnp.where(accept[:, None], lik_new, lik_old),
                "g": jnp.where(acc3, grad_new, lik_cache["g"]),
                **(
                    {"h": lik_cache["h"] if frozen
                     else jnp.where(acc3, hess_new, lik_cache["h"])}
                    if newton_mode else {}
                ),
            }
        elif lik_cache is not None:
            cache_up["beta_s"] = jnp.where(
                accept[:, None], lik_new, lik_old
            )
        alpha = jnp.where(
            jnp.isnan(log_alpha), 0.0,
            jnp.exp(jnp.minimum(log_alpha, 0.0)),
        )
        return pos_up, cache_up, alpha

    def joint(state, data):
        return (
            jnp.sum(_lik(state["beta_s"], data), axis=-1)
            + jnp.sum(_sprior(state, data), axis=-1)
            + jnp.sum(_gprior(state), axis=-1)
            + _pprior(state)
        )

    def init_state(key, data, chains):
        ks = jax.random.split(key, 5)
        return {
            "beta_s": 0.2 * jax.random.normal(ks[0], (chains, S, p)),
            "beta_g": 0.2 * jax.random.normal(ks[1], (chains, G, p)),
            "mu": 0.2 * jax.random.normal(ks[2], (chains, p)),
            "log_tau_s": -1.0 + 0.2 * jax.random.normal(ks[3], (chains, p)),
            "log_tau_g": -1.0 + 0.2 * jax.random.normal(ks[4], (chains, p)),
        }

    def prior_sample(key, data, chains):
        ks = jax.random.split(key, 5)
        mu = prior_mu_scale * jax.random.normal(ks[0], (chains, p))
        if conj_tau:
            # tau^2 ~ InvGamma(a, b), sampled as b / Gamma(a) — the ACTUAL
            # prior of the invgamma variant (Geweke/SBC calibration draws
            # from here; using the half-normal would fail them, correctly)
            g1 = jax.random.gamma(ks[1], tau_ig_shape, (chains, p))
            g2 = jax.random.gamma(ks[2], tau_ig_shape, (chains, p))
            tau_g = jnp.sqrt(tau_ig_scale / g1)
            tau_s = jnp.sqrt(tau_ig_scale / g2)
        else:
            tau_g = prior_tau_scale * jnp.abs(
                jax.random.normal(ks[1], (chains, p))
            )
            tau_s = prior_tau_scale * jnp.abs(
                jax.random.normal(ks[2], (chains, p))
            )
        beta_g = mu[:, None, :] + tau_g[:, None, :] * jax.random.normal(
            ks[3], (chains, G, p)
        )
        bg_s = jnp.take(beta_g, data.subject_group, axis=1)
        beta_s = bg_s + tau_s[:, None, :] * jax.random.normal(
            ks[4], (chains, S, p)
        )
        return {
            "beta_s": beta_s, "beta_g": beta_g, "mu": mu,
            "log_tau_s": jnp.log(tau_s), "log_tau_g": jnp.log(tau_g),
        }

    def sample_data(key, state, data):
        eta = jnp.einsum("snp,sp->sn", data.x, state["beta_s"][0],
                         precision=jax.lax.Precision.HIGHEST)
        y = jax.random.poisson(key, jnp.exp(eta)).astype(data.y.dtype)
        return NestedData3(
            y=y * data.mask, mask=data.mask,
            subject_group=data.subject_group, num_groups=G,
            x=data.x, extra=data.extra,
        )

    return ModelSpec(
        name="nested_poisson",
        blocks=(
            Block("beta_s", (S, p), units=S, init_scale=0.2),
            Block("beta_g", (G, p), units=G, init_scale=0.2),
            Block("mu", (p,), units=p, init_scale=0.15),      # conjugate
            Block("log_tau_g", (p,), units=p, init_scale=0.2, repeats=4),
            Block("log_tau_s", (p,), units=p, init_scale=0.2, repeats=4),
        ),
        cond_logdensity=cond,
        joint_logdensity=joint,
        init_state=init_state,
        prior_sample=prior_sample,
        sample_data=sample_data,
        loglik_impls={"selected": chosen},
        # the obs-level likelihood depends only on beta_s — carried across
        # sweeps so each sweep evaluates it once (for the proposal).
        cond_cached={
            "beta_s": (
                lambda v, data: _lik(v, data),
                lambda v, state, data: _sprior(
                    {**state, "beta_s": v}, data
                ),
            ),
        },
        cond_cached_grad={
            "beta_s": (lik_value_and_grad, sprior_value_and_grad),
        },
        cond_cached_newton={
            "beta_s": (lik_value_grad_hess, sprior_vgh),
        },
        gibbs_draws={
            "mu": gibbs_mu,
            "beta_g": gibbs_beta_g,
            **(
                {
                    "log_tau_g": gibbs_log_tau_g,
                    "log_tau_s": gibbs_log_tau_s,
                }
                if conj_tau else {}
            ),
        },
        joint_moves={
            "asis_tau_g": asis_tau_g_move,
            "asis_tau_s": asis_tau_s_move,
        },
        # tau_g interweaving touches no data (O(C S p) elementwise) — repeat
        # it; tau_s interweaving costs one likelihood eval, repeat modestly
        joint_move_repeats={
            "asis_tau_g": max(1, int(asis_tau_g_repeats)),
            "asis_tau_s": max(1, int(asis_tau_s_repeats)),
        },
        # size-aware starts: each move's log-alpha sums over S subject-prior
        # terms (tau_g) / all N=sum(mask) obs-likelihood terms (tau_s), so
        # optimal steps shrink like the inverse square root of those counts
        joint_move_init_scale={
            "asis_tau_g": 2.38 / math.sqrt(p * max(S, 1)),
            "asis_tau_s": 2.38 / math.sqrt(
                p * max(int(jnp.sum(data.mask)), 1)
            ),
        },
        joint_move_target_accept={
            # tau_g's move is a parameter-free LAPLACE proposal (analytic
            # gradient + metric); None = no scale adaptation
            "asis_tau_g": None,
            # tau_s upgrades to Langevin only when the grad cache is live
            "asis_tau_s": "auto",
        },
        # per-unit log-likelihoods for WAIC / PSIS-LOO (nestmc/compare.py):
        # subject-level (C, S) and group-level (C, G) — the two candidate
        # exchangeable prediction units of 3-level data. Closes over the
        # build-time data; one extra obs pass per retained draw when
        # collected.
        derived={
            "subject_loglik": lambda pos: _lik(pos["beta_s"], data),
            "group_loglik": lambda pos: _segsum_cs_to_cg(
                _lik(pos["beta_s"], data), data.subject_group, G
            ),
        },
    )


def synth_poisson3(
    key, G: int = 20, subjects_per_group: int = 5, n: int = 10, p: int = 3,
    dtype=jnp.float32,
):
    """Synthetic 3-level Poisson data with known generating params."""
    S = G * subjects_per_group
    ks = jax.random.split(key, 6)
    mu = 0.3 * jax.random.normal(ks[0], (p,))
    tau_g = 0.2 + 0.1 * jnp.abs(jax.random.normal(ks[1], (p,)))
    tau_s = 0.2 + 0.1 * jnp.abs(jax.random.normal(ks[2], (p,)))
    beta_g = mu + tau_g * jax.random.normal(ks[3], (G, p))
    subject_group = jnp.repeat(jnp.arange(G, dtype=jnp.int32),
                               subjects_per_group)
    beta_s = jnp.take(beta_g, subject_group, axis=0) + tau_s * (
        jax.random.normal(ks[4], (S, p))
    )
    x = 0.5 * jax.random.normal(ks[5], (S, n, p), dtype=dtype)
    x = x.at[:, :, 0].set(1.0)
    # HIGHEST: the same seed must draw the same data on every platform
    eta = jnp.einsum("snp,sp->sn", x, beta_s,
                     precision=jax.lax.Precision.HIGHEST)
    y = jax.random.poisson(jax.random.fold_in(key, 7), jnp.exp(eta)).astype(
        dtype
    )
    data = NestedData3(
        y=y, mask=jnp.ones((S, n), jnp.float32),
        subject_group=subject_group, num_groups=G, x=x, extra={},
    )
    truth = {"mu": mu, "tau_g": tau_g, "tau_s": tau_s}
    return data, truth
