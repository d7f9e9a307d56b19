"""Batched Newton-MH (manifold/Laplace) block update.

Proposal: v' ~ N(v + H(v)^{-1} g(v), c * H(v)^{-1}) where g is the gradient
and H the NEGATIVE Hessian of the block's conditional log-density — the
full-step simplified-manifold-MALA of Girolami & Calderhead (2011) / the
"stochastic Newton" MH of Martin et al. (2012). For an exactly Gaussian
conditional the proposal at c = 1 IS the conditional (mean = conditional
mean, covariance = conditional covariance), so the move is an exact Gibbs
draw: acceptance 1 and IID draws (tests/test_newton.py asserts this on the
conjugate linear-Gaussian model). For the log-concave near-Gaussian
conditionals of nested GLMMs (logistic / Poisson group blocks at n >= 10
obs per group) acceptance stays near 1 and successive draws are nearly
independent — this is what lifts the judged config's min-ESS floor, which
is structurally capped by beta's OWN mixing rate under MALA
(ESS(log_tau) = 1.05 x ESS of its sufficient statistic, DESIGN.md §3b).

Cost per update: ONE fused obs pass (value+grad+packed-Hessian — the
Hessian adds p(p+1)/2 multiply-accumulates per obs to the MALA pass and
zero extra transcendentals) plus O(C U p^2) unrolled Cholesky algebra
(ops/smallchol.py) that XLA fuses into the surrounding elementwise chain.
Same pass count as MALA; the exchange rate is ~2.5x ESS per draw.

Exactness: this is a standard MH kernel with a position-dependent Gaussian
proposal — H(v) is a deterministic function of the value being updated, so
no adaptation/history enters q and detailed balance is exact (validated by
the Geweke newton tier and one-step ratio tests).

The per-(chain, unit) log_scale acts as log sqrt(c) (proposal-covariance
damping). Default c = 1 (init_scale handling in kernels/state.py) and NO
Robbins-Monro adaptation: near-Gaussian targets have acceptance ~1 at c = 1
and acceptance is non-monotone in c, so targeting a fixed rate is ill-posed
for this kernel; c is a manual robustness knob for heavy-tailed conditionals.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nestmc.kernels.rwmh import accept_prob, as_cu, select_accepted
from nestmc.model import Block, ModelSpec
from nestmc.ops.smallchol import (
    chol_packed,
    half_logdet,
    lt_vec,
    solve_upper_t,
    spd_solve,
)


def cond_value_grad_hess(model: ModelSpec, name, value, position, data):
    """((C,U), grad, packed -Hessian) of the block conditional, summing the
    model's (self, rest) split. Newton blocks must declare
    ModelSpec.cond_cached_newton — there is no generic autodiff fallback
    (a jax.hessian through the obs pass would materialize (C,U,p,p,n))."""
    self_vgh, rest_vgh = model.cond_cached_newton[name]
    sv, sg, sh = self_vgh(value, data)
    rv, rg, rh = rest_vgh(value, position, data)
    return sv + rv, sg + rg, sh + rh


def newton_update(key, block: Block, model: ModelSpec, position, log_scale,
                  pstd, data, cache=None, frozen=False):
    """One Newton-MH update of ``block`` for all chains and units.

    ``cache``: optional {'v','g','h'} carried (loglik, grad, packed
    -Hessian) of the SELF-CONTAINED conditional part at the current value
    (cond_cached_newton) — one obs pass per update instead of two.
    ``pstd`` is ignored: H(v) is the preconditioner.

    ``frozen`` (KernelConfig.newton_freeze sampling phase): treat the
    cached likelihood Hessian as a CONSTANT metric — the proposal-side obs
    pass keeps only (value, grad); the Hessian terms are never read, so
    XLA dead-code-eliminates their computation. The frozen Hessian is a
    constant during the sampling phase, so the proposal stays a
    deterministic function of the conditioning state and detailed balance
    is exact for ANY fixed PD value (Geweke frozen tier). Requires a live
    cache (the engine always carries one for Newton blocks).

    Shapes: grouped blocks with a 1-D per-unit vector (value (C, U, p),
    grad value-shaped, packed Hessian (C, U, T)); grouped blocks with
    SCALAR units (unit_shape (), e.g. per-group intercepts) are handled as
    p = 1 — the model hooks then return grad and Hessian both (C, U).
    """
    scalar_units = block.units and len(block.unit_shape) == 0
    if not scalar_units and len(block.unit_shape) != 1:
        raise ValueError(
            f"newton kernel needs a 1-D (or scalar) per-unit parameter; "
            f"block {block.name!r} has unit_shape {block.unit_shape}"
        )
    p = 1 if scalar_units else int(block.unit_shape[0])
    # internal math runs with an explicit trailing parameter axis; model
    # hooks see the block's native (possibly trailing-axis-free) shape
    ex = (lambda a: a[..., None]) if scalar_units else (lambda a: a)
    sq = (lambda a: a[..., 0]) if scalar_units else (lambda a: a)
    value = position[block.name]
    k_eps, k_u = jax.random.split(key)

    self_vgh, rest_vgh = model.cond_cached_newton[block.name]
    if cache is not None:
        sv, sg, sh = cache["v"], cache["g"], cache["h"]
    else:
        sv, sg, sh = self_vgh(value, data)
        sv = as_cu(sv, block)
    rv_old, rg_old, rh_old = rest_vgh(value, position, data)
    d_old = sv + as_cu(rv_old, block)
    g_old = ex(sg + rg_old)
    h_old = ex(sh + rh_old)

    # sqrt(c): (C, U') or (C, 1) -> broadcast over the packed/vector axes
    sqrt_c = jnp.exp(log_scale)
    sc = sqrt_c[..., None] if block.units else sqrt_c

    L_old = chol_packed(h_old, p)
    mean_old = ex(value) + spd_solve(L_old, g_old, p)
    eps = jax.random.normal(k_eps, mean_old.shape, value.dtype)
    prop = sq(mean_old + sc * solve_upper_t(L_old, eps, p))

    if frozen:
        if cache is None:
            raise ValueError("frozen Newton-MH requires a carried cache")
        sv_new, sg_new, _ = self_vgh(prop, data)
        sh_new = sh  # constant metric; hessian math above is DCE'd
    else:
        sv_new, sg_new, sh_new = self_vgh(prop, data)
    sv_new = as_cu(sv_new, block)
    rv_new, rg_new, rh_new = rest_vgh(prop, position, data)
    d_new = sv_new + as_cu(rv_new, block)
    g_new = ex(sg_new + rg_new)
    h_new = ex(sh_new + rh_new)
    L_new = chol_packed(h_new, p)
    mean_new = ex(prop) + spd_solve(L_new, g_new, p)

    # log q(a | b) = -||L_b^T (a - mean_b)||^2 / (2 c)
    #               + half_logdet(L_b) - (p/2) log(2 pi c); the constant
    # cancels in the ratio (same c both directions).
    inv_c = jnp.exp(-2.0 * log_scale)                    # (C, U') or (C, 1)
    w_fwd = lt_vec(L_old, ex(prop) - mean_old, p)
    w_rev = lt_vec(L_new, ex(value) - mean_new, p)
    log_q_fwd = (
        -0.5 * inv_c * as_cu(jnp.sum(w_fwd * w_fwd, axis=-1), block)
        + as_cu(half_logdet(L_old, p), block)
    )
    log_q_rev = (
        -0.5 * inv_c * as_cu(jnp.sum(w_rev * w_rev, axis=-1), block)
        + as_cu(half_logdet(L_new, p), block)
    )
    log_alpha = d_new - d_old + log_q_rev - log_q_fwd

    logu = jnp.log(jax.random.uniform(
        k_u, log_alpha.shape, value.dtype, minval=jnp.finfo(value.dtype).tiny
    ))
    accept = logu < log_alpha
    new_value = select_accepted(accept, prop, value, block)
    new_cache = None
    if cache is not None:
        new_cache = {
            "v": jnp.where(accept, sv_new, cache["v"]),
            "g": select_accepted(accept, sg_new, cache["g"], block),
            # frozen: the metric is a constant — pass it through untouched
            # (no select, no HBM write)
            "h": cache["h"] if frozen
            else select_accepted(accept, sh_new, cache["h"], block),
        }
    return new_value, accept_prob(log_alpha), new_cache
