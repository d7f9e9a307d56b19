"""jnp reference implementations of the batched likelihood reductions.

The GPU kernel of :mod:`nestmc.ops.loglik_triton` computes the padded
functions here in one pass and must agree with them to float tolerance
(tests/test_pallas_parity.py, chip_smoke.py); the implementation a model
runs is chosen by :mod:`nestmc.ops.dispatch`.

Shapes:
  beta: (C, G, p) per-chain per-group coefficients
  x:    (G, n, p) padded covariates       y, mask: (G, n)
  returns (C, G) per-chain per-group log-likelihood.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import nn
from jax.scipy.special import gammaln


def _eta_padded(beta, x):
    # (C,G,p) x (G,n,p) -> (C,G,n). precision=HIGHEST: on a GPU a float32
    # contraction without it may run in TF32 (10-bit mantissa, ~1e-3
    # relative error); the reference path must be true float32, as the
    # GPU kernel's multiply-adds are.
    return jnp.einsum(
        "cgp,gnp->cgn", beta, x,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def logistic_loglik_padded(beta, x, y, mask):
    """sum_i mask * [y*eta - softplus(eta)] -> (C, G)."""
    eta = _eta_padded(beta, x)
    ll = y * eta - nn.softplus(eta)
    return jnp.sum(ll * mask, axis=-1)


def poisson_loglik_padded(beta, x, y, mask, lgamma_y=None):
    """sum_i mask * [y*eta - exp(eta) - lgamma(y+1)] -> (C, G).

    ``lgamma_y``: optional precomputed (G, n) lgamma(y+1) table (constant
    across the run — precompute once instead of per sweep).
    """
    eta = _eta_padded(beta, x)
    if lgamma_y is None:
        lgamma_y = gammaln(y + 1.0)
    ll = y * eta - jnp.exp(eta) - lgamma_y
    return jnp.sum(ll * mask, axis=-1)


def normal_loglik_padded(beta, x, y, mask, sigma):
    """Gaussian response: sum_i mask * log N(y | eta, sigma) -> (C, G).

    ``sigma``: scalar, (G,), (G, n), or chain-batched (C, 1)/(C, G) —
    broadcast against (C, G, n).
    """
    eta = _eta_padded(beta, x)
    sig = jnp.asarray(sigma)
    while sig.ndim < 3:
        sig = sig[..., None]
    z = (y - eta) / sig
    ll = -0.5 * (z * z) - jnp.log(sig) - 0.9189385332046727
    return jnp.sum(ll * mask, axis=-1)


def _eta_segment(beta, x, segment_ids):
    # beta (C,G,p), x (N,p) -> (C,N): gather each obs's group coefficients.
    beta_obs = jnp.take(beta, segment_ids, axis=1)  # (C, N, p)
    return jnp.einsum(
        "cnp,np->cn", beta_obs, x,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def _segsum_cn(ll, segment_ids, num_groups):
    # (C, N) -> (C, G) segment reduction over obs.
    return jax.ops.segment_sum(
        ll.T, segment_ids, num_segments=num_groups,
        indices_are_sorted=True,
    ).T


def logistic_loglik_segment(beta, x, y, segment_ids, num_groups):
    """Ragged form: flat obs arrays + segment ids -> (C, G)."""
    eta = _eta_segment(beta, x, segment_ids)
    ll = y * eta - nn.softplus(eta)
    return _segsum_cn(ll, segment_ids, num_groups)


def poisson_loglik_segment(beta, x, y, segment_ids, num_groups, lgamma_y=None):
    eta = _eta_segment(beta, x, segment_ids)
    if lgamma_y is None:
        lgamma_y = gammaln(y + 1.0)
    ll = y * eta - jnp.exp(eta) - lgamma_y
    return _segsum_cn(ll, segment_ids, num_groups)


def _eta_segment_lean(beta, x, segment_ids):
    """eta (C, N) via p separate (C, N) gathers — never materializes the
    (C, N, p) per-obs coefficient tensor (2.1 GB at C=1024, N=175k; the
    jax.vjp of the _eta_segment form needs ~3 of those at once)."""
    p = beta.shape[-1]
    eta = jnp.take(beta[:, :, 0], segment_ids, axis=1) * x[:, 0]
    for k in range(1, p):
        eta = eta + jnp.take(beta[:, :, k], segment_ids, axis=1) * x[:, k]
    return eta


def _xxt_packed(x, w):
    """Packed lower triangle of sum_i w_i x_i x_i^T over the obs axis.

    x: (G, n, p), w: (C, G, n) -> (C, G, p(p+1)/2), packing order of
    :mod:`nestmc.ops.smallchol` (row-major lower triangle). Unrolled over
    the static p so XLA keeps everything in one fused elementwise+reduce
    pass — no (C, G, n, p, p) intermediate.
    """
    p = x.shape[-1]
    cols = []
    for i in range(p):
        for j in range(i + 1):
            cols.append(jnp.sum(w * (x[..., i] * x[..., j]), axis=-1))
    return jnp.stack(cols, axis=-1)


def logistic_logp_grad_hess_padded(beta, x, y, mask):
    """Fused (loglik, grad, packed negative Hessian) of the Bernoulli-logit
    likelihood wrt beta — the obs pass of the Newton-MH kernel
    (kernels/newton.py).

    Returns ((C, G) loglik, (C, G, p) grad, (C, G, T) packed -H_lik) with
    T = p(p+1)/2 (smallchol layout). The likelihood's negative Hessian is
    sum_i m_i w_i x_i x_i^T, w = sigmoid(eta)(1 - sigmoid(eta)) — computed
    from the SAME sigmoid as the gradient, so the Hessian costs p(p+1)/2
    extra multiply-accumulates per obs and zero extra transcendentals.
    """
    eta = _eta_padded(beta, x)
    s = nn.sigmoid(eta)
    ll = jnp.sum((y * eta - nn.softplus(eta)) * mask, axis=-1)
    resid = (y - s) * mask                               # (C, G, n)
    g = jnp.einsum(
        "cgn,gnp->cgp", resid, x,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    w = s * (1.0 - s) * mask
    return ll, g, _xxt_packed(x, w)


def poisson_logp_grad_hess_padded(beta, x, y, mask, lgamma_y=None):
    """Poisson analog of :func:`logistic_logp_grad_hess_padded`:
    w = exp(eta), grad = sum_i m_i (y_i - exp(eta_i)) x_i."""
    eta = _eta_padded(beta, x)
    rate = jnp.exp(eta)
    if lgamma_y is None:
        lgamma_y = gammaln(y + 1.0)
    ll = jnp.sum((y * eta - rate - lgamma_y) * mask, axis=-1)
    resid = (y - rate) * mask
    g = jnp.einsum(
        "cgn,gnp->cgp", resid, x,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return ll, g, _xxt_packed(x, rate * mask)


def logistic_logp_grad_hess_segment(beta, x, y, segment_ids, num_groups):
    """Ragged (segment) form of :func:`logistic_logp_grad_hess_padded` with
    O(C N) peak memory (per-coordinate gathers/reductions, like
    :func:`logistic_logp_grad_segment`)."""
    eta = _eta_segment_lean(beta, x, segment_ids)        # (C, N)
    s = nn.sigmoid(eta)
    ll = y * eta - nn.softplus(eta)
    out = _segsum_cn(ll, segment_ids, num_groups)
    resid = y - s                                        # (C, N)
    p = beta.shape[-1]
    grads = [
        _segsum_cn(resid * x[:, k], segment_ids, num_groups)
        for k in range(p)
    ]
    w = s * (1.0 - s)
    hcols = [
        _segsum_cn(w * (x[:, i] * x[:, j]), segment_ids, num_groups)
        for i in range(p) for j in range(i + 1)
    ]
    return out, jnp.stack(grads, axis=-1), jnp.stack(hcols, axis=-1)


def logistic_logp_grad_segment(beta, x, y, segment_ids, num_groups):
    """Fused value+grad of the ragged Bernoulli-logit log-likelihood.

    Returns ((C, G) loglik, (C, G, p) grad wrt beta). Same math as
    ``jax.vjp`` of :func:`logistic_loglik_segment` but with O(C N) peak
    memory instead of O(C N p): per-coordinate gathers for eta and
    per-coordinate segment reductions for the grad.
    """
    eta = _eta_segment_lean(beta, x, segment_ids)        # (C, N)
    ll = y * eta - nn.softplus(eta)
    out = _segsum_cn(ll, segment_ids, num_groups)        # (C, G)
    resid = y - nn.sigmoid(eta)                          # (C, N)
    grads = [
        _segsum_cn(resid * x[:, k], segment_ids, num_groups)
        for k in range(beta.shape[-1])
    ]
    return out, jnp.stack(grads, axis=-1)                # (C, G, p)
