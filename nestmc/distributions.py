"""Numerically stable log-density functions (L1 math layer).

Pure ``jnp`` functions, dtype-polymorphic, broadcasting over arbitrary batch
shapes. These are the scalar building blocks for model log-densities; the hot
likelihood reductions over observations live in :mod:`nestmc.ops` (jnp
reference paths and the fused GPU kernel).

Capability parity: the reference implements log-pdfs for the distributions its
hierarchical models need (normal likelihoods/priors, Bernoulli and Poisson
GLM links, gamma-family scale priors). Reference file citations are
unavailable (empty reference mount, SURVEY.md section 0); requirements from
BASELINE.json:7-11 configs.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import nn
from jax.scipy.special import gammaln

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)
_LOG_PI = math.log(math.pi)


def logpdf_normal(x, loc=0.0, scale=1.0):
    """log N(x | loc, scale); stable for any broadcastable shapes."""
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - jnp.log(scale)


def logpdf_normal_prec(x, loc, prec):
    """log N(x | loc, 1/sqrt(prec)) parameterized by precision."""
    d = x - loc
    return 0.5 * (jnp.log(prec) - _LOG_2PI - prec * d * d)


def logpdf_halfnormal(x, scale=1.0):
    """log HalfNormal(x | scale) for x >= 0 (support not checked)."""
    z = x / scale
    return -0.5 * (z * z + _LOG_2PI) + _LOG_2 - jnp.log(scale)


def logpdf_halfcauchy(x, scale=1.0):
    """log HalfCauchy(x | scale) for x >= 0 (support not checked)."""
    z = x / scale
    return _LOG_2 - _LOG_PI - jnp.log(scale) - jnp.log1p(z * z)


def logpdf_cauchy(x, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    return -_LOG_PI - jnp.log(scale) - jnp.log1p(z * z)


def logpdf_student_t(x, df, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    half = 0.5 * (df + 1.0)
    return (
        gammaln(half)
        - gammaln(0.5 * df)
        - 0.5 * jnp.log(df)
        - 0.5 * _LOG_PI
        - jnp.log(scale)
        - half * jnp.log1p(z * z / df)
    )


def logpmf_bernoulli_logit(y, eta):
    """log Bernoulli(y | sigmoid(eta)) in the stable softplus form.

    ``y*eta - softplus(eta)`` == ``y*log(p) + (1-y)*log(1-p)``; never
    materializes probabilities, safe for |eta| up to overflow of exp.
    """
    return y * eta - nn.softplus(eta)


def logpmf_poisson_log(y, eta):
    """log Poisson(y | rate=exp(eta)): y*eta - exp(eta) - lgamma(y+1)."""
    return y * eta - jnp.exp(eta) - gammaln(y + 1.0)


def logpmf_binomial_logit(y, n, eta):
    """log Binomial(y | n, sigmoid(eta)) with the log-binomial coefficient."""
    coef = gammaln(n + 1.0) - gammaln(y + 1.0) - gammaln(n - y + 1.0)
    return coef + y * eta - n * nn.softplus(eta)


def logpdf_gamma(x, shape, rate):
    """log Gamma(x | shape, rate), rate parameterization."""
    return (
        shape * jnp.log(rate)
        - gammaln(shape)
        + (shape - 1.0) * jnp.log(x)
        - rate * x
    )


def logpdf_invgamma(x, shape, scale):
    """log InvGamma(x | shape, scale)."""
    return (
        shape * jnp.log(scale)
        - gammaln(shape)
        - (shape + 1.0) * jnp.log(x)
        - scale / x
    )


def logpdf_exponential(x, rate=1.0):
    return jnp.log(rate) - rate * x


def logpdf_lognormal(x, loc=0.0, scale=1.0):
    lx = jnp.log(x)
    z = (lx - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - jnp.log(scale) - lx


def logpdf_beta(x, a, b):
    return (
        gammaln(a + b)
        - gammaln(a)
        - gammaln(b)
        + (a - 1.0) * jnp.log(x)
        + (b - 1.0) * jnp.log1p(-x)
    )


def log_scale_guard(log_scale, bound: float = 12.0):
    """Support guard for log-scale parameters: 0 inside |x| < bound,
    -inf outside (proposals beyond get rejected).

    Why: in hierarchical models a group-level vector can underflow to
    EXACTLY its mean in f32 (e.g. after an accepted interweaving rescale),
    making the quadratic sufficient statistic 0 — the tau conditional is
    then unbounded below and the chain diverges to log tau = -inf (NaNs
    downstream). Bounding log tau to +/-12 (scales in [6e-6, 1.6e5])
    truncates the prior immeasurably while keeping every exp(+/-2 log tau)
    finite in f32. Add this term to any log-scale block's conditional.
    """
    return jnp.where(
        jnp.abs(log_scale) < bound,
        jnp.zeros_like(log_scale),
        -jnp.inf,
    )


def logpdf_uniform(x, low=0.0, high=1.0):
    inside = (x >= low) & (x <= high)
    return jnp.where(inside, -jnp.log(high - low), -jnp.inf)


def logpdf_mvn_diag(x, loc, scale_diag, axis=-1):
    """log MVN with diagonal covariance; reduces over ``axis``."""
    z = (x - loc) / scale_diag
    return jnp.sum(
        -0.5 * (z * z + _LOG_2PI) - jnp.log(scale_diag), axis=axis
    )


def logpdf_mvn_chol(x, loc, chol):
    """log MVN(x | loc, L L^T) given lower-triangular Cholesky factor ``chol``.

    ``x``/``loc`` broadcast over leading batch axes with trailing dim d;
    ``chol`` is (..., d, d) broadcastable against them.
    """
    d = x.shape[-1]
    diff = x - loc
    # Solve L z = diff batched: broadcast chol against diff's batch dims.
    import jax.scipy.linalg as jsl

    rhs = diff[..., None]
    chol_b = jnp.broadcast_to(chol, rhs.shape[:-2] + chol.shape[-2:])
    z = jsl.solve_triangular(chol_b, rhs, lower=True)[..., 0]
    logdet = jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * (jnp.sum(z * z, axis=-1) + d * _LOG_2PI) - logdet
