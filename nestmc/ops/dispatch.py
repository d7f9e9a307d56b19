"""The one place that chooses how the obs-pass likelihood runs.

Models ask :func:`loglik_impl` once, at construction, and get the three
obs-pass functions of their likelihood family from :func:`padded_obs_pass`.
The choice follows the platform JAX runs on: the fused Triton kernel
(:mod:`nestmc.ops.loglik_triton`) on a GPU, the jnp reference
(:mod:`nestmc.ops.loglik`) anywhere else. An explicit request stands as
given: asking for the kernel off the GPU fails when it is called, it does
not fall back.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from nestmc.ops import loglik as _ref

IMPLS = ("jnp", "triton")
# likelihood families with a GPU kernel that beat the jnp path end to end
KERNEL_FAMILIES = frozenset({"logistic", "poisson"})


def loglik_impl(family: str, requested: str = "auto") -> str:
    """'triton' or 'jnp' for ``family``; 'auto' decides by platform."""
    if requested == "auto":
        on_gpu = jax.default_backend() == "gpu"
        return "triton" if on_gpu and family in KERNEL_FAMILIES else "jnp"
    if requested not in IMPLS:
        raise ValueError(
            f"unknown loglik impl {requested!r}; one of {('auto',) + IMPLS}"
        )
    if requested == "triton" and family not in KERNEL_FAMILIES:
        raise ValueError(f"no GPU kernel for the {family!r} likelihood")
    return requested


def padded_obs_pass(family: str, impl: str, dense: bool = False):
    """(value, value_grad, value_grad_hess) over padded data, each
    ``f(beta, x, y, mask, lgamma_y=None)``; the Poisson functions read the
    optional lgamma(y + 1) table, the logistic ones ignore it.

    ``dense``: the mask is exactly 1 everywhere (the kernel then never
    reads it)."""
    if impl == "triton":
        from nestmc.ops.loglik_triton import fused_loglik

        def make(outputs):
            kern = functools.partial(
                fused_loglik, family=family, outputs=outputs, dense=dense
            )

            def f(beta, x, y, mask, lgamma_y=None):
                return kern(beta, x, y, mask, lgamma_y)
            return f

        return make("v"), make("vg"), make("vgh")

    if family == "logistic":
        def v(beta, x, y, mask, lgamma_y=None):
            return _ref.logistic_loglik_padded(beta, x, y, mask)

        def vgh(beta, x, y, mask, lgamma_y=None):
            return _ref.logistic_logp_grad_hess_padded(beta, x, y, mask)
    elif family == "poisson":
        def v(beta, x, y, mask, lgamma_y=None):
            return _ref.poisson_loglik_padded(beta, x, y, mask, lgamma_y)

        def vgh(beta, x, y, mask, lgamma_y=None):
            return _ref.poisson_logp_grad_hess_padded(
                beta, x, y, mask, lgamma_y
            )
    else:
        raise ValueError(f"unknown family {family!r}")

    def vg(beta, x, y, mask, lgamma_y=None):
        out, pull = jax.vjp(lambda b: v(b, x, y, mask, lgamma_y), beta)
        return out, pull(jnp.ones_like(out))[0]

    return v, vg, vgh
