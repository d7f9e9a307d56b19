"""Parity contract for the ragged (segment) obs passes.

- jnp memory-lean logp+grad (ops/loglik.py::logistic_logp_grad_segment)
  vs jax.vjp of the reference segment path — exact formulation check,
  across ragged shapes with empty groups and non-divisible G.
- hier_logistic's ragged implementations agree at the model level.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nestmc.ops.loglik import (
    logistic_logp_grad_segment,
    logistic_loglik_segment,
)


def _ragged(key, C, G, p, max_n, min_n=0, empty_every=None):
    kx, kb, ky, kn = jax.random.split(key, 4)
    sizes = np.array(jax.random.randint(kn, (G,), min_n, max_n + 1))
    if empty_every:
        sizes[::empty_every] = 0
    N = int(sizes.sum())
    seg = np.repeat(np.arange(G, dtype=np.int32), sizes)
    x = jax.random.normal(kx, (N, p), jnp.float32)
    y = jax.random.bernoulli(ky, 0.5, (N,)).astype(jnp.float32)
    beta = 0.7 * jax.random.normal(kb, (C, G, p), jnp.float32)
    return beta, x, y, jnp.asarray(seg)


CASES = [
    # (C, G, p, max_n, min_n, empty_every, TG, TN)
    (8, 37, 3, 12, 0, 5, 8, 16),      # empty groups, G % TG != 0
    (16, 64, 4, 9, 1, None, 16, 32),  # exact tiling
    (8, 5, 2, 40, 10, None, 8, 16),   # multi-chunk tiles, G < 2*TG
    (8, 20, 3, 3, 0, 2, 4, 8),        # half the groups empty
]


@pytest.mark.parametrize("case", CASES)
def test_jnp_lean_grad_matches_vjp(case):
    C, G, p, max_n, min_n, empty_every, _, _ = case
    beta, x, y, seg = _ragged(jax.random.key(1), C, G, p, max_n,
                              min_n, empty_every)
    ll, g = logistic_logp_grad_segment(beta, x, y, seg, G)
    ref = logistic_loglik_segment(beta, x, y, seg, G)
    out, vjp = jax.vjp(
        lambda b: logistic_loglik_segment(b, x, y, seg, G), beta
    )
    (gref,) = vjp(jnp.ones_like(out))
    np.testing.assert_allclose(np.asarray(ll), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(gref),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("impl", ["bucket"])
def test_hier_logistic_ragged_model_wiring(impl):
    """Model-level contract: hier_logistic built with each ragged impl
    produces the same carried likelihood and fused value+grad as the
    jnp-segment reference (this is the exact pair of closures MALA/RW-MH
    consume via cond_cached / cond_cached_grad)."""
    from nestmc.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(jax.random.key(7), G=37, n=9, p=3,
                             ragged=True, min_obs=0)
    ref = make_hier_logistic(data, loglik_impl="jnp")
    got = make_hier_logistic(data, loglik_impl=impl)
    assert got.loglik_impls["selected"] == impl

    beta = 0.5 * jax.random.normal(jax.random.key(8), (4, 37, 3))
    ll_ref = ref.cond_cached["beta"][0](beta, data)
    ll_got = got.cond_cached["beta"][0](beta, data)
    np.testing.assert_allclose(np.asarray(ll_got), np.asarray(ll_ref),
                               rtol=2e-5, atol=2e-5)

    v_ref, g_ref = ref.cond_cached_grad["beta"][0](beta, data)
    v_got, g_got = got.cond_cached_grad["beta"][0](beta, data)
    np.testing.assert_allclose(np.asarray(v_got), np.asarray(v_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_ref),
                               rtol=2e-4, atol=2e-5)
