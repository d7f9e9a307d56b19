"""The one place that chooses the obs-pass implementation (ops/dispatch.py),
and the kernel's refusal to run off the GPU unless asked to interpret."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nestmc.ops import dispatch
from nestmc.ops.loglik_triton import fused_loglik


@pytest.mark.parametrize("backend,family,expected", [
    ("gpu", "logistic", "triton"),
    ("gpu", "poisson", "triton"),
    ("cpu", "logistic", "jnp"),
    ("cpu", "poisson", "jnp"),
    ("rocm", "logistic", "jnp"),
])
def test_platform_decides_auto(monkeypatch, backend, family, expected):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: backend)
    assert dispatch.loglik_impl(family) == expected


@pytest.mark.parametrize("requested", ["jnp", "triton"])
def test_explicit_request_stands(monkeypatch, requested):
    monkeypatch.setattr(dispatch.jax, "default_backend", lambda: "cpu")
    assert dispatch.loglik_impl("logistic", requested) == requested


def test_unknown_impl_and_family_rejected():
    with pytest.raises(ValueError):
        dispatch.loglik_impl("logistic", "pallas")
    with pytest.raises(ValueError):
        dispatch.padded_obs_pass("gamma", "jnp")


def _tiny():
    beta = jnp.zeros((4, 3, 2), jnp.float32)
    x = jnp.ones((3, 5, 2), jnp.float32)
    y = jnp.zeros((3, 5), jnp.float32)
    return beta, x, y, jnp.ones((3, 5), jnp.float32)


@pytest.mark.parametrize("outputs", ["v", "vg", "vgh"])
def test_kernel_off_gpu_without_interpret_raises(outputs):
    assert jax.default_backend() != "gpu"
    with pytest.raises(RuntimeError, match="GPU"):
        fused_loglik(*_tiny(), family="logistic", outputs=outputs)


def test_kernel_through_dispatch_off_gpu_raises():
    """Asking for the kernel explicitly never falls back to jnp."""
    v, _, _ = dispatch.padded_obs_pass("poisson", "triton")
    with pytest.raises(RuntimeError, match="interpret"):
        v(*_tiny())


@pytest.mark.parametrize("family", ["logistic", "poisson"])
def test_kernel_output_shapes(family):
    beta, x, y, mask = _tiny()
    v, g, h = fused_loglik(beta, x, y, mask, family=family, outputs="vgh",
                           interpret=True)
    assert v.shape == (4, 3) and g.shape == (4, 3, 2) and h.shape == (4, 3, 3)
    for a in (v, g, h):
        assert np.all(np.isfinite(np.asarray(a)))


def test_dense_flag_skips_the_mask():
    """dense=True never reads the mask: a mask of zeros gives the
    all-ones answer (callers pass dense only for an exactly-ones mask)."""
    beta, x, y, mask = _tiny()
    want = fused_loglik(beta, x, y, mask, family="logistic",
                        interpret=True)
    got = fused_loglik(beta, x, y, jnp.zeros_like(mask), family="logistic",
                       dense=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_models_report_the_choice():
    from nestmc.models import (
        make_hier_logistic,
        make_nested_poisson,
        synth_logistic,
        synth_poisson3,
    )

    d, _ = synth_logistic(jax.random.key(0), G=4, n=3, p=2)
    assert make_hier_logistic(d).loglik_impls["selected"] == "jnp"
    r, _ = synth_logistic(jax.random.key(0), G=4, n=3, p=2, ragged=True,
                          min_obs=1)
    assert make_hier_logistic(r).loglik_impls["selected"] == "jnp-segment"
    assert make_hier_logistic(r, loglik_impl="bucket").loglik_impls[
        "selected"] == "bucket"
    d3, _ = synth_poisson3(jax.random.key(0), G=2, subjects_per_group=2,
                           n=3, p=2)
    assert make_nested_poisson(d3).loglik_impls["selected"] == "jnp"
