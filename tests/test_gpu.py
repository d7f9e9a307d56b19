"""The compiled obs-pass kernel on the card (skipped elsewhere; run by
`python chip_smoke.py`): the same contract as tests/test_pallas_parity.py,
without the interpreter, and the models pick it by themselves."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_pallas_parity import GRID, _case, _reference

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("shape", GRID, ids=lambda s: "C{}G{}n{}p{}{}".format(
    *s[:4], "d" if s[4] else "m"))
@pytest.mark.parametrize("outputs", ["v", "vg", "vgh"])
@pytest.mark.parametrize("family", ["logistic", "poisson"])
def test_compiled_kernel_parity(family, outputs, shape):
    from nestmc.ops.loglik_triton import fused_loglik

    C, G, n, p, dense = shape
    beta, x, y, mask = _case(C, G, n, p, binary=family == "logistic",
                             dense=dense)
    kern = jax.jit(functools.partial(
        fused_loglik, family=family, outputs=outputs, dense=dense))
    got = kern(beta, x, y, mask)
    want = jax.jit(functools.partial(_reference, family, outputs))(
        beta, x, y, mask)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        scale = max(1.0, float(jnp.max(jnp.abs(b))))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-5 * scale
        )


def test_models_pick_the_kernel_on_the_gpu():
    from nestmc.models import (
        make_hier_logistic,
        make_nested_poisson,
        synth_logistic,
        synth_poisson3,
    )

    data, _ = synth_logistic(jax.random.key(0), G=8, n=5, p=2)
    assert make_hier_logistic(data).loglik_impls["selected"] == "triton"
    data3, _ = synth_poisson3(jax.random.key(0), G=4, subjects_per_group=2,
                              n=3, p=2)
    assert make_nested_poisson(data3).loglik_impls["selected"] == "triton"
