"""The Pallas (Triton route) obs-pass kernel == the jnp reference paths.

The kernel (ops/loglik_triton.py) runs in the Pallas interpreter here; the
jnp references in ops/loglik.py are the contract. Shapes exercise tiles
that do not divide C or G, a single observation, one to eight covariates,
observation counts that are and are not multiples of the kernel's
eight-observation step, and dense and masked data.
The compiled kernel is held to the same contract on the card by
tests/test_gpu.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nestmc.ops.loglik import (
    logistic_loglik_padded,
    poisson_loglik_padded,
)
from nestmc.ops.loglik_triton import fused_loglik

RNG = np.random.default_rng(5)


def _case(C, G, n, p, binary=True, dense=False):
    beta = jnp.asarray(RNG.normal(size=(C, G, p)).astype(np.float32) * 0.5)
    x = jnp.asarray(RNG.normal(size=(G, n, p)).astype(np.float32))
    if dense:
        mask = np.ones((G, n), np.float32)
    else:
        mask = (RNG.uniform(size=(G, n)) > 0.25).astype(np.float32)
        mask[:, 0] = 1.0                  # at least one valid obs per group
    if binary:
        y = RNG.integers(0, 2, size=(G, n)).astype(np.float32)
    else:
        beta = 0.5 * beta                 # keep rates moderate
        y = RNG.poisson(2.0, size=(G, n)).astype(np.float32)
    return beta, x, jnp.asarray(y * mask), jnp.asarray(mask)


def _kernel(family, outputs, dense=False):
    return functools.partial(fused_loglik, family=family, outputs=outputs,
                             dense=dense, interpret=True)


SHAPES = [
    (8, 16, 12, 3),     # tidy tiles
    (8, 13, 7, 2),      # G not tile-divisible (exercises padding)
    (16, 5, 50, 4),     # few big groups
    (8, 32, 1, 1),      # single obs, single covariate
]


@pytest.mark.parametrize("C,G,n,p", SHAPES)
def test_logistic_parity(C, G, n, p):
    beta, x, y, mask = _case(C, G, n, p)
    ref = logistic_loglik_padded(beta, x, y, mask)
    ker = _kernel("logistic", "v")(beta, x, y, mask)
    np.testing.assert_allclose(
        np.asarray(ker), np.asarray(ref), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("C,G,n,p", SHAPES)
def test_poisson_parity(C, G, n, p):
    beta, x, y, mask = _case(C, G, n, p, binary=False)
    ref = poisson_loglik_padded(beta, x, y, mask)
    ker = _kernel("poisson", "v")(beta, x, y, mask)
    np.testing.assert_allclose(
        np.asarray(ker), np.asarray(ref), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("C,G,n,p", SHAPES[:2])
def test_logp_grad_parity(C, G, n, p):
    beta, x, y, mask = _case(C, G, n, p)

    def f(b):
        return logistic_loglik_padded(b, x, y, mask)

    ref_val, vjp = jax.vjp(f, beta)
    (ref_grad,) = vjp(jnp.ones_like(ref_val))
    val, grad = _kernel("logistic", "vg")(beta, x, y, mask)
    np.testing.assert_allclose(
        np.asarray(val), np.asarray(ref_val), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(ref_grad), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("C,G,n,p", SHAPES[:2])
def test_poisson_logp_grad_parity(C, G, n, p):
    beta, x, y, mask = _case(C, G, n, p, binary=False)

    def f(b):
        return poisson_loglik_padded(b, x, y, mask)

    ref_val, vjp = jax.vjp(f, beta)
    (ref_grad,) = vjp(jnp.ones_like(ref_val))
    val, grad = _kernel("poisson", "vg")(beta, x, y, mask)
    np.testing.assert_allclose(
        np.asarray(val), np.asarray(ref_val), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(ref_grad), rtol=1e-4, atol=1e-4
    )


# (C, G, n, p, dense): C and G off the kernel's tile (64 chains x 4
# groups), n = 1, n off and on the 8-observation step, p = 1, 3, 4, 8
GRID = [
    (5, 3, 1, 1, False),
    (33, 9, 7, 3, True),
    (20, 17, 50, 4, False),
    (12, 4, 300, 3, False),
    (8, 6, 10, 8, True),
    (40, 11, 13, 4, True),
]


def _reference(family, outputs, beta, x, y, mask):
    from nestmc.ops.dispatch import padded_obs_pass

    which = {"v": 0, "vg": 1, "vgh": 2}[outputs]
    return padded_obs_pass(family, "jnp")[which](beta, x, y, mask)


@pytest.mark.parametrize("shape", GRID, ids=lambda s: "C{}G{}n{}p{}{}".format(
    *s[:4], "d" if s[4] else "m"))
@pytest.mark.parametrize("outputs", ["v", "vg", "vgh"])
@pytest.mark.parametrize("family", ["logistic", "poisson"])
def test_kernel_grid_parity(family, outputs, shape):
    C, G, n, p, dense = shape
    beta, x, y, mask = _case(C, G, n, p, binary=family == "logistic",
                             dense=dense)
    got = _kernel(family, outputs, dense)(beta, x, y, mask)
    want = _reference(family, outputs, beta, x, y, mask)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == jnp.float32
        scale = max(1.0, float(jnp.max(jnp.abs(b))))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-5 * scale
        )


def test_pallas_inside_jit_and_model(monkeypatch):
    """The kernel path traces inside jit through the model (the kernel is
    pinned to interpret mode, as the model would run it on a GPU)."""
    from nestmc.models import make_hier_logistic, synth_logistic
    from nestmc.ops import loglik_triton

    monkeypatch.setattr(
        loglik_triton, "fused_loglik",
        functools.partial(loglik_triton.fused_loglik, interpret=True),
    )
    data, _ = synth_logistic(jax.random.key(0), G=16, n=8, p=2)
    model = make_hier_logistic(data, loglik_impl="triton")
    assert model.loglik_impls["selected"] == "triton"
    C = 8
    state = model.init_state(jax.random.key(1), data, C)
    out = jax.jit(
        lambda s: model.cond_logdensity("beta", s["beta"], s, data)
    )(state)
    ref_model = make_hier_logistic(data, loglik_impl="jnp")
    ref = ref_model.cond_logdensity("beta", state["beta"], state, data)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("outputs", ["v", "vg", "vgh"])
def test_kernel_runs_per_shard_on_a_mesh(outputs):
    """On a ('chains', 'groups') mesh every device runs the kernel on its
    own block: the result equals the one-device result, keeps the
    lattice's sharding, and the program gathers nothing."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 simulated devices")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("chains", "groups"))
    beta, x, y, mask = _case(8, 6, 7, 3)
    specs = (P("chains", "groups", None), P("groups", None, None),
             P("groups", None), P("groups", None))
    sharded = [jax.device_put(a, NamedSharding(mesh, s))
               for a, s in zip((beta, x, y, mask), specs)]
    fn = jax.jit(_kernel("logistic", outputs))
    got = fn(*sharded)
    want = fn(beta, x, y, mask)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.sharding.spec[:2] == ("chains", "groups")
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    hlo = fn.lower(*sharded).compile().as_text()
    assert "all-gather" not in hlo
