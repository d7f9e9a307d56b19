"""Diagnostics vs float64 numpy goldens + analytic sanity anchors."""

import numpy as np

import jax.numpy as jnp

from nestmc.diagnostics import (
    ess,
    ess_bulk,
    ess_tail,
    mcse_mean,
    rhat,
    split_rhat,
)
from reference_diagnostics import np_ess, np_split_rhat

RNG = np.random.default_rng(7)


def ar1(phi, C=4, D=2000, scale=1.0):
    x = np.zeros((C, D))
    innov = RNG.normal(size=(C, D)) * scale
    for t in range(1, D):
        x[:, t] = phi * x[:, t - 1] + innov[:, t] * np.sqrt(1 - phi**2)
    return x.astype(np.float32)


def test_rhat_identical_chains_near_one():
    one = RNG.normal(size=(1, 1000)).astype(np.float32)
    x = np.repeat(one, 6, axis=0)
    r = float(split_rhat(x))
    assert abs(r - 1.0) < 0.01


def test_rhat_shifted_chains_large():
    x = RNG.normal(size=(4, 500)).astype(np.float32)
    x[0] += 10.0
    assert float(split_rhat(x)) > 2.0
    assert float(rhat(x)) > 1.5  # rank-normalized also flags it


def test_rhat_matches_numpy_golden():
    x = ar1(0.5, C=6, D=800)[..., None] * np.array([1.0, 2.0], np.float32)
    ours = np.asarray(split_rhat(x))
    golden = np_split_rhat(x)
    np.testing.assert_allclose(ours, golden, rtol=1e-4, atol=1e-5)


def test_ess_matches_numpy_golden():
    for phi in (0.0, 0.3, 0.8):
        x = ar1(phi, C=4, D=600)
        ours = float(ess(x))
        golden = float(np_ess(x))
        np.testing.assert_allclose(ours, golden, rtol=2e-3)


def test_ess_iid_near_total():
    x = RNG.normal(size=(4, 2000)).astype(np.float32)
    total = 4 * 2000
    assert 0.6 * total < float(ess(x)) <= total
    assert 0.6 * total < float(ess_bulk(x)) <= total


def test_ess_ar1_analytic():
    # AR(1): tau = (1+phi)/(1-phi); ESS ~= M*D / tau
    phi = 0.7
    x = ar1(phi, C=8, D=5000)
    expected = 8 * 5000 * (1 - phi) / (1 + phi)
    got = float(ess(x))
    assert 0.7 * expected < got < 1.4 * expected


def test_ess_tail_iid_near_total():
    # Regression for the round-1 advisor finding: positional tie-breaking in
    # rank normalization turned the 0/1 tail indicator into a near-perfectly
    # autocorrelated sequence (ess_tail 5.3 on this input instead of ~7886).
    x = RNG.normal(size=(4, 2000)).astype(np.float32)
    et = float(ess_tail(x))
    assert et > 0.5 * 4 * 2000, et


def test_ess_tail_matches_numpy_golden():
    from reference_diagnostics import np_ess_tail

    x = ar1(0.6, C=4, D=800)
    ours = float(ess_tail(x))
    golden = float(np_ess_tail(x))
    np.testing.assert_allclose(ours, golden, rtol=0.02)


def test_rank_normalize_matches_scipy():
    from nestmc.diagnostics import _rank_normalize
    from reference_diagnostics import np_rank_normalize

    # continuous draws and a heavily tied integer-valued array
    for x in (
        RNG.normal(size=(4, 300, 3)).astype(np.float32),
        RNG.integers(0, 4, size=(4, 300, 3)).astype(np.float32),
    ):
        ours = np.asarray(_rank_normalize(jnp.asarray(x)))
        golden = np_rank_normalize(x)
        np.testing.assert_allclose(ours, golden, rtol=1e-4, atol=1e-5)


def test_rank_normalize_binary_is_affine():
    # With average-rank ties, rank-normalizing a binary chain maps it to
    # exactly two values, so its ESS equals the raw indicator's ESS.
    from nestmc.diagnostics import _rank_normalize, ess

    x = (RNG.normal(size=(4, 1000)) < -1.6).astype(np.float32)
    z = np.asarray(_rank_normalize(jnp.asarray(x)))
    assert len(np.unique(z)) == 2
    np.testing.assert_allclose(float(ess(z)), float(ess(x)), rtol=1e-3)


def test_ess_tail_and_mcse_finite():
    x = ar1(0.5, C=4, D=1000)
    et = float(ess_tail(x))
    assert 0 < et <= 4 * 1000
    m = float(mcse_mean(x))
    # MCSE ~ sd/sqrt(ess); sd=1 here
    assert 0.005 < m < 0.2


def test_diagnostics_multiparam_shapes():
    x = RNG.normal(size=(4, 300, 5, 2)).astype(np.float32)
    assert split_rhat(x).shape == (5, 2)
    assert ess(x).shape == (5, 2)
    assert ess_bulk(jnp.asarray(x)).shape == (5, 2)


# ---- hand-computed constants (independent of reference_diagnostics.py) ----
#
# The numpy golden mirrors nestmc's conventions, so it cannot catch a
# convention error both share. These cases were derived BY HAND from the
# published formulas (Vehtari et al. 2021; BDA3), with every intermediate
# written out, and pin literal constants.


def test_split_rhat_hand_case_trending():
    """chains [[0,1,2,3],[1,2,3,4]] -> split seqs [0,1],[2,3],[1,2],[3,4].
    Means .5,2.5,1.5,3.5; each seq var (ddof=1) = 0.5 -> W = 1/2.
    var(means, ddof=1) = 5/3 -> B = N*5/3 = 10/3 (N=2).
    var+ = (N-1)/N * W + B/N = 1/4 + 5/3 = 23/12.
    R-hat = sqrt((23/12)/(1/2)) = sqrt(23/6) = 1.9578900."""
    from nestmc.diagnostics import split_rhat

    x = jnp.asarray([[0.0, 1.0, 2.0, 3.0], [1.0, 2.0, 3.0, 4.0]])
    np.testing.assert_allclose(
        float(split_rhat(x)), np.sqrt(23.0 / 6.0), rtol=1e-6
    )


def test_split_rhat_hand_case_mirrored():
    """chains [[1,2,3,4],[4,3,2,1]] -> seqs [1,2],[3,4],[4,3],[2,1].
    Means 1.5,3.5,3.5,1.5; W = 1/2; var(means, ddof=1) = 4/3 -> B = 8/3;
    var+ = 1/4 + 4/3 = 19/12; R-hat = sqrt(19/6) = 1.7795130."""
    from nestmc.diagnostics import split_rhat

    x = jnp.asarray([[1.0, 2.0, 3.0, 4.0], [4.0, 3.0, 2.0, 1.0]])
    np.testing.assert_allclose(
        float(split_rhat(x)), np.sqrt(19.0 / 6.0), rtol=1e-6
    )


def test_rank_normalize_hand_case_average_ties():
    """pooled values 1,2,2,3 (n=4): average ranks 1, 2.5, 2.5, 4; the
    Blom-offset transform z = ndtri((r - 3/8)/(n + 1/4)) gives literal
    fractions 0.625/4.25, 2.125/4.25 (= 1/2 -> z = 0), 3.625/4.25."""
    from scipy.stats import norm

    from nestmc.diagnostics import _rank_normalize

    x = jnp.asarray([[1.0, 2.0], [2.0, 3.0]])
    z = np.asarray(_rank_normalize(x))
    expect = np.array([
        [norm.ppf(0.625 / 4.25), 0.0],
        [0.0, norm.ppf(3.625 / 4.25)],
    ])
    np.testing.assert_allclose(z, expect, atol=1e-5)


def test_ess_hand_case_geyer_pairing_and_floor():
    """chains [[0,0,1,1],[1,1,0,0]], split=False (M=2, N=4).

    Per chain (centered +-1/2): biased autocovs c = [1/4, 1/16, -1/8,
    -1/16]; W = mean(c0 * N/(N-1)) = 1/3; B = 0 (equal chain means);
    var+ = 3/4 * 1/3 = 1/4. rho_t = 1 - (W - c_t)/var+ =
    [2/3, -1/12, -11/6, -7/12]. Geyer pairs: P0 = 7/12 > 0 kept,
    P1 = -29/12 masked. tau = -1 + 2*(7/12) = 1/6, floored at
    1/log10(8); ESS = 8*log10(8) = 7.2247199."""
    from nestmc.diagnostics import ess

    x = jnp.asarray([[0.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0]])
    np.testing.assert_allclose(
        float(ess(x, split=False)), 8.0 * np.log10(8.0), rtol=1e-5
    )


def test_diagnose_chunked_matches_direct():
    """diagnose_chunked must produce identical values to diagnose while
    bounding per-call FFT memory (forced tiny budget -> many chunks)."""
    import jax

    from nestmc.diagnostics import diagnose, diagnose_chunked

    x = jax.random.normal(jax.random.key(3), (4, 64, 5, 3))
    y = jax.random.normal(jax.random.key(4), (4, 64))
    direct = diagnose({"a": x, "b": y})
    chunked = diagnose_chunked({"a": x, "b": y}, budget_bytes=1)
    for name in direct:
        for k in direct[name]:
            np.testing.assert_allclose(
                np.asarray(chunked[name][k]), np.asarray(direct[name][k]),
                rtol=2e-5, atol=2e-5,
            )
            assert chunked[name][k].shape == direct[name][k].shape


def test_rank_offset_stays_inside_unit_interval_at_huge_n():
    """Regression: at n > ~1.2e7 pooled draws the Blom offset for the top
    rank rounds to exactly 1.0 in f32 and ndtri(1.0)=inf poisoned every
    diagnostic with NaN (observed at 3072 chains x 4096 draws)."""
    from jax.scipy.special import ndtri

    from nestmc.diagnostics import _rank_to_u

    for n in (2**23, 2**24, 2**26, 2**30):
        u = _rank_to_u(jnp.asarray([1.0, float(n)], jnp.float32), n)
        z = ndtri(u)
        assert float(u[1]) < 1.0 and float(u[0]) > 0.0, (n, u)
        assert np.all(np.isfinite(np.asarray(z))), (n, z)
