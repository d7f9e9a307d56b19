"""Engine edge cases: segmentation, collection, derived subsets, phases."""

import numpy as np
import pytest

import jax

from nestmc import RunConfig, SamplerConfig, sample
from nestmc.engine import _segment_lengths
from nestmc.models import make_eight_schools


def test_segment_lengths():
    assert _segment_lengths(10, 4) == [4, 4, 2]
    assert _segment_lengths(4, 10) == [4]
    assert _segment_lengths(0, 10) == []
    assert _segment_lengths(5, 1) == [1] * 5


@pytest.fixture(scope="module")
def es():
    return make_eight_schools()


def test_collect_derived_subset(es):
    """Derived quantities (theta = mu + tau z) collectable with unit subset."""
    model, data = es
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=20, draws=30, log_every_segment=False,
        collect={"mu": None, "theta": 3},
    ))
    post = sample(model, data, cfg)
    assert post.draws["theta"].shape == (4, 30, 3)
    assert post.draws["mu"].shape == (4, 30)
    assert np.all(np.isfinite(np.asarray(post.draws["theta"])))


def test_collect_explicit_indices(es):
    """Tuple collect spec retains exactly those unit indices, in order."""
    model, data = es
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=20, draws=30, log_every_segment=False, seed=3,
        collect={"mu": None, "z": (5, 1, 6)},
    ))
    post = sample(model, data, cfg)
    assert post.draws["z"].shape == (4, 30, 3)
    # same run collecting everything: the indexed slices must match
    cfg_all = SamplerConfig(run=RunConfig(
        chains=4, warmup=20, draws=30, log_every_segment=False, seed=3,
        collect={"mu": None, "z": None},
    ))
    post_all = sample(model, data, cfg_all)
    np.testing.assert_array_equal(
        np.asarray(post.draws["z"]),
        np.asarray(post_all.draws["z"][:, :, [5, 1, 6]]),
    )


def test_default_collect_includes_derived(es):
    model, data = es
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=10, draws=10, log_every_segment=False,
    ))
    post = sample(model, data, cfg)
    assert set(post.draws) == {"z", "mu", "log_tau", "theta"}


def test_uneven_segments_match_single_segment(es):
    """Draws must not depend on segmentation (same seeds, same scans)."""
    model, data = es

    def run(seg):
        cfg = SamplerConfig(run=RunConfig(
            chains=4, warmup=24, draws=30, seed=3, segment_size=seg,
            log_every_segment=False, collect={"mu": None},
        ))
        return sample(model, data, cfg)

    a, b = run(30), run(7)
    np.testing.assert_array_equal(
        np.asarray(a.draws["mu"]), np.asarray(b.draws["mu"])
    )


def test_warmup_rates_separate_from_sampling(es):
    model, data = es
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=50, draws=50, log_every_segment=False,
    ))
    post = sample(model, data, cfg)
    for k in post.accept_rates:
        w = np.asarray(post.warmup_accept_rates[k])
        s = np.asarray(post.accept_rates[k])
        assert np.all(w >= 0) and np.all(w <= 1.0 + 1e-6)
        assert np.all(s >= 0) and np.all(s <= 1.0 + 1e-6)


def test_full_rhat_matches_split_rhat_of_retained_draws(es):
    """Streamed Welford split R-hat == split_rhat of the full draw arrays,
    for every sampled block, including across multiple uneven segments and
    an odd draw count (the leftover draw is dropped by both conventions)."""
    from nestmc.diagnostics import split_rhat

    model, data = es
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=30, draws=31, segment_size=7, seed=5,
        log_every_segment=False, full_rhat=True,
    ))
    post = sample(model, data, cfg)
    assert post.full_rhat is not None
    assert set(post.full_rhat) == {"z", "mu", "log_tau"}
    for name, streamed in post.full_rhat.items():
        direct = split_rhat(post.draws[name])
        np.testing.assert_allclose(
            np.asarray(streamed), np.asarray(direct), rtol=2e-4, atol=2e-4
        )
    # worst_rhat() must cover the streamed blocks
    worst_direct = max(
        float(np.max(np.asarray(split_rhat(post.draws[n]))))
        for n in post.full_rhat
    )
    assert post.worst_rhat() >= worst_direct - 1e-4


def test_full_rhat_thinned_matches_split_rhat_of_thinned_draws(es):
    """full_rhat_thin=k streams split R-hat of exactly the draws at
    retained indices 0, k, 2k, ... — verified against split_rhat applied
    to that subsequence, across uneven segments and a draw count not
    divisible by k."""
    from nestmc.diagnostics import split_rhat

    model, data = es
    k = 3
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=30, draws=50, segment_size=13, seed=5,
        log_every_segment=False, full_rhat=True, full_rhat_thin=k,
    ))
    post = sample(model, data, cfg)
    assert post.full_rhat is not None
    for name, streamed in post.full_rhat.items():
        direct = split_rhat(post.draws[name][:, ::k])
        np.testing.assert_allclose(
            np.asarray(streamed), np.asarray(direct), rtol=2e-4, atol=2e-4
        )


def test_full_rhat_uncollected_block(es):
    """full_rhat covers blocks excluded from collection entirely."""
    model, data = es
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=20, draws=24, seed=1, log_every_segment=False,
        full_rhat=True, collect={"mu": None},
    ))
    post = sample(model, data, cfg)
    assert "z" in post.full_rhat and "z" not in post.draws
    assert np.all(np.isfinite(np.asarray(post.full_rhat["z"])))


@pytest.mark.parametrize("algorithm,rthin", [
    ("mala", 1), ("newton", 1), ("mala", 3), ("newton", 4),
])
def test_full_rhat_fold_path_matches_split_rhat(algorithm, rthin):
    """The in-sweep fold path (kernel-layout accumulators updated one draw
    late + final flush) must produce EXACTLY the split R-hat of the
    retained draws. hier_logistic's beta runs a gradient kernel off a
    carried cache, so gibbs.rhat_fold_names engages the path. At
    full_rhat_thin > 1 the fold is DISABLED (rhat_fold_names returns ():
    a cond-gated per-sweep fold would re-materialize the accumulators
    every sweep) and the streamed statistic must still match split R-hat
    of the thinned retained draws via the post-sweep path."""
    import jax

    from nestmc import SamplerConfig as SC
    from nestmc.config import KernelConfig
    from nestmc.diagnostics import split_rhat
    from nestmc.kernels.gibbs import rhat_fold_names
    from nestmc.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(jax.random.key(3), G=12, n=8, p=2)
    model = make_hier_logistic(data, tau_prior="invgamma")
    cfg = SC(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(
            chains=4, warmup=20, draws=50, segment_size=17, seed=9,
            log_every_segment=False, full_rhat=True,
            full_rhat_thin=rthin,
            collect={"beta": None, "mu": None, "log_tau": None},
        ),
    )
    expected_fold = ("beta",) if rthin == 1 else ()
    assert rhat_fold_names(model, cfg) == expected_fold
    post = sample(model, data, cfg)
    assert set(post.full_rhat) == {"beta", "mu", "log_tau"}
    for name, streamed in post.full_rhat.items():
        direct = split_rhat(post.draws[name][:, ::rthin])
        np.testing.assert_allclose(
            np.asarray(streamed), np.asarray(direct), rtol=2e-4, atol=2e-4
        )


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["mala", "newton"])
def test_full_rhat_fold_on_gpu_matches_split_rhat(algorithm):
    """On the GPU the obs pass runs the Triton kernel and the fold runs
    inside the compiled sweep; the finalized full-R-hat must still equal
    split_rhat of the retained draws."""
    from nestmc import SamplerConfig as SC
    from nestmc.config import KernelConfig
    from nestmc.diagnostics import split_rhat
    from nestmc.models import make_hier_logistic, synth_logistic

    data, _ = synth_logistic(jax.random.key(3), G=16, n=8, p=2)
    model = make_hier_logistic(data, tau_prior="invgamma")
    assert model.loglik_impls["selected"] == "triton"
    cfg = SC(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(
            chains=8, warmup=30, draws=64, segment_size=40, seed=9,
            log_every_segment=False, full_rhat=True,
            collect={"beta": None, "mu": None, "log_tau": None},
        ),
    )
    post = sample(model, data, cfg)
    for name, streamed in post.full_rhat.items():
        direct = split_rhat(post.draws[name])
        np.testing.assert_allclose(
            np.asarray(streamed), np.asarray(direct), rtol=2e-4, atol=2e-4
        )


@pytest.mark.parametrize("case", [
    ("nested_poisson", "mala", 1, ("beta_s",)),
    ("nested_poisson", "rwmh", 1, ()),
    ("nested_poisson", "newton", 2, ()),
    ("eight_schools", "mala", 1, ()),
])
def test_rhat_fold_names_follow_the_gradient_blocks(case):
    """The in-sweep fold covers the non-Gibbs blocks that run a gradient
    kernel off a carried cache, at full_rhat_thin == 1 only."""
    from nestmc import SamplerConfig as SC
    from nestmc.config import KernelConfig
    from nestmc.kernels.gibbs import rhat_fold_names
    from nestmc.models import make_nested_poisson, synth_poisson3

    name, algorithm, rthin, expected = case
    if name == "nested_poisson":
        data, _ = synth_poisson3(jax.random.key(0), G=3,
                                 subjects_per_group=2, n=4, p=2)
        model = make_nested_poisson(data, tau_prior="invgamma")
    else:
        model, _ = make_eight_schools()
    cfg = SC(
        kernel=KernelConfig(algorithm=algorithm),
        run=RunConfig(full_rhat=True, full_rhat_thin=rthin),
    )
    assert rhat_fold_names(model, cfg) == expected


def test_log_rhat_flag_runs(es, caplog):
    model, data = es
    cfg = SamplerConfig(run=RunConfig(
        chains=4, warmup=10, draws=20, segment_size=10,
        log_every_segment=True, log_rhat=True, collect={"mu": None},
    ))
    import logging

    logger = logging.getLogger("nestmc")
    logger.propagate = True  # nestmc logger doesn't propagate by default
    try:
        with caplog.at_level(logging.INFO, logger="nestmc"):
            sample(model, data, cfg)
    finally:
        logger.propagate = False
    assert any("worst split-rhat" in r.message for r in caplog.records)
