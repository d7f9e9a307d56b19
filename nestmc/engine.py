"""Chain orchestration (L5): warmup + sampling as jit-compiled chunked scans.

Design (BASELINE.json:5): exactly two compiled hot programs — an adapting
warmup segment and a frozen sampling segment, each a ``lax.scan`` over
sweeps with the full KernelState as carry. The host sees data twice (initial
upload, final summaries); between draws there are zero host round-trips.
Segments (outer Python loop over scans) give natural checkpoint/log
boundaries and bound the draw-buffer memory.
"""

from __future__ import annotations

import time
from dataclasses import replace as dc_replace
from functools import partial

import jax
import jax.numpy as jnp

from nestmc.checkpoint import save_checkpoint
from nestmc.config import SamplerConfig
from nestmc.kernels.gibbs import make_sweep
from nestmc.kernels.state import KernelState, init_kernel_state
from nestmc.model import ModelSpec
from nestmc.parallel.sharding import make_mesh, shard_inputs
from nestmc.posterior import Posterior
from nestmc.utils.logging import get_logger

log = get_logger()


def _collector(model: ModelSpec, cfg: SamplerConfig):
    """position -> dict of draw slices to retain, per RunConfig.collect.

    Collectable names: block names and model.derived names. Derived
    quantities are computed on device inside the scan (no extra pass).
    """
    spec = cfg.run.collect

    def collect(position):
        if spec is None:
            out = dict(position)
            for name, fn in model.derived.items():
                out[name] = fn(position)
            return out
        out = {}
        for name, k in spec.items():
            if name in model.derived:
                v = model.derived[name](position)
            else:
                v = position[name]
            if k is None:
                out[name] = v
            elif isinstance(k, int):
                out[name] = v[:, :k]
            else:
                # explicit unit indices (tuple/list) — e.g. a seeded random
                # sample of groups for ESS-floor verification sweeps
                out[name] = v[:, jnp.asarray(k, dtype=jnp.int32)]
        return out

    return collect


def _segment_lengths(total: int, segment: int):
    segment = max(1, min(segment, total)) if total else 0
    out = []
    done = 0
    while done < total:
        out.append(min(segment, total - done))
        done += out[-1]
    return out


def build_step_fns(model: ModelSpec, cfg: SamplerConfig, data=None):
    """The two jitted segment programs (warmup, sampling)."""
    sweep = make_sweep(model, cfg)
    collect = _collector(model, cfg)
    thin = max(1, cfg.run.thin)
    donate = (0,) if cfg.sharding.donate_carry else ()

    @partial(jax.jit, static_argnames=("length",), donate_argnums=donate)
    def warmup_segment(carry: KernelState, data, length: int) -> KernelState:
        def body(c, _):
            return sweep(c, data, adapt=True), None

        return jax.lax.scan(body, carry, None, length=length)[0]

    def advance(c, data):
        if thin == 1:
            return sweep(c, data, adapt=False)
        return jax.lax.fori_loop(
            0, thin, lambda _, s: sweep(s, data, adapt=False), c
        )

    if not cfg.run.full_rhat:
        @partial(jax.jit, static_argnames=("length",), donate_argnums=donate)
        def sample_segment(carry: KernelState, data, length: int):
            def one_draw(c, _):
                c = advance(c, data)
                return c, collect(c.position)

            carry, draws = jax.lax.scan(one_draw, carry, None, length=length)
            # (draws, chains, ...) -> (chains, draws, ...)
            draws = jax.tree_util.tree_map(
                lambda a: jnp.swapaxes(a, 0, 1), draws
            )
            return carry, draws

        return warmup_segment, sample_segment

    # full_rhat variant: thread streaming split-R-hat Welford accumulators
    # (over the FULL position pytree) through the scan alongside the carry.
    # The large gradient-kernel blocks (gibbs.rhat_fold_names) use
    # kernel-layout accumulators updated INSIDE the sweep with the
    # pre-sweep value — i.e. retained draw j's fold happens at the start of
    # sweep j+1, where the block update reads the block anyway (the engine
    # flushes the final draw after the last segment). Everything else
    # stays on the post-sweep path.
    from nestmc.diagnostics import (
        fold_rhat_scalars,
        streaming_rhat_update,
    )
    from nestmc.kernels.gibbs import rhat_fold_names

    rthin = max(1, cfg.run.full_rhat_thin)
    half_len = (cfg.run.draws // rthin) // 2
    fold_names = rhat_fold_names(model, cfg)
    donate_full = (0, 1) if cfg.sharding.donate_carry else ()

    @partial(jax.jit, static_argnames=("length",),
             donate_argnums=donate_full)
    def sample_segment_rhat(carry: KernelState, acc, data, offset,
                            length: int):
        def one_draw(ca, i):
            c, sa, fa = ca
            j = offset + i
            if fold_names:
                # fold retained draw j-1 (nothing pending at j == 0, so
                # jm1t = -1 marks it skipped). fold_names is only
                # non-empty at full_rhat_thin == 1 (rhat_fold_names): a
                # cond-gated per-sweep fold would re-materialize the
                # accumulator buffers every sweep, so thinned runs stream
                # post-sweep.
                jm1t = jnp.where(j - 1 >= 0, j - 1, -1)
                scs = {
                    n: fold_rhat_scalars(fa[n][0], jm1t, half_len)
                    for n in fold_names
                }
                folds = {
                    n: (fa[n][1], fa[n][2], scs[n]) for n in fold_names
                }
                c, fout = sweep(c, data, adapt=False, rhat_fold=folds)
                if thin > 1:
                    c = jax.lax.fori_loop(
                        0, thin - 1,
                        lambda _, s: sweep(s, data, adapt=False), c,
                    )
                fa = {
                    n: (fa[n][0] + scs[n][:, 1], fout[n][0], fout[n][1])
                    for n in fold_names
                }
            else:
                c = advance(c, data)
            if rthin == 1:
                sa = streaming_rhat_update(sa, c.position, j, half_len)
            else:
                # thinned streaming: only every rthin-th retained draw
                # touches the accumulators (lax.cond skips the whole
                # read-modify-write pass on gated-off draws)
                sa = jax.lax.cond(
                    j % rthin == 0,
                    lambda a_: streaming_rhat_update(
                        a_, c.position, j // rthin, half_len
                    ),
                    lambda a_: a_,
                    sa,
                )
            return (c, sa, fa), collect(c.position)

        std_a, fold_a = acc
        (carry, std_a, fold_a), draws = jax.lax.scan(
            one_draw, (carry, std_a, fold_a), jnp.arange(length)
        )
        draws = jax.tree_util.tree_map(
            lambda a: jnp.swapaxes(a, 0, 1), draws
        )
        return carry, (std_a, fold_a), draws

    return warmup_segment, sample_segment_rhat


def _accept_rates(state: KernelState, sweeps: int):
    return {
        k: v / max(sweeps, 1) for k, v in state.accept_sum.items()
    }


def _reset_accept(state: KernelState) -> KernelState:
    zeros = {
        k: jnp.zeros_like(v) for k, v in state.accept_sum.items()
    }
    return dc_replace(state, accept_sum=zeros)


def _maybe_checkpoint(cfg: SamplerConfig, state, phase, seg_idx, extra=None):
    rc = cfg.run
    if not rc.checkpoint_dir or rc.checkpoint_every <= 0:
        return
    if (seg_idx + 1) % rc.checkpoint_every != 0:
        return
    meta = {"phase": phase, "segment": seg_idx + 1, "config": cfg.to_dict()}
    if extra:
        meta.update(extra)
    tag = f"{phase}_{seg_idx + 1:06d}"
    save_checkpoint(rc.checkpoint_dir, tag, state, meta)
    log.info("checkpoint saved: %s/%s", rc.checkpoint_dir, tag)


def sample(
    model: ModelSpec,
    data,
    cfg: SamplerConfig | None = None,
    key: jax.Array | None = None,
    init_position: dict | None = None,
    init_state: KernelState | None = None,
    skip_warmup: bool = False,
    init_acc=None,
    draws_offset: int = 0,
) -> Posterior:
    """Run the sampler end to end; returns a :class:`Posterior`.

    ``init_state`` (e.g. a loaded checkpoint carry) overrides fresh
    initialization; ``skip_warmup`` resumes directly in the sampling phase
    with whatever scales the carry holds. ``init_acc`` + ``draws_offset``
    resume a full_rhat run mid-schedule (VERDICT r4 item 7): the loaded
    streaming R-hat/ESS accumulators continue from retained draw
    ``draws_offset``, so a crashed gated run still certifies its all-param
    gate over the FULL schedule — ``cfg.run.draws`` stays the total
    budget and only the remainder is executed.
    """
    cfg = cfg or SamplerConfig()
    rc = cfg.run
    if key is None:
        key = jax.random.key(rc.seed)

    t_setup = time.perf_counter()
    mesh = make_mesh(cfg)
    if init_state is not None:
        state = init_state
    else:
        state = init_kernel_state(model, cfg, key, data, init_position)
    state, data = shard_inputs(state, data, model, cfg, mesh)
    warmup_segment, sample_segment = build_step_fns(model, cfg, data)
    timings = {"setup_s": time.perf_counter() - t_setup}

    # ---- warmup (adapting) ----
    warm_rates = {k: jnp.zeros_like(v) for k, v in state.accept_sum.items()}
    t_w = time.perf_counter()
    if not skip_warmup and rc.warmup > 0:
        t_c = time.perf_counter()
        warmup_segment.lower(
            state, data, length=min(rc.segment_size, rc.warmup)
        ).compile()
        timings["warmup_compile_s"] = time.perf_counter() - t_c
        t_w = time.perf_counter()
        for i, L in enumerate(_segment_lengths(rc.warmup, rc.segment_size)):
            with jax.profiler.TraceAnnotation(f"nestmc.warmup.seg{i}"):
                state = warmup_segment(state, data, length=L)
            jax.block_until_ready(state)
            if rc.log_every_segment:
                done = int(state.t)
                rate = done / max(time.perf_counter() - t_w, 1e-9)
                log.info("warmup: %d/%d sweeps (%.0f sweeps/s)",
                         done, rc.warmup, rate)
            _maybe_checkpoint(cfg, state, "warmup", i)
        warm_rates = _accept_rates(state, rc.warmup)
        state = _reset_accept(state)
    timings["warmup_s"] = time.perf_counter() - t_w

    # ---- sampling (adaptation frozen) ----
    if init_state is not None and skip_warmup:
        # a resumed sample-phase carry holds pre-crash accept accumulation
        # whose sweep-count denominator is lost; restart the bookkeeping so
        # reported rates stay in [0, 1].
        state = _reset_accept(state)
    acc = None
    fold_names = ()
    if rc.full_rhat and rc.draws > 0:
        if init_acc is not None:
            # resumed accumulators: continue the gate over the FULL
            # schedule (pre-crash draws already folded in)
            acc = init_acc
        else:
            from nestmc.diagnostics import (
                fold_rhat_init,
                streaming_rhat_init,
            )
            from nestmc.kernels.gibbs import rhat_fold_names

            fold_names = rhat_fold_names(model, cfg)
            # build inside jit from the sharded position so the
            # accumulators inherit the chain-axis sharding
            std_pos = {
                k: v for k, v in state.position.items()
                if k not in fold_names
            }
            acc = (
                jax.jit(streaming_rhat_init)(std_pos),
                jax.jit(partial(fold_rhat_init, names=fold_names))(
                    state.position
                ),
            )

    def _run_segment(state, acc, L, offset):
        if acc is None:
            state, seg_draws = sample_segment(state, data, length=L)
            return state, acc, seg_draws
        state, acc, seg_draws = sample_segment(
            state, acc, data, jnp.int32(offset), length=L
        )
        return state, acc, seg_draws

    remaining = max(rc.draws - draws_offset, 0)
    t_c = time.perf_counter()
    if remaining > 0:
        seg0 = min(rc.segment_size, remaining)
        if acc is None:
            sample_segment.lower(state, data, length=seg0).compile()
        else:
            sample_segment.lower(
                state, acc, data, jnp.int32(0), length=seg0
            ).compile()
    timings["sample_compile_s"] = time.perf_counter() - t_c

    segments = []
    t_s = time.perf_counter()
    drawn = draws_offset
    for i, L in enumerate(_segment_lengths(remaining, rc.segment_size)):
        with jax.profiler.TraceAnnotation(f"nestmc.sample.seg{i}"):
            state, acc, seg_draws = _run_segment(state, acc, L, drawn)
        segments.append(seg_draws)
        drawn += L
        jax.block_until_ready((state, acc))
        if rc.log_every_segment:
            rate = (drawn - draws_offset) * max(1, rc.thin) / max(
                time.perf_counter() - t_s, 1e-9
            )
            extra = ""
            if rc.log_rhat and drawn >= 8:
                from nestmc.diagnostics import split_rhat

                sofar = jax.tree_util.tree_map(
                    lambda *xs: jnp.concatenate(xs, axis=1), *segments
                )
                worst = jnp.max(jnp.stack([
                    jnp.max(split_rhat(v)) for v in
                    jax.tree_util.tree_leaves(sofar)
                ]))
                extra = f", worst split-rhat so far {float(worst):.4f}"
            log.info("sample: %d/%d draws (%.0f sweeps/s)%s",
                     drawn, rc.draws, rate, extra)
        # sample-phase checkpoints carry the streaming R-hat/ESS
        # accumulators alongside the kernel carry (VERDICT r4 item 7), so
        # a resumed gated run certifies its all-param gate over the FULL
        # schedule, not just its post-resume draws. (Retained draws are
        # still not checkpointed — only the remainder is re-collected.)
        ck = state if acc is None else {"state": state, "acc": acc}
        _maybe_checkpoint(
            cfg, ck, "sample", i + draws_offset // max(rc.segment_size, 1),
            {"draws_done": drawn, "has_acc": acc is not None},
        )
    if segments:
        draws = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=1), *segments
        )
        jax.block_until_ready(draws)
    else:
        draws = {}
    timings["sample_s"] = time.perf_counter() - t_s

    full_rhat_map = None
    full_ess_map = None
    if acc is not None:
        from nestmc.diagnostics import (
            fold_ess_finalize,
            fold_rhat_finalize,
            fold_rhat_scalars,
            fold_rhat_update,
            streaming_ess_finalize,
            streaming_rhat_finalize,
        )

        std_a, fold_a = acc
        if fold_a:
            # the in-sweep fold lags one draw: flush the final retained
            # draw (the current position) into the fold accumulators —
            # only if the thinning gate selects it
            rthin = max(1, rc.full_rhat_thin)
            half_len = (rc.draws // rthin) // 2
            last = rc.draws - 1
            last_t = last // rthin if last % rthin == 0 else -1

            @jax.jit
            def _flush(fa, position):
                out = {}
                for n, (count, mean, m2) in fa.items():
                    sc = fold_rhat_scalars(
                        count, jnp.int32(last_t), half_len
                    )
                    nm, nm2 = fold_rhat_update(
                        mean, m2, jnp.moveaxis(position[n], 0, -1), sc
                    )
                    out[n] = (count + sc[:, 1], nm, nm2)
                return out

            fold_a = _flush(fold_a, state.position)
        # one finalize program: the classic split R-hat gate AND the
        # cross-chain mean-functional ESS (+ chi^2 lower bound) over every
        # unit of every block, both read off the same accumulators
        # (VERDICT r4 item 5 — all-param min-ESS is measured, not
        # extrapolated from collected/sampled scalars)
        full_rhat_map, full_ess_map = jax.jit(
            lambda s, f: (
                {**streaming_rhat_finalize(s), **fold_rhat_finalize(f)},
                {**streaming_ess_finalize(s), **fold_ess_finalize(f)},
            )
        )(std_a, fold_a)

    total_sample_sweeps = remaining * max(1, rc.thin)
    post = Posterior(
        draws=draws,
        accept_rates=_accept_rates(state, total_sample_sweeps),
        warmup_accept_rates=warm_rates,
        config=cfg.to_dict(),
        timings=timings,
        full_rhat=full_rhat_map,
        full_ess=full_ess_map,
    )
    post.final_state = state  # expose the carry for resume/inspection
    return post


def warmup_then_state(model, data, cfg, key=None) -> KernelState:
    """Run only the warmup phase and return the adapted carry."""
    cfg2 = SamplerConfig(
        kernel=cfg.kernel,
        run=dc_replace(cfg.run, draws=0),
        sharding=cfg.sharding,
    )
    post = sample(model, data, cfg2, key)
    return post.final_state
