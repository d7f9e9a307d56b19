"""The MH-within-Gibbs sweep — the hot loop body.

One sweep updates every block in declaration order. Grouped blocks update all
their conditionally-independent units simultaneously (valid because the
conditional factorizes per unit given the rest of the state); population
blocks then update given the fresh group-level values. The block loop
unrolls at trace time; `adapt` is a Python bool giving two separate compiled
programs (adapting warmup step, frozen sampling step).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nestmc.adapt import adapt_log_scale, precond_std, update_precond
from nestmc.config import MALA_TARGET_ACCEPT, SamplerConfig, rw_target_accept
from nestmc.kernels.mala import mala_update
from nestmc.kernels.newton import newton_update
from nestmc.kernels.rwmh import rwmh_update
from nestmc.kernels.state import KernelState
from nestmc.model import ModelSpec

_UPDATES = {"rwmh": rwmh_update, "mala": mala_update, "newton": newton_update}


def grad_cache_live(model: ModelSpec, cfg: SamplerConfig) -> bool:
    """True when some cond_cached_grad/newton block runs a gradient kernel,
    so the carried cache holds {'v','g',...} and gradient-aware joint moves
    (Langevin ASIS) engage."""
    return any(
        (
            (b.algorithm or cfg.kernel.algorithm) == "mala"
            and b.name in model.cond_cached_grad
        ) or (
            (b.algorithm or cfg.kernel.algorithm) == "newton"
            and b.name in model.cond_cached_newton
        )
        for b in model.blocks
        if b.name not in model.gibbs_draws
    )


def newton_cache_live(model: ModelSpec, cfg: SamplerConfig) -> bool:
    """True when some cond_cached_newton block runs Newton-MH, so the
    carried cache also holds the packed likelihood Hessian and joint moves
    can upgrade to Laplace (Newton-ASIS) proposals."""
    return any(
        (b.algorithm or cfg.kernel.algorithm) == "newton"
        and b.name in model.cond_cached_newton
        for b in model.blocks
        if b.name not in model.gibbs_draws
    )


def joint_move_target(model: ModelSpec, mname: str,
                      cfg: SamplerConfig) -> "float | None":
    """Acceptance target for the move's scale adaptation; None = the move
    is parameter-free (Newton-ASIS Laplace proposal) and must not adapt."""
    t = model.joint_move_target_accept.get(mname, 0.234)
    if t is None:
        return None  # model pins the move as parameter-free (Laplace)
    if t == "auto":
        if newton_cache_live(model, cfg):
            return None
        t = MALA_TARGET_ACCEPT if grad_cache_live(model, cfg) else 0.234
    return float(t)


def rhat_fold_names(model: ModelSpec, cfg: SamplerConfig) -> tuple:
    """Blocks whose streaming-R-hat Welford update is folded INSIDE the
    sweep (with the block's pre-update value, i.e. the previous retained
    draw) instead of in a separate pass after it: the non-Gibbs blocks
    that run a gradient kernel (MALA, or Newton-MH through the model's
    analytic hooks) off a carried likelihood cache — the large group
    blocks of the built-in models.

    Only at ``full_rhat_thin == 1``: with thinning the fold would have to
    be cond-gated per sweep, which re-materializes the O(params x chains)
    accumulators on every sweep, while the post-sweep path gates them once
    per thinned draw."""
    if cfg.run.full_rhat_thin > 1:
        return ()
    out = []
    for b in model.blocks:
        if b.name in model.gibbs_draws:
            continue
        algorithm = b.algorithm or cfg.kernel.algorithm
        if algorithm == "newton" and b.name not in model.cond_cached_newton:
            algorithm = "mala"
        if (
            (algorithm == "mala" and b.name in model.cond_cached_grad)
            or (algorithm == "newton" and b.name in model.cond_cached_newton)
        ):
            out.append(b.name)
    return tuple(out)


def block_target_accept(block, algorithm: str, cfg: SamplerConfig) -> float:
    if block.target_accept is not None:
        return block.target_accept
    if cfg.kernel.target_accept is not None:
        return cfg.kernel.target_accept
    if algorithm == "mala":
        return MALA_TARGET_ACCEPT
    return rw_target_accept(block.unit_dim)


def make_sweep(model: ModelSpec, cfg: SamplerConfig):
    """Build sweep(state, data, adapt: bool) -> state.

    ``data`` is a traced argument (not a closure constant) so the engine can
    pass it through the jit boundary with its mesh sharding attached.
    """

    import inspect

    # joint moves that understand the frozen-Hessian sampling phase take a
    # `frozen` kwarg (models define it with a False default, so direct
    # test callers are unaffected); detected once at build time.
    _move_takes_frozen = {
        mname: "frozen" in inspect.signature(move).parameters
        for mname, move in model.joint_moves.items()
    }

    def sweep(state: KernelState, data, adapt: bool, rhat_fold=None):
        """rhat_fold: optional {block: (mean, m2, scalars)} kernel-layout
        streaming-R-hat accumulators (diagnostics.fold_rhat_*) to fold
        with each block's PRE-update value (= the previous retained
        draw); when given the return becomes (state, {block: (mean',
        m2')})."""
        fold_out = {}
        return_state = _sweep(state, data, adapt, rhat_fold or {}, fold_out)
        if rhat_fold is None:
            return return_state
        return return_state, fold_out

    def _sweep(state: KernelState, data, adapt: bool, rhat_fold,
               fold_out) -> KernelState:
        # Frozen-metric Newton (KernelConfig.newton_freeze): the sampling
        # program (adapt=False) treats the carried likelihood Hessian as a
        # CONSTANT metric — obs passes compute only (value, grad), the
        # Laplace proposal keeps its curvature. A Python bool: the warmup
        # and sampling programs are separate traces already.
        frozen = (not adapt) and cfg.kernel.newton_freeze
        key, key_sweep = jax.random.split(state.key)
        position = dict(state.position)
        log_scale = dict(state.log_scale)
        precond = dict(state.precond)
        accept_sum = dict(state.accept_sum)
        cache = dict(state.cache)
        t = state.t

        for i, block in enumerate(model.blocks):
            name = block.name
            kb = jax.random.fold_in(key_sweep, i)

            if name in model.gibbs_draws:
                # exact conditional draw: no proposal, acceptance = 1
                position[name] = model.gibbs_draws[name](kb, position, data)
                accept_sum[name] = accept_sum[name] + 1.0
                continue

            algorithm = block.algorithm or cfg.kernel.algorithm
            if (
                algorithm == "newton"
                and name not in model.cond_cached_newton
            ):
                # Newton-MH needs the model's analytic value+grad+Hessian
                # hooks (no autodiff fallback — kernels/newton.py); blocks
                # without them under a global algorithm='newton' fall back
                # to MALA (generic vjp gradient), e.g. a half-normal
                # log_tau MH block in an otherwise-Newton model.
                algorithm = "mala"
            pstd = precond_std(precond[name], cfg.kernel)
            update = _UPDATES[algorithm]

            fold_args = rhat_fold.get(name)
            if fold_args is not None:
                from nestmc.diagnostics import fold_rhat_update

                fold_out[name] = fold_rhat_update(
                    fold_args[0], fold_args[1],
                    jnp.moveaxis(position[name], 0, -1), fold_args[2],
                )
            alphas = []
            for r in range(max(1, block.repeats)):
                kr = jax.random.fold_in(kb, r)
                kw = (
                    {"frozen": frozen} if algorithm == "newton" else {}
                )
                new_value, alpha, new_cache = update(
                    kr, block, model, position,
                    log_scale[name], pstd, data, cache=cache.get(name),
                    **kw,
                )
                position[name] = new_value
                cache[name] = new_cache
                alphas.append(alpha)
            alpha = sum(alphas) / len(alphas)
            accept_sum[name] = accept_sum[name] + alpha

            if adapt and algorithm != "newton":
                # Newton-MH is NOT scale-adapted: its proposal covariance is
                # the conditional's own inverse Hessian (c = 1); acceptance
                # is non-monotone in c so rate-targeting is ill-posed
                # (kernels/newton.py docstring).
                target = block_target_accept(block, algorithm, cfg)
                # Scale adaptation sees the per-scale-unit acceptance: mean
                # over units when scales are shared across units.
                a = alpha
                if a.shape[1] != log_scale[name].shape[1]:
                    a = jnp.mean(a, axis=1, keepdims=True)
                log_scale[name] = adapt_log_scale(
                    log_scale[name], a, t, target, cfg.kernel
                )
                precond[name] = update_precond(
                    precond[name], new_value, cfg.kernel
                )

        for j, (mname, move) in enumerate(model.joint_moves.items()):
            km = jax.random.fold_in(key_sweep, 1000 + j)
            alphas_m = []
            for r in range(max(1, model.joint_move_repeats.get(mname, 1))):
                pos_up, cache_up, alpha = move(
                    jax.random.fold_in(km, r), position, cache,
                    jnp.exp(log_scale[mname]), data,
                    **({"frozen": frozen}
                       if _move_takes_frozen[mname] else {}),
                )
                position.update(pos_up)
                cache.update(cache_up)
                alphas_m.append(alpha[:, None])  # (C, 1)
            alpha = sum(alphas_m) / len(alphas_m)
            accept_sum[mname] = accept_sum[mname] + alpha
            if adapt:
                target = joint_move_target(model, mname, cfg)
                if target is not None:
                    log_scale[mname] = adapt_log_scale(
                        log_scale[mname], alpha, t, target, cfg.kernel,
                    )

        return KernelState(
            position=position,
            log_scale=log_scale,
            precond=precond,
            accept_sum=accept_sum,
            cache=cache,
            t=t + 1,
            key=key,
        )

    return sweep
