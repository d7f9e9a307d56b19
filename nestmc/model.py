"""Model abstraction (L3): parameter blocks + conditional log-densities.

A model is a set of **blocks** (the Gibbs partition of the parameter vector)
plus a dispatcher that evaluates, for any block, the part of the joint
log-density that depends on that block ("conditional log-density up to a
constant").

The central design decision: a block with ``units = U > 0`` declares that
its leading axis indexes U *conditionally independent* units (groups,
subjects) given the rest of the state. Its conditional log-density returns a
``(chains, U)`` array and the MH accept/reject is made **per unit, for all
units and all chains in one batched kernel** — this is what turns the
reference's per-group Python loop into a single ``chains x groups`` lattice
update (BASELINE.json:5).

Batching convention: every state leaf carries a leading ``chains`` axis.
Built-in models are written chain-batched natively so the hot likelihood
runs as one pass over the (chains, groups, obs) lattice; custom models
written unbatched can be lifted with :func:`vmap_chains`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import jax
import jax.numpy as jnp

State = dict  # name -> (chains, *shape) array
Data = Any


@dataclass(frozen=True)
class Block:
    """One Gibbs block.

    Attributes:
      name:   state-dict key.
      shape:  per-chain shape. If ``units > 0``, ``shape[0] == units`` and the
              remaining dims are the per-unit parameter shape.
      units:  number of conditionally-independent units updated in parallel
              (0 = the block is accepted/rejected as one joint proposal).
      init_scale: initial random-walk proposal stddev (unconstrained space).
      target_accept: MH acceptance target for adaptation; None = pick the
              standard optimum from the per-unit dimension (0.44 for d=1,
              0.234 otherwise; 0.574 for MALA) at kernel-build time.
      algorithm: per-block override of KernelConfig.algorithm
              ('rwmh' | 'mala' | None = use the config's).
      repeats: MH updates of this block per Gibbs sweep. Useful for cheap
              blocks (sufficient-stat hyperparameters) whose random-walk
              autocorrelation would otherwise dominate: k repeats cut the
              within-conditional autocorrelation ~k-fold at negligible cost.
    """

    name: str
    shape: tuple
    units: int = 0
    init_scale: float = 1.0
    target_accept: float | None = None
    algorithm: str | None = None
    repeats: int = 1

    @property
    def unit_shape(self) -> tuple:
        return self.shape[1:] if self.units else self.shape

    @property
    def unit_dim(self) -> int:
        d = 1
        for s in self.unit_shape:
            d *= int(s)
        return d


@dataclass(frozen=True)
class ModelSpec:
    """Declarative model: blocks + batched conditional log-densities.

    Attributes:
      name: model identifier.
      blocks: Gibbs update order.
      cond_logdensity(block_name, value, state, data) -> (C, units) or (C,):
        all terms of the joint log-density that involve ``block_name``,
        evaluated at ``value`` (others read from ``state``), aggregated per
        unit of that block. Must include Jacobian terms of any transforms.
        ``block_name`` is static (the block loop is unrolled at trace time).
      joint_logdensity(state, data) -> (C,): the full joint (up to a
        constant) — used by diagnostics, tests, and joint-update kernels.
      init_state(key, data, chains) -> State: initial chain-batched state
        (typically overdispersed around a crude fit).
      prior_sample(key, data, chains) -> State: exact draw from the prior
        (for Geweke / SBC calibration); optional.
      sample_data(key, state, data) -> Data: simulate responses given
        parameters of chain 0 (for Geweke / SBC); optional.
      cond_value_and_grad(block_name, value, state, data) -> ((C,U), value-
        shaped grad): optional fused log-density+gradient for MALA;
        when absent the MALA kernel differentiates cond_logdensity with
        ``jax.vjp``.
      loglik_impls: {"selected": name} of the obs-pass implementation the
        model chose at construction (ops/dispatch.py), for provenance.
      derived: {name: fn(position) -> (C, ...)} deterministic quantities
        computed from the state at draw-collection time (e.g. the centered
        theta = mu + tau * z of a non-centered parameterization). Collectable
        by name like any block.
      joint_moves: {move_name: fn(key, position, cache, scale, data) ->
        (position_updates: dict, cache_updates: dict, alpha: (C,))} extra
        MH moves run at the end of every sweep that may change SEVERAL
        blocks jointly — e.g. an ASIS/interweaving move that rescales
        (tau, beta) together in the non-centered parameterization, breaking
        the hyperparameter-group coupling that limits centered Gibbs mixing.
        ``scale`` is a per-chain (C, 1) proposal scale adapted to 0.234 like
        a block scale; ``cache_updates`` lets the move refresh carried
        likelihood caches it invalidates (set a key to None to drop one).
      gibbs_draws: {block_name: fn(key, state, data) -> new_value} EXACT
        conditional samplers (conjugate draws). A block listed here is
        updated by a direct draw from its full conditional instead of an MH
        step — acceptance is 1 and no proposal-scale state is used. The
        model author is responsible for the draw targeting the exact
        conditional (validated by the Geweke/SBC/exactness test tiers).
      cond_cached: {block_name: (self_fn, rest_fn)} optional split of that
        block's conditional into a SELF-CONTAINED part
        ``self_fn(value, data) -> (C, U)`` that depends on no other block
        (typically the data likelihood) and the remainder
        ``rest_fn(value, state, data) -> (C, U)``. The RW-MH kernel then
        carries the self part of the CURRENT value across sweeps — other
        blocks can never invalidate it — halving hot likelihood evaluations
        per sweep (one per proposal instead of proposal+current).
    """

    name: str
    blocks: tuple
    cond_logdensity: Callable
    joint_logdensity: Callable
    init_state: Callable
    prior_sample: Callable | None = None
    sample_data: Callable | None = None
    cond_value_and_grad: Callable | None = None
    loglik_impls: dict = dataclasses.field(default_factory=dict)
    derived: dict = dataclasses.field(default_factory=dict)
    cond_cached: dict = dataclasses.field(default_factory=dict)
    gibbs_draws: dict = dataclasses.field(default_factory=dict)
    joint_moves: dict = dataclasses.field(default_factory=dict)
    # {move_name: k}: run the move k times per sweep (worth it for cheap
    # likelihood-free moves, e.g. group-level interweaving via suff stats)
    joint_move_repeats: dict = dataclasses.field(default_factory=dict)
    # {move_name: s0}: initial proposal scale for the move (default 0.1).
    # Matters when the move's optimal scale shrinks with model size: e.g.
    # an interweaving move whose log-alpha sums over all G groups needs
    # s ~ G^(-1/2); Robbins-Monro takes O(100) sweeps per decade of scale
    # error, so a size-aware start is what makes short warmups viable.
    joint_move_init_scale: dict = dataclasses.field(default_factory=dict)
    # {move_name: s0}: initial proposal scale used INSTEAD of
    # joint_move_init_scale when the gradient cache is live (the move then
    # runs metric-preconditioned, so its natural scale is O(1) — not the
    # G-dependent unpreconditioned random-walk scale).
    joint_move_init_scale_grad: dict = dataclasses.field(
        default_factory=dict
    )
    # {move_name: target}: acceptance target for the move's scale
    # adaptation. A float is used as-is (default 0.234, the RW optimum);
    # the string 'auto' resolves at kernel-build time to the MALA optimum
    # (0.574) when the move runs as a Langevin proposal — i.e. when some
    # cond_cached_grad block runs MALA so the carried gradient cache the
    # move keys its drift off is live — and 0.234 otherwise.
    joint_move_target_accept: dict = dataclasses.field(default_factory=dict)
    # Newton-MH analog of cond_cached_grad: {block_name: (self_vgh,
    # rest_vgh)} where self_vgh(value, data) -> ((C,U) logp, value-shaped
    # grad, (C,U,T) packed negative Hessian, T = p(p+1)/2 in the
    # ops/smallchol layout) depends on no other block, and
    # rest_vgh(value, state, data) -> same for the remainder (for a
    # Gaussian prior the Hessian part is the packed precision diagonal,
    # broadcastable over units). Required for blocks running the 'newton'
    # algorithm — there is no autodiff fallback (a generic jax.hessian of
    # the obs pass would materialize an (C,U,p,p)-per-obs intermediate).
    cond_cached_newton: dict = dataclasses.field(default_factory=dict)
    # MALA analog of cond_cached: {block_name: (self_vag, rest_vag)} where
    # self_vag(value, data) -> ((C,U) logp, value-shaped grad) depends on no
    # other block (the data likelihood), rest_vag(value, state, data) ->
    # same for the remainder. The MALA kernel carries the self part of the
    # current value across sweeps — one likelihood+grad evaluation per
    # update instead of two.
    cond_cached_grad: dict = dataclasses.field(default_factory=dict)

    def block(self, name: str) -> Block:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(name)

    def with_loglik_impl(self, **impls) -> "ModelSpec":
        return dataclasses.replace(
            self, loglik_impls={**self.loglik_impls, **impls}
        )


def vmap_chains(spec: ModelSpec) -> ModelSpec:
    """Lift a ModelSpec written for UNBATCHED state (no chain axis) to the
    chain-batched convention via ``jax.vmap``.

    Convenience for user models; built-ins are natively batched (faster hot
    path: the chain axis reaches the obs-pass kernels explicitly).
    """

    def cond(name, value, state, data):
        return jax.vmap(
            lambda v, s: spec.cond_logdensity(name, v, s, data)
        )(value, state)

    def joint(state, data):
        return jax.vmap(lambda s: spec.joint_logdensity(s, data))(state)

    def init_state(key, data, chains):
        keys = jax.random.split(key, chains)
        return jax.vmap(lambda k: spec.init_state(k, data, 0))(keys)

    prior = None
    if spec.prior_sample is not None:
        def prior(key, data, chains):
            keys = jax.random.split(key, chains)
            return jax.vmap(lambda k: spec.prior_sample(k, data, 0))(keys)

    return dataclasses.replace(
        spec,
        cond_logdensity=cond,
        joint_logdensity=joint,
        init_state=init_state,
        prior_sample=prior,
    )


def state_dtype(state: State):
    return jnp.result_type(*jax.tree_util.tree_leaves(state))
