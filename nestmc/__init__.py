"""nestmc: batched MCMC for nested (hierarchical) data in JAX.

A ground-up re-design of the capability surface of the reference repo
``tkngch/MCMC-for-Nested-Data`` (hierarchical Bayesian models fitted by
Metropolis-Hastings-within-Gibbs to nested data: observations nested within
groups/subjects) for accelerators (NVIDIA GPUs):

- the per-chain sampling loop is a jit-compiled ``lax.scan``;
- chains are a batch axis (vmapped/batched), sharded over the device mesh;
- a Gibbs sweep over group-level parameters is ONE batched kernel over the
  ``chains x groups`` lattice (groups are conditionally independent given the
  population-level parameters), not a Python loop;
- the hot log-likelihood reductions over observations run as one fused
  GPU kernel (Pallas, Triton route) on a GPU and as the jnp reference
  elsewhere (nestmc/ops/dispatch.py);
- adaptation, acceptance bookkeeping and convergence diagnostics
  (split R-hat, FFT-based ESS) run on device with no host round-trips.

NOTE on provenance: the reference mount at /root/reference was empty when this
framework was built (see SURVEY.md section 0); the capability surface is built
to the driver spec in BASELINE.json and SURVEY.md.
"""

import jax as _jax

# Partitionable counter-based RNG: random draws inside the sharded scan are
# bitwise-identical regardless of the mesh layout, and generate locally per
# shard (no replicated-then-slice materialization).
_jax.config.update("jax_threefry_partitionable", True)

from nestmc.compare import compare, psis_loo, waic
from nestmc.config import KernelConfig, RunConfig, SamplerConfig, ShardingConfig
from nestmc.data import NestedData, NestedData3
from nestmc.engine import sample
from nestmc.model import Block, ModelSpec
from nestmc.posterior import Posterior
from nestmc.predictive import posterior_predictive, predictive_pvalue

__version__ = "0.1.0"

__all__ = [
    "Block",
    "KernelConfig",
    "compare",
    "psis_loo",
    "waic",
    "ModelSpec",
    "NestedData",
    "NestedData3",
    "Posterior",
    "RunConfig",
    "SamplerConfig",
    "ShardingConfig",
    "posterior_predictive",
    "predictive_pvalue",
    "sample",
    "__version__",
]
