"""Sampler kernels (L4): batched MH updates + the Gibbs sweep.

Everything here is shape-static and jit-traceable; the block loop inside a
sweep unrolls at trace time (2-5 blocks). The unit axis of a grouped block is
updated for ALL units and ALL chains in one batched accept/reject — the
batched replacement for the reference's per-group loop.
"""

from nestmc.kernels.gibbs import make_sweep
from nestmc.kernels.mala import mala_update
from nestmc.kernels.rwmh import rwmh_update
from nestmc.kernels.state import KernelState, init_kernel_state

__all__ = [
    "KernelState",
    "init_kernel_state",
    "make_sweep",
    "mala_update",
    "rwmh_update",
]
