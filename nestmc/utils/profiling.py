"""Profiling helpers (SURVEY.md section 5.1).

- ``trace(dir)``: context manager over jax.profiler (TensorBoard/Perfetto
  trace) — the CLI exposes it as ``--profile DIR``.
- ``sweep_cost(model, data, cfg)``: XLA's own cost model for one compiled
  sweep (FLOPs, bytes accessed) + a memory-bound speed-of-light estimate
  where the device's peak bandwidth is known (utils/device.py PEAKS).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(directory: str):
    jax.profiler.start_trace(directory)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a region in the profiler timeline."""
    return jax.profiler.TraceAnnotation(name)


def sweep_cost(model, data, cfg, chains: int | None = None) -> dict:
    """Compile one sweep and return XLA's cost analysis.

    Returns {'flops', 'bytes_accessed', 'flops_per_sweep_per_chain', ...};
    values are as reported by the backend (may be 0 on some backends).
    """
    import dataclasses

    from nestmc.kernels.gibbs import make_sweep
    from nestmc.kernels.state import init_kernel_state

    if chains is not None:
        cfg = dataclasses.replace(
            cfg, run=dataclasses.replace(cfg.run, chains=chains)
        )
    state = init_kernel_state(model, cfg, jax.random.key(0), data)
    sweep = make_sweep(model, cfg)
    compiled = (
        jax.jit(lambda s, d: sweep(s, d, adapt=False))
        .lower(state, data)
        .compile()
    )
    try:
        costs = compiled.cost_analysis()
        if isinstance(costs, list):
            costs = costs[0] if costs else {}
    except Exception:
        costs = {}
    flops = float(costs.get("flops", 0.0))
    by = float(costs.get("bytes accessed", 0.0))
    out = {
        "flops_per_sweep": flops,
        "bytes_per_sweep": by,
        "flops_per_sweep_per_chain": flops / max(cfg.run.chains, 1),
        "arithmetic_intensity": flops / by if by else None,
    }
    # bandwidth-bound speed of light, only for a device whose published
    # peak is known; any other device gets None, not an assumed rate
    from nestmc.utils.device import hbm_peak

    kind = jax.devices()[0].device_kind
    peak = hbm_peak(kind)
    out["device_kind"] = kind
    out["sol_sweeps_per_sec_hbm"] = peak / by if (peak and by) else None
    return out
