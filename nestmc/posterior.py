"""Posterior container + summaries (L7 output).

Draws stay on device (possibly sharded) until the user asks for summaries;
``summarize`` runs the diagnostics as one jit program and transfers only the
per-parameter summary table to host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from nestmc.diagnostics import diagnose  # noqa: F401  (public re-export)


@dataclass
class Posterior:
    """Sampling results.

    draws: {block_name: (chains, draws, ...)} retained draws (device arrays).
    accept_rates: {block_name: (chains, units)} mean acceptance probability
        over the sampling phase.
    warmup_accept_rates: same, over warmup.
    config: SamplerConfig dict for provenance.
    timings: {'warmup_s', 'sample_s', 'compile_s', ...} wall-clock seconds.
    """

    draws: dict
    accept_rates: dict
    warmup_accept_rates: dict
    config: dict
    timings: dict = field(default_factory=dict)
    full_rhat: dict | None = None
    # full_rhat: {block: classic split R-hat over EVERY unit} streamed by
    # the engine when RunConfig.full_rhat is set — covers blocks whose
    # draws were not retained.
    full_ess: dict | None = None
    # full_ess: {block: {"ess", "ess_lb"}} cross-chain mean-functional ESS
    # (+ one-sided 95% lower confidence bound) over EVERY unit of every
    # block, from the same streamed accumulators (diagnostics.py
    # streaming_ess_finalize; conventions/caveats documented there). With
    # full_rhat_thin=k this reads the thinned subsequence — conservative.
    _diag_cache: dict | None = None

    def diagnostics(self) -> dict:
        if self._diag_cache is None:
            from nestmc.diagnostics import diagnose_chunked

            # chunked over params: bounds the FFT/rank-normalize temps at
            # big (chains x draws) so diagnosing never OOMs the card
            self._diag_cache = diagnose_chunked(self.draws)
        return self._diag_cache

    def worst_rhat(self) -> float:
        """Max R-hat over collected params AND (if streamed) every sampled
        unit of every block via the engine's full_rhat accumulators."""
        d = self.diagnostics()
        vals = [jnp.max(v["rhat"]) for v in d.values()]
        if self.full_rhat is not None:
            vals += [jnp.max(v) for v in self.full_rhat.values()]
        if not vals:  # zero-draw run (e.g. resume with no draws remaining)
            return float("nan")
        return float(jnp.max(jnp.stack(vals)))

    def total_ess(self, kind: str = "ess_bulk") -> float:
        """Sum of ESS over every collected scalar parameter."""
        d = self.diagnostics()
        if not d:
            return 0.0
        return float(
            jnp.sum(jnp.stack([jnp.sum(v[kind]) for v in d.values()]))
        )

    def min_ess(self, kind: str = "ess_bulk") -> float:
        d = self.diagnostics()
        if not d:
            return 0.0
        return float(
            jnp.min(jnp.stack([jnp.min(v[kind]) for v in d.values()]))
        )

    def min_ess_argmin(self, kind: str = "ess_bulk") -> dict | None:
        """Identify the ESS floor: which block/scalar has the minimum ESS.

        Returns {'block', 'index' (unraveled tuple within the block's
        param shape), 'ess'} — the actionable target for mixing work
        (VERDICT r2 item 2: an unattributed floor is not a target)."""
        d = self.diagnostics()
        if not d:
            return None
        best = None
        for name, stats in d.items():
            e = np.asarray(stats[kind])
            idx = int(np.argmin(e))
            val = float(e.ravel()[idx])
            if best is None or val < best["ess"]:
                best = {
                    "block": name,
                    "index": tuple(
                        int(i) for i in np.unravel_index(idx, e.shape)
                    ),
                    "ess": val,
                }
        return best

    def min_ess_all_params(self) -> dict | None:
        """The measured ESS floor over ALL parameters (VERDICT r4 item 5).

        Uses the engine's streamed cross-chain ESS accumulators (present
        when RunConfig.full_rhat was set), which cover every unit of every
        block — including draws never retained. Returns {'block', 'index',
        'ess', 'ess_lb'} at the argmin of the point estimate, where
        'ess_lb' is the one-sided 95% lower confidence bound for that
        scalar. None when full_ess was not streamed."""
        if not self.full_ess:
            return None
        best = None
        for name, stats in self.full_ess.items():
            e = np.asarray(stats["ess"])
            idx = int(np.argmin(e))
            val = float(e.ravel()[idx])
            if best is None or val < best["ess"]:
                best = {
                    "block": name,
                    "index": tuple(
                        int(i) for i in np.unravel_index(idx, e.shape)
                    ),
                    "ess": val,
                    "ess_lb": float(np.asarray(stats["ess_lb"]).ravel()[idx]),
                }
        return best

    def mean(self, name: str):
        x = self.draws[name]
        return jnp.mean(x.reshape((-1,) + x.shape[2:]), axis=0)

    def var(self, name: str, ddof: int = 1):
        x = self.draws[name]
        return jnp.var(x.reshape((-1,) + x.shape[2:]), axis=0, ddof=ddof)

    def quantile(self, name: str, q):
        x = self.draws[name]
        return jnp.quantile(x.reshape((-1,) + x.shape[2:]), q, axis=0)

    def summarize(self) -> dict:
        """Host-side nested summary dict (numpy leaves)."""
        d = self.diagnostics()
        out = {}
        for name, stats in d.items():
            out[name] = {k: np.asarray(v) for k, v in stats.items()}
            if name in self.accept_rates:  # derived quantities have none
                out[name]["accept_rate"] = np.asarray(
                    jnp.mean(self.accept_rates[name])
                )
        return out

    def summary_table(self) -> str:
        """Human-readable fixed-width table of per-block aggregates."""
        d = self.diagnostics()
        lines = [
            f"{'block':<14}{'mean':>10}{'sd':>10}{'rhat_max':>10}"
            f"{'ess_min':>10}{'ess_sum':>12}{'acc':>7}"
        ]
        for name, s in d.items():
            if name in self.accept_rates:
                acc = f"{float(jnp.mean(self.accept_rates[name])):>7.2f}"
            else:
                acc = f"{'-':>7}"  # derived quantity: no MH step
            lines.append(
                f"{name:<14}"
                f"{float(jnp.mean(s['mean'])):>10.3f}"
                f"{float(jnp.mean(s['sd'])):>10.3f}"
                f"{float(jnp.max(s['rhat'])):>10.4f}"
                f"{float(jnp.min(s['ess_bulk'])):>10.0f}"
                f"{float(jnp.sum(s['ess_bulk'])):>12.0f}"
                f"{acc}"
            )
        return "\n".join(lines)
