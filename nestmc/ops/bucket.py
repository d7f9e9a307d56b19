"""Bucketed evaluation of ragged likelihoods through the PADDED obs pass.

The alternative ragged strategy to gather + segment_sum
(ops/loglik.py::*_segment): partition groups into size buckets, pad each
bucket only to its own cap (power-of-2 edges bound padding waste to <2x),
and run the padded obs pass (jnp reference or GPU kernel, chosen by
ops/dispatch.py) once per bucket — SURVEY.md §2.1 "size-bucketing to bound
padding waste", the engine wiring for data.py::bucket_by_size.

The bucket structure is built ONCE on the host from the (static) segment
structure; the value gathers run traced, are loop-invariant in the
sampling scan, and keep data sharding flowing through the jit boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class Bucket:
    group_index: jnp.ndarray   # (Gb,) int32 original group ids
    obs_index: jnp.ndarray     # (Gb, cap) int32 flat obs ids, -1 = pad
    cap: int


@dataclass(frozen=True)
class BucketLayout:
    buckets: tuple            # tuple[Bucket, ...]
    num_groups: int

    @staticmethod
    def build(segment_ids, num_groups: int, edges=None,
              min_groups: int = 32) -> "BucketLayout":
        """Bucket groups by size with power-of-2 edges (or explicit
        ``edges``); buckets smaller than ``min_groups`` merge upward so a
        long size tail cannot fragment into many tiny kernel launches.
        Size-0 groups fall in no bucket (their log-likelihood is zero)."""
        seg = np.asarray(segment_ids)
        if seg.size and np.any(np.diff(seg) < 0):
            raise ValueError("segment_ids must be sorted ascending")
        sizes = np.bincount(seg, minlength=num_groups)
        start = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        cap_max = int(sizes.max()) if num_groups else 0
        if edges is None:
            edges, e = [], 1
            while e < cap_max:
                e *= 2
                edges.append(e)
            if not edges:
                edges = [max(cap_max, 1)]
        buckets, pending = [], []
        lo = 0
        for hi in edges:
            idx = np.where((sizes > lo) & (sizes <= hi))[0]
            lo = hi
            pending.append((hi, idx))
            total = sum(len(i) for _, i in pending)
            if total == 0:
                continue
            is_last = hi == edges[-1]
            if total < min_groups and not is_last:
                continue  # merge into the next bucket up
            cap = pending[-1][0]
            gidx = np.concatenate([i for _, i in pending])
            gidx.sort()
            pending = []
            col = np.arange(cap, dtype=np.int64)[None, :]
            row = start[gidx][:, None] + col
            valid = col < sizes[gidx][:, None]
            obs = np.where(valid, row, -1).astype(np.int32)
            buckets.append(Bucket(
                group_index=jnp.asarray(gidx.astype(np.int32)),
                obs_index=jnp.asarray(obs),
                cap=cap,
            ))
        return BucketLayout(buckets=tuple(buckets), num_groups=num_groups)

    def padded_obs(self) -> int:
        return int(sum(
            b.obs_index.shape[0] * b.cap for b in self.buckets
        ))


def _gather_bucket(b: Bucket, x, y):
    """Traced: flat (N, p)/(N,) -> padded (Gb, cap, p)/(Gb, cap) + mask."""
    valid = b.obs_index >= 0
    safe = jnp.maximum(b.obs_index, 0)
    xb = jnp.where(
        valid[:, :, None], jnp.take(x, safe.reshape(-1), axis=0)
        .reshape(safe.shape + (x.shape[-1],)), 0.0,
    )
    yb = jnp.where(valid, jnp.take(y, safe.reshape(-1), axis=0)
                   .reshape(safe.shape), 0.0)
    return xb, yb, valid.astype(jnp.float32)


def _per_bucket(beta, x, y, layout: BucketLayout, impl: str, which: int):
    """Run obs-pass output set ``which`` (0 value, 1 +grad, 2 +Hessian)
    once per bucket and scatter the results back to (C, G, ...)."""
    from nestmc.ops.dispatch import padded_obs_pass

    fn = padded_obs_pass("logistic", impl)[which]
    C, G, p = beta.shape
    T = p * (p + 1) // 2
    outs = [jnp.zeros((C, G), jnp.float32), jnp.zeros((C, G, p), jnp.float32),
            jnp.zeros((C, G, T), jnp.float32)][:which + 1]
    for b in layout.buckets:
        xb, yb, mb = _gather_bucket(b, x, y)
        bb = jnp.take(beta, b.group_index, axis=1)
        got = fn(bb, xb, yb, mb)
        got = got if isinstance(got, tuple) else (got,)
        outs = [o.at[:, b.group_index].set(r) for o, r in zip(outs, got)]
    return outs[0] if which == 0 else tuple(outs)


def bucketed_logistic_loglik(beta, x, y, layout: BucketLayout,
                             impl: str = "jnp"):
    """(C, G, p) beta + flat ragged obs -> (C, G) loglik, one padded
    obs pass per bucket. Parity contract with
    ops/loglik.py::logistic_loglik_segment (tests/test_bucket.py)."""
    return _per_bucket(beta, x, y, layout, impl, 0)


def bucketed_logistic_logp_grad(beta, x, y, layout: BucketLayout,
                                impl: str = "jnp"):
    """Value+grad per bucket: ((C, G), (C, G, p))."""
    return _per_bucket(beta, x, y, layout, impl, 1)


def bucketed_logistic_logp_grad_hess(beta, x, y, layout: BucketLayout,
                                     impl: str = "jnp"):
    """Value+grad+packed-Hessian per bucket — the Newton-MH obs pass on
    ragged data: ((C, G), (C, G, p), (C, G, T)). Same parity contract as
    ops/loglik.py::logistic_logp_grad_hess_segment."""
    return _per_bucket(beta, x, y, layout, impl, 2)
