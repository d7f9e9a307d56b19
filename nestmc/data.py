"""Nested-data containers (L2 data layer).

The reference stores nested observations (obs within groups/subjects) as
in-memory per-group structures and iterates them in loops; on an accelerator
that becomes static-shaped arrays the compiler can tile:

- **Padded** form: ``(G, max_n, ...)`` arrays plus a ``(G, max_n)`` validity
  mask — one batched kernel over the full ``chains x groups x obs`` lattice.
- **Ragged/segment** form: flat ``(N_obs, ...)`` arrays plus ``segment_ids``,
  reduced with ``jax.ops.segment_sum`` — bounded memory when group sizes are
  highly unbalanced (BASELINE.json:10, 10k ragged groups).
- **Three-level** form (``NestedData3``): obs within subjects within groups,
  via two segment-id levels (BASELINE.json:9 nested Poisson GLMM).

All containers are registered pytrees, so they pass through ``jit`` /
``lax.scan`` / shardings unchanged. Shapes are static; raggedness lives in
masks and segment ids, never in array shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@dataclass(frozen=True)
class NestedData:
    """Two-level nested data: observations within groups, padded + masked.

    Attributes:
      x:     (G, max_n, p) float covariates, or None for intercept-only models.
      y:     (G, max_n) responses (float; cast booleans/counts on ingest).
      mask:  (G, max_n) float32 validity mask (1.0 = real observation).
      sizes: (G,) int32 true group sizes.
      extra: dict of additional per-group or per-obs arrays (e.g. known
             per-group observation scales for the 8-schools model).
    """

    y: jnp.ndarray
    mask: jnp.ndarray
    sizes: jnp.ndarray
    x: jnp.ndarray | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_groups(self) -> int:
        return self.y.shape[0]

    @property
    def max_obs(self) -> int:
        return self.y.shape[1]

    @property
    def num_covariates(self) -> int:
        return 0 if self.x is None else self.x.shape[-1]

    @staticmethod
    def from_ragged(
        ys: Sequence[np.ndarray],
        xs: Sequence[np.ndarray] | None = None,
        max_obs: int | None = None,
        extra: dict | None = None,
        dtype=jnp.float32,
    ) -> "NestedData":
        """Build padded arrays from per-group ragged lists."""
        G = len(ys)
        sizes = np.array([len(y) for y in ys], dtype=np.int32)
        n = int(max_obs if max_obs is not None else (sizes.max() if G else 0))
        y = np.zeros((G, n), dtype=np.float64)
        mask = np.zeros((G, n), dtype=np.float32)
        for g, yg in enumerate(ys):
            k = min(len(yg), n)
            y[g, :k] = np.asarray(yg)[:k]
            mask[g, :k] = 1.0
        x = None
        if xs is not None:
            p = int(np.asarray(xs[0]).shape[-1])
            x = np.zeros((G, n, p), dtype=np.float64)
            for g, xg in enumerate(xs):
                k = min(len(xg), n)
                x[g, :k] = np.asarray(xg)[:k]
        return NestedData(
            y=jnp.asarray(y, dtype=dtype),
            mask=jnp.asarray(mask),
            sizes=jnp.asarray(sizes),
            x=None if x is None else jnp.asarray(x, dtype=dtype),
            extra=dict(extra or {}),
        )

    def to_ragged(self) -> "RaggedData":
        """Flatten to the segment representation (drops padded slots)."""
        mask = np.asarray(self.mask) > 0.5
        seg = np.broadcast_to(
            np.arange(self.num_groups, dtype=np.int32)[:, None], mask.shape
        )[mask]
        y = np.asarray(self.y)[mask]
        x = None if self.x is None else np.asarray(self.x)[mask]
        return RaggedData(
            y=jnp.asarray(y),
            segment_ids=jnp.asarray(seg),
            x=None if x is None else jnp.asarray(x),
            num_groups=self.num_groups,
            extra=dict(self.extra),
        )

    def pad_groups_to(self, G_pad: int) -> "NestedData":
        """Pad the group axis to ``G_pad`` with empty (fully masked) groups.

        Used to make G divisible by the 'groups' mesh axis / kernel tiles.
        Empty groups contribute zero log-likelihood; their group-level
        parameters sample from the prior and are dropped from results.
        """
        G = self.num_groups
        if G_pad == G:
            return self
        if G_pad < G:
            raise ValueError(f"G_pad={G_pad} < num_groups={G}")
        pad = G_pad - G

        def padg(a):
            width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, width)

        return NestedData(
            y=padg(self.y),
            mask=padg(self.mask),
            sizes=padg(self.sizes),
            x=None if self.x is None else padg(self.x),
            extra={k: padg(v) for k, v in self.extra.items()},
        )


_register(NestedData, ["y", "mask", "sizes", "x", "extra"], [])


@dataclass(frozen=True)
class RaggedData:
    """Two-level nested data in flat segment form.

    Attributes:
      y:           (N,) responses over all observations.
      segment_ids: (N,) int32 group index of each observation (sorted ascending).
      x:           (N, p) covariates or None.
      num_groups:  static group count G (segment_sum needs it).
    """

    y: jnp.ndarray
    segment_ids: jnp.ndarray
    num_groups: int
    x: jnp.ndarray | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_obs(self) -> int:
        return self.y.shape[0]

    @property
    def num_covariates(self) -> int:
        return 0 if self.x is None else self.x.shape[-1]

    @staticmethod
    def from_ragged(
        ys: Sequence[np.ndarray],
        xs: Sequence[np.ndarray] | None = None,
        extra: dict | None = None,
        dtype=jnp.float32,
    ) -> "RaggedData":
        seg = np.concatenate(
            [np.full(len(y), g, dtype=np.int32) for g, y in enumerate(ys)]
        ) if ys else np.zeros((0,), np.int32)
        y = np.concatenate([np.asarray(y) for y in ys]) if ys else np.zeros((0,))
        x = None
        if xs is not None:
            x = np.concatenate([np.asarray(xg) for xg in xs], axis=0)
        return RaggedData(
            y=jnp.asarray(y, dtype=dtype),
            segment_ids=jnp.asarray(seg),
            num_groups=len(ys),
            x=None if x is None else jnp.asarray(x, dtype=dtype),
            extra=dict(extra or {}),
        )

    def sizes(self) -> jnp.ndarray:
        return jax.ops.segment_sum(
            jnp.ones_like(self.segment_ids, dtype=jnp.int32),
            self.segment_ids,
            num_segments=self.num_groups,
        )


_register(RaggedData, ["y", "segment_ids", "x", "extra"], ["num_groups"])


@dataclass(frozen=True)
class NestedData3:
    """Three-level nested data: obs within subjects within groups.

    Stored padded at the obs level per subject, with a subject->group index:

      y:             (S, max_n) responses per subject.
      mask:          (S, max_n) obs validity.
      x:             (S, max_n, p) covariates or None.
      subject_group: (S,) int32 group id of each subject.
      num_groups:    static G.

    Reductions: obs->subject via the padded mask (one batched sum);
    subject->group via ``segment_sum`` over ``subject_group``.
    """

    y: jnp.ndarray
    mask: jnp.ndarray
    subject_group: jnp.ndarray
    num_groups: int
    x: jnp.ndarray | None = None
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_subjects(self) -> int:
        return self.y.shape[0]

    @property
    def max_obs(self) -> int:
        return self.y.shape[1]

    @property
    def num_covariates(self) -> int:
        return 0 if self.x is None else self.x.shape[-1]

    @staticmethod
    def from_ragged(
        ys: Sequence[Sequence[np.ndarray]],
        xs: Sequence[Sequence[np.ndarray]] | None = None,
        extra: dict | None = None,
        dtype=jnp.float32,
    ) -> "NestedData3":
        """``ys[g][s]`` = obs array of subject s in group g."""
        flat_y, flat_x, subj_grp = [], [], []
        for g, group in enumerate(ys):
            for s, yarr in enumerate(group):
                flat_y.append(np.asarray(yarr))
                subj_grp.append(g)
                if xs is not None:
                    flat_x.append(np.asarray(xs[g][s]))
        two = NestedData.from_ragged(
            flat_y, flat_x if xs is not None else None, dtype=dtype
        )
        return NestedData3(
            y=two.y,
            mask=two.mask,
            x=two.x,
            subject_group=jnp.asarray(np.array(subj_grp, dtype=np.int32)),
            num_groups=len(ys),
            extra=dict(extra or {}),
        )

    def subjects_per_group(self) -> jnp.ndarray:
        return jax.ops.segment_sum(
            jnp.ones_like(self.subject_group, dtype=jnp.int32),
            self.subject_group,
            num_segments=self.num_groups,
        )


_register(
    NestedData3, ["y", "mask", "subject_group", "x", "extra"], ["num_groups"]
)


def bucket_by_size(
    ys: Sequence[np.ndarray],
    xs: Sequence[np.ndarray] | None = None,
    bucket_edges: Sequence[int] | None = None,
):
    """Split ragged groups into size buckets, each padded to its own max.

    Bounds padding waste when group sizes span orders of magnitude: each
    bucket becomes one NestedData (and one kernel launch) padded only to that
    bucket's cap. Returns ``[(NestedData, group_index_array), ...]`` where
    ``group_index_array`` maps bucket rows back to original group ids.
    """
    sizes = np.array([len(y) for y in ys])
    if bucket_edges is None:
        cap = int(sizes.max()) if len(sizes) else 1
        bucket_edges, e = [], 1
        while e < cap:
            e *= 2
            bucket_edges.append(e)
    out = []
    lo = 0
    for hi in bucket_edges:
        idx = np.where((sizes > lo) & (sizes <= hi))[0]
        if len(idx):
            nd = NestedData.from_ragged(
                [ys[i] for i in idx],
                None if xs is None else [xs[i] for i in idx],
                max_obs=hi,
            )
            out.append((nd, jnp.asarray(idx.astype(np.int32))))
        lo = hi
    return out
