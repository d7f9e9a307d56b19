"""Unrolled Cholesky algebra for tiny (p <= 8) symmetric matrices.

The Newton-MH kernel (kernels/newton.py) needs, per (chain, unit), the
Cholesky factor of the conditional's p x p negative Hessian, two triangular
solves and a log-determinant. ``p`` is 2..8 for every nested-data model here
(SURVEY.md section 2.1: group-level coefficient vectors), so batched
``jax.lax.linalg`` calls would be pure overhead — each op lowers to a
loop-structured custom call that cannot fuse with its elementwise neighbors.
Instead every routine below unrolls over the STATIC dimension p into ~p^2/2
scalar-slice ops on a packed lower-triangle layout; XLA fuses the whole
factor-solve-logdet chain into the surrounding (C, G)-batched elementwise
kernel.

Packed layout: a symmetric (or lower-triangular) p x p matrix is stored as
the trailing axis of length T = p (p + 1) / 2, row-major over the lower
triangle: (0,0), (1,0), (1,1), (2,0), (2,1), (2,2), ... All functions
broadcast over arbitrary leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp


def packed_dim(p: int) -> int:
    return p * (p + 1) // 2


def packed_index(i: int, j: int) -> int:
    """Flat index of entry (i, j), i >= j, in the packed lower triangle."""
    if j > i:
        i, j = j, i
    return i * (i + 1) // 2 + j


def diag_indices(p: int) -> list:
    return [packed_index(k, k) for k in range(p)]


def pack_dense(a, p: int):
    """(..., p, p) symmetric -> (..., T) packed lower triangle."""
    cols = [a[..., i, j] for i in range(p) for j in range(i + 1)]
    return jnp.stack(cols, axis=-1)


def unpack_dense(packed, p: int):
    """(..., T) packed -> (..., p, p) full symmetric matrix."""
    rows = []
    for i in range(p):
        row = [
            packed[..., packed_index(i, j)] for j in range(p)
        ]
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)


def pack_diag(d, p: int):
    """(..., p) diagonal -> (..., T) packed with zero off-diagonals."""
    zero = jnp.zeros_like(d[..., 0])
    cols = []
    for i in range(p):
        for j in range(i + 1):
            cols.append(d[..., i] if i == j else zero)
    return jnp.stack(cols, axis=-1)


def chol_packed(a, p: int):
    """Cholesky factor L (packed) of a packed SPD matrix. Unrolled Crout:
    L[j,j] = sqrt(a[j,j] - sum_k L[j,k]^2), L[i,j] = (a[i,j] - sum_k
    L[i,k] L[j,k]) / L[j,j]. No pivoting — callers guarantee positive
    definiteness (negative Hessians of log-concave conditionals plus a
    positive-definite prior precision)."""
    L = [None] * packed_dim(p)
    for j in range(p):
        s = a[..., packed_index(j, j)]
        for k in range(j):
            ljk = L[packed_index(j, k)]
            s = s - ljk * ljk
        L[packed_index(j, j)] = jnp.sqrt(s)
        inv_d = 1.0 / L[packed_index(j, j)]
        for i in range(j + 1, p):
            s = a[..., packed_index(i, j)]
            for k in range(j):
                s = s - L[packed_index(i, k)] * L[packed_index(j, k)]
            L[packed_index(i, j)] = s * inv_d
    return jnp.stack(L, axis=-1)


def solve_lower(L, b, p: int):
    """y with L y = b (forward substitution), b: (..., p)."""
    y = [None] * p
    for i in range(p):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., packed_index(i, k)] * y[k]
        y[i] = s / L[..., packed_index(i, i)]
    return jnp.stack(y, axis=-1)


def solve_upper_t(L, b, p: int):
    """x with L^T x = b (back substitution), b: (..., p)."""
    x = [None] * p
    for i in reversed(range(p)):
        s = b[..., i]
        for k in range(i + 1, p):
            s = s - L[..., packed_index(k, i)] * x[k]
        x[i] = s / L[..., packed_index(i, i)]
    return jnp.stack(x, axis=-1)


def spd_solve(L, b, p: int):
    """x with (L L^T) x = b."""
    return solve_upper_t(L, solve_lower(L, b, p), p)


def lt_vec(L, v, p: int):
    """L^T v — whitens r under the metric L L^T: ||L^T r||^2 = r^T (LL^T) r."""
    out = []
    for i in range(p):
        s = L[..., packed_index(i, i)] * v[..., i]
        for k in range(i + 1, p):
            s = s + L[..., packed_index(k, i)] * v[..., k]
        out.append(s)
    return jnp.stack(out, axis=-1)


def half_logdet(L, p: int):
    """log det(L) = 0.5 log det(L L^T): sum of log diagonal entries."""
    s = jnp.log(L[..., packed_index(0, 0)])
    for k in range(1, p):
        s = s + jnp.log(L[..., packed_index(k, k)])
    return s
