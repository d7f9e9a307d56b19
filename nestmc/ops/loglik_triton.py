"""Fused obs-pass likelihood kernel for NVIDIA GPUs (Pallas, Triton route).

One kernel computes, for every (chain, group) of the padded lattice, the
log-likelihood and optionally its gradient and packed negative Hessian wrt
the group coefficients:

    eta_i = x[g, i, :] . beta[c, g, :]
    v[c, g]    = sum_i m_i ll(eta_i, y_i)
    grad[c, g] = sum_i m_i r(eta_i, y_i) x[g, i, :]
    hess[c, g] = sum_i m_i w(eta_i) x[g, i, a] x[g, i, b]   (packed, a >= b)

for the Bernoulli-logit (``family="logistic"``) and Poisson-log
(``family="poisson"``) links. Same contract as the jnp references in
:mod:`nestmc.ops.loglik` (``*_loglik_padded``, ``*_logp_grad_hess_padded``),
which the parity tests hold it to.

Design: the (C, G, n) ``eta`` tensor never exists in device memory. One
program owns a tile of TILE_CHAINS chains (one per thread) and TILE_GROUPS
groups; it loops over its groups and, inside each group, over the
observations one at a time (eight per unrolled step): x[g, i, :] and
y[g, i] are scalars every thread of the program shares, so the
1 + p + p(p+1)/2 sums stay in each thread's registers and no reduction
crosses threads. The p-term multiply-add for ``eta`` runs on the CUDA cores
(p is far below any tensor-core shape); per (chain, group) the kernel reads
``beta`` once and writes only the outputs. The kernel sees ``beta`` and its
outputs chain-minor, (G, k, C), so the threads of a warp load and store
consecutive floats; the wrapper transposes around the call. On the H100
this layout ran the judged cell 13% faster end to end than the kernel
reading (C, G, k) in place, whose loads and stores were strided by G*k
floats across a warp, and an earlier layout that gave each program a
(chains x 64 observations) tile and summed across threads ran 1.7-3.7x
slower still (PERF.md).

``interpret=True`` runs the Pallas interpreter (CPU tests). Off the GPU the
kernel must be asked for that explicitly; it never falls back on its own.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as plgpu
from jax.scipy.special import gammaln
from jax.sharding import NamedSharding, PartitionSpec as P

FAMILIES = ("logistic", "poisson")
OUTPUTS = ("v", "vg", "vgh")


def _next_pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def _family_terms(family: str, eta, y, need_w: bool):
    """Per-obs (ll, resid, w) for one link, unmasked.

    logistic: one exp and one log1p per element, shared by the loglik,
    the residual y - sigmoid(eta) and the curvature sigmoid (1 - sigmoid).
    poisson: the rate exp(eta) is the residual's and the curvature's term.
    """
    if family == "logistic":
        e = jnp.exp(-jnp.abs(eta))
        ll = y * eta - (jnp.maximum(eta, 0.0) + jnp.log1p(e))
        inv = 1.0 / (1.0 + e)
        sig = jnp.where(eta >= 0.0, inv, e * inv)
        w = e * inv * inv if need_w else None
        return ll, y - sig, w
    rate = jnp.exp(eta)
    return y * eta - rate, y - rate, rate


def _kernel(beta_ref, x_ref, y_ref, m_ref, *out_refs, C, G, n, p, TC, TG,
            NB, family, outputs, dense):
    """One thread per chain: each walks the group's observations in order,
    reading x[g, i, :] and y[g, i] as scalars every thread shares, so no
    sum ever crosses threads. NB observations per unrolled step."""
    T = p * (p + 1) // 2
    need_g = outputs in ("vg", "vgh")
    need_h = outputs == "vgh"
    ci = pl.program_id(0)
    gi = pl.program_id(1)
    c = ci * TC + jnp.arange(TC)
    cmask = c < C
    n_acc = 1 + (p if need_g else 0) + (T if need_h else 0)
    n_steps = -(-n // NB)

    @pl.loop(0, TG)
    def _group(t):
        g = gi * TG + t
        gs = jnp.minimum(g, G - 1)      # clamped: loads stay in bounds

        def at(width, k):               # offset in a (G, width, C) array
            return (gs * width + k) * C + c

        b = [plgpu.load(beta_ref.at[at(p, k)], mask=cmask, other=0.0)
             for k in range(p)]

        def step(j, acc):
            acc = list(acc)
            for u in range(NB):
                i = j * NB + u
                if n % NB:
                    live = (i < n).astype(jnp.float32)
                    i = jnp.minimum(i, n - 1)
                base = gs * n + i
                xk = [x_ref[base * p + k] for k in range(p)]
                yv = y_ref[base]
                eta = b[0] * xk[0]
                for k in range(1, p):
                    eta = eta + b[k] * xk[k]
                ll, resid, w = _family_terms(family, eta, yv, need_h)
                m = None if dense else m_ref[base]
                if n % NB:
                    m = live if m is None else m * live
                if m is not None:
                    ll = ll * m
                    resid = resid * m
                    w = w * m if need_h else None
                acc[0] = acc[0] + ll
                if need_g:
                    for k in range(p):
                        acc[1 + k] = acc[1 + k] + resid * xk[k]
                if need_h:
                    t_ = 1 + p
                    for a_ in range(p):
                        for b_ in range(a_ + 1):
                            acc[t_] = acc[t_] + w * (xk[a_] * xk[b_])
                            t_ += 1
            return tuple(acc)

        acc = tuple(jnp.zeros((TC,), jnp.float32) for _ in range(n_acc))
        acc = lax.fori_loop(0, n_steps, step, acc)

        smask = cmask & (g < G)
        plgpu.store(out_refs[0].at[at(1, 0)], acc[0], mask=smask)
        if need_g:
            for k in range(p):
                plgpu.store(out_refs[1].at[at(p, k)], acc[1 + k], mask=smask)
        if need_h:
            for t_ in range(T):
                plgpu.store(out_refs[2].at[at(T, t_)], acc[1 + p + t_],
                            mask=smask)


# one chain per thread, 64 chains and 4 groups per program, 2 warps
TILE_CHAINS = 64
TILE_GROUPS = 4


def _lattice(beta, x, y, mask, *, family, outputs, dense, interpret):
    """The pallas_call on one device's block: (v,) + (g,) + (h,) as
    requested, each (C, G[, k]) float32 (v without the Poisson constant).
    The kernel reads and writes them chain-minor, (G, k, C)."""
    C, G, p = beta.shape
    n = x.shape[1]
    T = p * (p + 1) // 2
    if C * G * max(p, T) >= 2**31:
        raise ValueError("lattice too large for int32 offsets")
    TC = min(_next_pow2(C), TILE_CHAINS)
    TG = TILE_GROUPS
    NB = min(n, 8)
    widths = (1, p, T)[:OUTPUTS.index(outputs) + 1]
    kernel = functools.partial(
        _kernel, C=C, G=G, n=n, p=p, TC=TC, TG=TG, NB=NB, family=family,
        outputs=outputs, dense=dense,
    )
    outs = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((C * G * k,), jnp.float32)
                   for k in widths],
        grid=(pl.cdiv(C, TC), pl.cdiv(G, TG)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(TC // 32, 4)), num_stages=1
        ),
        interpret=interpret,
        name=f"nestmc_{family}_{outputs}",
    )(beta.transpose(1, 2, 0).reshape(-1), x.reshape(-1), y.reshape(-1),
      mask.reshape(-1))
    return tuple(o.reshape(G, C).T if i == 0
                 else o.reshape(G, k, C).transpose(2, 0, 1)
                 for i, (o, k) in enumerate(zip(outs, widths)))


@functools.lru_cache(maxsize=None)
def _partitioned(**static):
    """``_lattice`` with its sharding rule: every (chain, group) is
    independent, so under jit on a ('chains', 'groups') mesh each device
    runs the kernel on its own block of the lattice. Without the rule XLA
    would gather every operand to every device and run the whole lattice
    on each (a custom call is opaque to its partitioner)."""
    kern = functools.partial(_lattice, **static)
    n_out = OUTPUTS.index(static["outputs"]) + 1

    @custom_partitioning
    def call(beta, x, y, mask):
        return kern(beta, x, y, mask)

    def shardings(mesh, arg_shapes):
        spec = tuple(arg_shapes[0].sharding.spec) + (None, None)
        c, g = spec[0], spec[1]

        def ns(*names):
            return NamedSharding(mesh, P(*names))
        args = (ns(c, g, None), ns(g, None, None), ns(g, None), ns(g, None))
        return args, (ns(c, g), ns(c, g, None), ns(c, g, None))[:n_out]

    def infer(mesh, arg_shapes, result_shape):
        return shardings(mesh, arg_shapes)[1]

    def partition(mesh, arg_shapes, result_shape):
        args, outs = shardings(mesh, arg_shapes)
        return mesh, kern, outs, args

    call.def_partition(
        infer_sharding_from_operands=infer, partition=partition,
        sharding_rule="c g p, g n p, g n, g n -> "
        + ", ".join(("c g", "c g p", "c g t")[:n_out]),
    )
    return call


@functools.partial(
    jax.jit,
    static_argnames=("family", "outputs", "dense", "interpret"),
)
def fused_loglik(beta, x, y, mask, lgamma_y=None, *, family: str,
                 outputs: str = "v", dense: bool = False,
                 interpret: bool = False):
    """Obs-pass likelihood of ``family`` over the padded lattice.

    beta (C, G, p); x (G, n, p); y, mask (G, n). ``outputs``: "v" -> (C, G);
    "vg" -> ((C, G), (C, G, p)); "vgh" -> (..., (C, G, p(p+1)/2)).
    ``dense``: the caller knows ``mask`` is exactly 1 everywhere, so the
    kernel never reads it. ``lgamma_y``: optional (G, n) lgamma(y + 1)
    table for the Poisson constant (folded into one per-group scalar here,
    outside the kernel).
    """
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if outputs not in OUTPUTS:
        raise ValueError(f"unknown outputs {outputs!r}")
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "fused_loglik compiles for a GPU only; backend is "
            f"{jax.default_backend()!r} (pass interpret=True to run the "
            "Pallas interpreter)"
        )
    f32 = jnp.float32
    outs = _partitioned(
        family=family, outputs=outputs, dense=dense, interpret=interpret,
    )(beta.astype(f32), x.astype(f32), y.astype(f32), mask.astype(f32))
    outs = outs if isinstance(outs, tuple) else (outs,)
    v = outs[0]
    if family == "poisson":
        if lgamma_y is None:
            lgamma_y = gammaln(y + 1.0)
        v = v - jnp.sum(lgamma_y * mask, axis=1)[None, :]
    return v if outputs == "v" else (v, *outs[1:])
