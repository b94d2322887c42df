"""SPD inverse of the covariance via Cholesky.

The reference's L5 is ``mJ = inv(cholesky(C))`` (/root/reference/src/
GaussDCA.jl:34) — LAPACK dpotrf + dpotri on the dense N*s square matrix.
Here: ``jnp.linalg.cholesky`` + triangular solves against the identity
(cuSOLVER / cuBLAS on the GPU, LAPACK-like on the CPU). The result is
symmetrized (dpotri fills one triangle and mirrors it; cho_solve's
round-off asymmetry is ~ulp but the score stages read both triangles).

In f32 (the accelerator dtype) the Cholesky error amplifies with cond(C)
— visible in the DI scores at small pseudocounts. ``refine_iters`` runs
Newton's iteration X <- X(2I - CX) after the factorization: each step
costs two (Ns)^3 matmuls (HIGHEST residual) and roughly squares the
residual, recovering most of the f64 accuracy at f32 cost. f64 (golden
mode) needs no refinement.

A mesh-sharded blocked factorization for N*s >> 10^3 lives in
solve/blocked.py.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular


def _residual_precision():
    """Precision of the Newton RESIDUAL matmul (trace-time env knob).

    The residual R = I - C X sets the refined inverse's accuracy floor,
    so it runs HIGHEST (full f32) by default. ``high`` (TF32 on the
    H100, which rounds operands to a 10-bit mantissa) is an opt-in for
    throughput-over-accuracy scans: a coarser residual floor can break
    the golden rank identity, which is the product requirement.
    """
    v = os.environ.get("GDCA_SOLVE_RES_PREC", "highest").strip().lower()
    try:
        return {"highest": jax.lax.Precision.HIGHEST,
                "high": jax.lax.Precision.HIGH}[v]
    except KeyError:
        # loud, named failure: a typo'd A/B leg must not silently
        # measure the default (nor crash with a bare KeyError deep in
        # newton_refine)
        raise ValueError(
            f"GDCA_SOLVE_RES_PREC={v!r}: must be 'highest' or 'high'")


def newton_refine(C: jax.Array, X: jax.Array, iters: int,
                  constrain=None, corr_precision=None) -> jax.Array:
    """Newton iterative refinement of an approximate inverse X of C.

    ``constrain`` (optional) is applied to each matmul product — the
    mesh-sharded caller passes a sharding-constraint function so the
    refinement matmuls distribute (solve/blocked.py).

    ``corr_precision``: precision of the CORRECTION matmul X @ R only.
    The residual matmul R = I - C X sets the achievable floor and runs
    HIGHEST by default (``GDCA_SOLVE_RES_PREC`` overrides — see
    ``_residual_precision``); the correction is small (~||R||), so its
    own rounding contributes ~eps * ||R|| of the operand precision
    (TF32 at DEFAULT on the H100) — small against the residual itself.
    """
    p = _residual_precision()
    pc = corr_precision if corr_precision is not None else p
    n = C.shape[0]
    diag = jnp.arange(n)
    ident = constrain if constrain is not None else (lambda x: x)
    for _ in range(iters):
        # R = I - C X without materializing the identity (Ns^2 buffers
        # are the single-chip HBM bound at wide N)
        R = -ident(jnp.matmul(C, X, precision=p))
        R = R.at[diag, diag].add(1.0)
        X = X + ident(jnp.matmul(X, R, precision=pc))
        X = (X + X.T) * 0.5
    return X


def _doubling_plan(n: int, base_target: int = 512):
    """(npad, base, levels): pad n so the block grid is base * 2^k with
    base 128-aligned and >= ``base_target`` — the geometry the doubling
    inversion needs. Padding overhead is bounded by ~2^k * 128."""
    k = 0
    while -(-n // (1 << (k + 1))) >= base_target:
        k += 1
    nb = 1 << k
    base = -(-n // (nb * 128)) * 128
    return base * nb, base, k


def tri_inverse_doubling(L: jax.Array, base: int,
                         prec=jax.lax.Precision.DEFAULT) -> jax.Array:
    """inv(L) for lower-triangular L by recursive block doubling.

    inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]:
    invert all nb = n/base diagonal blocks in ONE batched TRSM, then
    combine pairs bottom-up — each of the log2(nb) levels is two batched
    matmuls over independent pairs. Total n^3/3 flops, nearly all in
    large matmuls instead of a triangular solve's serial panel steps.
    ``n`` must equal base * 2^k (see ``_doubling_plan``; identity-pad
    the factor otherwise).
    """
    n = L.shape[0]
    nb = n // base
    assert base * nb == n and (nb & (nb - 1)) == 0, (n, base)
    L4 = L.reshape(nb, base, nb, base)
    dblocks = L4[jnp.arange(nb), :, jnp.arange(nb), :]
    eye = jnp.broadcast_to(jnp.eye(base, dtype=L.dtype), (nb, base, base))
    dinv = jax.vmap(lambda a, e: solve_triangular(a, e, lower=True))(
        dblocks, eye)
    # the inverse accumulates in the [nb, nb, base, base] block view
    V = jnp.zeros((nb, nb, base, base), L.dtype)
    V = V.at[jnp.arange(nb), jnp.arange(nb)].set(dinv)
    Lb = L4.transpose(0, 2, 1, 3)
    m = base
    while m < n:
        k = m // base            # base blocks per half
        npairs = n // (2 * m)
        p0 = jnp.arange(npairs) * 2 * k

        def big(Vv, r0, c0):
            # gather the [npairs, m, m] big blocks at (r0, c0) offsets
            idx_r = p0[:, None] + r0 + jnp.arange(k)[None, :]
            idx_c = p0[:, None] + c0 + jnp.arange(k)[None, :]
            out = Vv[idx_r[:, :, None], idx_c[:, None, :]]
            return out.transpose(0, 1, 3, 2, 4).reshape(npairs, m, m)

        Ai = big(V, 0, 0)
        Ci = big(V, k, k)
        B = big(Lb, k, 0)
        X = -jnp.einsum("pij,pjk->pik", Ci,
                        jnp.einsum("pij,pjk->pik", B, Ai, precision=prec),
                        precision=prec)
        Xb = X.reshape(npairs, k, base, k, base).transpose(0, 1, 3, 2, 4)
        idx_r = p0[:, None] + k + jnp.arange(k)[None, :]
        idx_c = p0[:, None] + jnp.arange(k)[None, :]
        V = V.at[idx_r[:, :, None], idx_c[:, None, :]].set(Xb)
        m *= 2
    return V.transpose(0, 2, 1, 3).reshape(n, n)


def syrk_lower_blocked(Li: jax.Array, base: int,
                       prec=jax.lax.Precision.HIGH) -> jax.Array:
    """X = Li^T @ Li for LOWER-triangular Li, skipping the structurally
    zero block products.

    A dense matmul spends n^3 MACs; with Li lower triangular,
    X[I, J] = sum_{K >= max(I, J)} Li[K, I]^T Li[K, J], so accumulating
    one row-slab outer product R_K^T R_K (R_K = the nonzero left part of
    block row K, width (K+1)*base) per block row touches only the ~n^3/3
    MACs that are structurally nonzero — same math, same per-block
    precision, different (block) summation order, so it agrees with the
    dense product to f32 rounding. Every flop is one large matmul
    ([w, base] x [base, w], contraction >= base); the accumulator update
    is an in-place windowed add (XLA aliases the carry buffer under
    jit). ``n`` must be a multiple of ``base`` (the doubling plan's
    geometry guarantees it).
    """
    n = Li.shape[0]
    nb = n // base
    assert nb * base == n, (n, base)
    X = jnp.zeros((n, n), Li.dtype)
    for K in range(nb):
        w = (K + 1) * base
        R = jax.lax.slice(Li, (K * base, 0), (w, w))
        X = X.at[:w, :w].add(jnp.matmul(R.T, R, precision=prec))
    return X


def syrk_lower_slab(Li: jax.Array, nslab: int = 8,
                    prec=jax.lax.Precision.HIGH) -> jax.Array:
    """X = Li^T @ Li for LOWER-triangular Li via disjoint column slabs.

    ``syrk_lower_blocked``'s growing-window accumulator
    (`X.at[:w, :w].add`) need not alias, so XLA may copy the full
    [n, n] buffer every step, and its unrolled graph has one shape per
    block row. This variant keeps the structural-zero saving without
    either: for
    column slab J (j0 = J * sw), lower-triangularity makes
    ``X[j0:, slab] = Li[j0:, j0:]^T @ Li[j0:, slab]`` exact (rows
    k < i of Li are zero), so each slab is ONE matmul with a DISJOINT
    output — no accumulator, ``nslab`` compiled shapes, and
    sum_g (n - g*sw)^2 * sw ~ 0.4 n^3 MACs at nslab=8 (vs n^3 dense,
    n^3/3 ideal). The block-upper triangle is filled from the
    transpose by one ``where``. ``n`` must be a multiple of ``nslab``
    (the doubling plan's 128-aligned npad always is)."""
    n = Li.shape[0]
    assert n % nslab == 0, (n, nslab)
    sw = n // nslab
    slabs = []
    for g in range(nslab):
        j0 = g * sw
        R = jax.lax.slice(Li, (j0, j0), (n, n))           # [n-j0, n-j0]
        B = jax.lax.slice(Li, (j0, j0), (n, j0 + sw))     # [n-j0, sw]
        low = jnp.matmul(R.T, B, precision=prec)
        slabs.append(jnp.pad(low, ((j0, 0), (0, 0))))
    Xl = jnp.concatenate(slabs, axis=1)    # zero above the block diag
    r = jnp.arange(n)
    block_upper = (r[:, None] // sw) < (r[None, :] // sw)
    return jnp.where(block_upper, Xl.T, Xl)


def _syrk_impl():
    """``GDCA_SOLVE_SYRK``: ``dense`` (default) | ``slab``
    (``syrk_lower_slab``) | ``blocked`` (``syrk_lower_blocked``). The
    default flips only on a win measured on the card. Unknown values
    raise (a typo'd A/B leg must not silently measure dense)."""
    v = os.environ.get("GDCA_SOLVE_SYRK", "dense").strip().lower()
    if v not in ("dense", "slab", "blocked"):
        raise ValueError(
            f"GDCA_SOLVE_SYRK={v!r}: must be dense | slab | blocked")
    return v


def chunked_cho_inverse(L: jax.Array, rhs_chunk: int) -> jax.Array:
    """inv from a Cholesky factor, solving ``rhs_chunk`` identity columns
    per lax.map step.

    A one-shot n x n triangular solve against the identity holds the
    full RHS and the solver's working copies at once; chunking the RHS
    bounds the live set by ``rhs_chunk`` columns per step.
    """
    n = L.shape[0]
    nc = -(-n // rhs_chunk)

    def step(k, X):
        cols = k * rhs_chunk + jnp.arange(rhs_chunk)
        E = (jnp.arange(n)[:, None] == cols[None, :]).astype(L.dtype)
        xk = cho_solve((L, True), E)
        # in-place carry update: one [n, n] result buffer, no
        # stack-then-transpose copies
        return jax.lax.dynamic_update_slice(X, xk, (0, k * rhs_chunk))

    X0 = jnp.zeros((n, nc * rhs_chunk), L.dtype)
    X = jax.lax.fori_loop(0, nc, step, X0)
    return X[:, :n]


# Size thresholds of the solve paths. All three are correctness-neutral
# (every path is refined to the same residual) and none is yet measured
# on the H100 (ROADMAP.md lists them):
# - above _CHUNKED_SOLVE_MIN the identity RHS is solved in chunks
#   (chunked_cho_inverse) to bound the live set;
# - f32 solves of size [_DOUBLING_MIN, _DOUBLING_MAX] take the doubling
#   path: below it the padding/gather overhead is not worth it, above
#   it several (Ns)^2 buffers live at the top combine level.
_CHUNKED_SOLVE_MIN = 8192
_DOUBLING_MIN = 2048
_DOUBLING_MAX = 24576


def _spd_inverse_doubling(C: jax.Array, refine_iters: int) -> jax.Array:
    """f32 fast path: Cholesky -> doubling triangular inverse (HIGH
    matmuls) -> Linv^T Linv at HIGH -> mixed-precision Newton.

    Every flop lands in large batched matmuls. The precision split: the
    combine/syrk stages only need a good Newton STARTING point; the
    final accuracy comes from the HIGHEST residual matmul in
    ``newton_refine``.
    """
    n = C.shape[0]
    npad, base, _ = _doubling_plan(n)
    Cp = C
    if npad != n:
        Cp = jnp.zeros((npad, npad), C.dtype).at[:n, :n].set(C)
        Cp = Cp.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
    with jax.default_matmul_precision("default"):
        L = jnp.linalg.cholesky(Cp)
    # combine/syrk at HIGH, which the H100 runs in TF32 exactly like
    # DEFAULT (measured: 2.8e-4 relative error on a 2048^3 product,
    # against 2.1e-6 at HIGHEST). The golden gate passes with it on the
    # card (large DI config: max abs error 6.9e-4, tolerance 1e-3);
    # HIGHEST for the combines did NOT help — 1.28e-3 and a top-100
    # flip — so HIGH stays.
    Li = tri_inverse_doubling(L, base, prec=jax.lax.Precision.HIGH)
    impl = _syrk_impl()
    if impl == "slab":
        X = syrk_lower_slab(Li, prec=jax.lax.Precision.HIGH)
    elif impl == "blocked":
        X = syrk_lower_blocked(Li, base, prec=jax.lax.Precision.HIGH)
    else:
        X = jnp.matmul(Li.T, Li, precision=jax.lax.Precision.HIGH)
    X = X[:n, :n]
    return newton_refine(C, X, max(refine_iters, 1),
                         corr_precision=jax.lax.Precision.DEFAULT)


def spd_inverse(C: jax.Array, *, refine_iters: int = None,
                rhs_chunk: int = 0) -> jax.Array:
    """Inverse of a symmetric positive-definite matrix via Cholesky.

    ``refine_iters=None`` picks the dtype default: 1 Newton step in f32,
    0 in f64 (golden mode, already at working precision).

    f64 runs the LAPACK-like path: Cholesky + triangular solves against
    the identity (``rhs_chunk=0`` auto-selects one-shot below
    ``_CHUNKED_SOLVE_MIN``, chunked identity columns above — see
    ``chunked_cho_inverse``).

    f32 at ``_DOUBLING_MIN <= Ns <= _DOUBLING_MAX`` runs the doubling
    path (``_spd_inverse_doubling``): all-matmul triangular inversion +
    mixed-precision Newton. The factorization runs at DEFAULT matmul
    precision even under an ambient "highest" context: the f32
    accuracy comes from the HIGHEST residual matmul in the Newton
    refinement, not the factorization.
    """
    n = C.shape[0]
    if refine_iters is None:
        refine_iters = 0 if C.dtype == jnp.float64 else 1
    if C.dtype != jnp.float64 and refine_iters and \
            _DOUBLING_MIN <= n <= _DOUBLING_MAX:
        return _spd_inverse_doubling(C, refine_iters)
    fact_prec = "highest" if (C.dtype == jnp.float64 or not refine_iters) \
        else "default"
    with jax.default_matmul_precision(fact_prec):
        L = jnp.linalg.cholesky(C)
        if rhs_chunk == 0:
            rhs_chunk = 512 if n > _CHUNKED_SOLVE_MIN else n
        if rhs_chunk >= n:
            inv = cho_solve((L, True), jnp.eye(n, dtype=C.dtype))
        else:
            inv = chunked_cho_inverse(L, rhs_chunk)
    if refine_iters:
        # refine symmetrizes at the end of each step; skipping the
        # pre-symmetrization saves a live Ns^2 buffer at the peak
        return newton_refine(C, inv, refine_iters)
    return (inv + inv.T) * 0.5
