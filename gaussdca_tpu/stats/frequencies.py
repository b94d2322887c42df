"""Weighted one- and two-site frequency statistics.

Implements the frequency stage of DCAUtils ``compute_weighted_frequencies``
as consumed at /root/reference/src/GaussDCA.jl:28 and by ``compute_C``
(src/GaussDCA.jl:76):

- states run over the reduced alphabet ``1..s`` with ``s = q - 1`` — the
  highest state (the gap, for standard data) is the gauge and is dropped,
- ``Pi[(i*s + a)] = sum_m W[m] * 1[Z[m,i] == a+1] / Meff``  (0-based),
- ``Pij[(i*s+a), (j*s+b)] = sum_m W[m] * 1[Z[m,i]==a+1] * 1[Z[m,j]==b+1] / Meff``
  for i != j, and the i == j diagonal blocks equal ``diag(Pi_i)``.

Design: both statistics are a single matmul over the one-hot
expansion E [M, N*s] (zero row for the gauge state):
``Pi = W @ E / Meff`` and ``Pij = E^T diag(W) E / Meff``. The one-hot
product reproduces the diagonal blocks exactly (1[Z=a]*1[Z=b] = delta_ab),
so no fixup pass is needed. Under data-parallel sharding of M this becomes
a psum-reduced local matmul (parallel/sharded.py).

Why no custom kernel here (unlike the row statistics of ops/): the
weights W carry ~7 significant digits, so the contraction needs true f32
matmuls (``precision=HIGHEST``; a DEFAULT f32 dot may run in TF32 on the
GPU). Fusing the one-hot expansion into a custom kernel would only save
the E read-back; the scaling lever is memory, handled below by
``m_chunk``: a lax.scan over sequence chunks accumulates Pi/Pij in
O(m_chunk * N * s) working memory, so 1e5+ sequence MSAs run on one card
without ever materializing the full [M, N*s] one-hot.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def one_hot_reduced(Z: jax.Array, q: int, dtype) -> jax.Array:
    """One-hot over states 1..q-1 (state q -> zero row): [M, N*(q-1)]."""
    s = q - 1
    M, N = Z.shape
    states = jnp.arange(1, q, dtype=Z.dtype)
    E = (Z[:, :, None] == states[None, None, :]).astype(dtype)
    return E.reshape(M, N * s)


def accumulate_frequencies(
    Z: jax.Array,
    W: jax.Array,
    q: int,
    *,
    dtype=jnp.float64,
    precision=jax.lax.Precision.HIGHEST,
    m_chunk: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """UNNORMALIZED (pi [N*s], pij [N*s, N*s]) weighted one-hot sums.

    The shared accumulator: the single-chip path divides by Meff; the
    sharded path psums per-device partials first (parallel/sharded.py).
    ``m_chunk > 0`` streams over sequence chunks of that size (peak
    memory O(m_chunk * N * s)); 0 materializes the one-hot in one shot.
    Results are identical up to f.p. summation order.
    """
    M, N = Z.shape
    s = q - 1
    W = W.astype(dtype)
    if m_chunk <= 0 or m_chunk >= M:
        E = one_hot_reduced(Z, q, dtype)
        pi = jnp.einsum("m,mx->x", W, E, precision=precision)
        pij = jnp.einsum("mx,my->xy", E * W[:, None], E,
                         precision=precision)
        return pi, pij

    pad = (-M) % m_chunk
    Zp = jnp.pad(Z, ((0, pad), (0, 0)))          # token 0: zero one-hot row
    Wp = jnp.pad(W, (0, pad))
    Zc = Zp.reshape(-1, m_chunk, N)
    Wc = Wp.reshape(-1, m_chunk)

    def step(carry, chunk):
        pi, pij = carry
        zc, wc = chunk
        Ec = one_hot_reduced(zc, q, dtype)
        pi = pi + jnp.einsum("m,mx->x", wc, Ec, precision=precision)
        pij = pij + jnp.einsum("mx,my->xy", Ec * wc[:, None], Ec,
                               precision=precision)
        return (pi, pij), None

    init = (jnp.zeros((N * s,), dtype), jnp.zeros((N * s, N * s), dtype))
    (pi, pij), _ = jax.lax.scan(step, init, (Zc, Wc))
    return pi, pij


def weighted_frequencies(
    Z: jax.Array,
    W: jax.Array,
    q: int,
    *,
    dtype=jnp.float64,
    precision=jax.lax.Precision.HIGHEST,
    m_chunk: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(Pi_true [N*s], Pij_true [N*s, N*s], Meff) from tokens and weights."""
    Meff = jnp.sum(W.astype(dtype))
    pi, pij = accumulate_frequencies(Z, W, q, dtype=dtype,
                                     precision=precision, m_chunk=m_chunk)
    return pi / Meff, pij / Meff, Meff
