"""Sequence reweighting: auto-theta + similarity-threshold weights.

Implements the contract of DCAUtils ``compute_weighted_frequencies``'s
weighting stage as consumed at /root/reference/src/GaussDCA.jl:28 with
``theta = :auto`` default (src/GaussDCA.jl:11):

- pairwise identity: ``matches(a, b) = #{k : Z[a,k] == Z[b,k]}`` over the
  full alphabet (a gap aligned to a gap counts as a match, exactly like the
  reference's packed-XOR Hamming kernel),
- auto-theta: ``theta = min(0.5, 0.38 * 0.32 / meanfracid)`` with
  ``meanfracid`` the mean pairwise fraction-identity over all M(M-1)/2 pairs,
- weights: ``thresh = floor(theta * N)``;
  ``W[a] = 1 / (1 + #{b != a : hamming(a, b) < thresh})``; ``Meff = sum(W)``.
  ``theta == 0`` gives uniform weights (golden case small.DIRout2).

This module is the pure-jnp reference path ("fallback" in the sense of the
reference's DCAUTILS_FORCE_FALLBACK cross-check, test/runtests.jl:78-86).
The accelerated path (``compute_weights_streaming`` with the int8 one-hot
GEMM row stats of ops/distance.py) must agree exactly — distances are
small integers, exact in every dtype.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import jax
import jax.numpy as jnp

AUTO_THETA_COEFF = 0.38 * 0.32  # = 0.1216, the reference's auto-theta constant


def match_counts(Z: jax.Array, *, row_chunk: int = 512) -> jax.Array:
    """All-pairs identity counts: out[a, b] = #{k : Z[a,k] == Z[b,k]}.

    Pure-jnp fallback; O(M^2 N) via chunked broadcast-compare so peak
    memory is O(row_chunk * M * N) bools. One-hot semantics: token 0
    (padding) matches nothing, including itself — same as the kernels.
    """
    M, _ = Z.shape
    if M <= row_chunk:
        eq = (Z[:, None, :] == Z[None, :, :]) & (Z[:, None, :] > 0)
        return jnp.sum(eq, axis=-1, dtype=jnp.int32)

    pad = (-M) % row_chunk
    Zp = jnp.pad(Z, ((0, pad), (0, 0)))
    blocks = Zp.reshape(-1, row_chunk, Z.shape[1])

    def one_block(zb):
        eq = (zb[:, None, :] == Z[None, :, :]) & (zb[:, None, :] > 0)
        return jnp.sum(eq, axis=-1, dtype=jnp.int32)

    out = jax.lax.map(one_block, blocks).reshape(-1, M)
    return out[:M]


def mean_fraction_identity(D: jax.Array, N: int,
                           dtype=jnp.float64) -> jax.Array:
    """Mean pairwise fraction-identity over the M(M-1)/2 off-diagonal pairs."""
    M = D.shape[0]
    total = (jnp.sum(D, dtype=dtype) - M * N) / 2.0  # strict upper triangle
    npairs = M * (M - 1) / 2.0
    return total / (N * npairs)


def auto_theta(D: jax.Array, N: int, dtype=jnp.float64) -> jax.Array:
    """theta = min(0.5, 0.1216 / meanfracid)."""
    mfi = mean_fraction_identity(D, N, dtype)
    return jnp.minimum(jnp.asarray(0.5, dtype), AUTO_THETA_COEFF / mfi)


def auto_theta_closed_form(Z: jax.Array, q: int, Mt, Nt,
                           dtype=jnp.float64) -> jax.Array:
    """Resolved auto-theta via the single-pass histogram closed form.

    The ONE theta formula shared by the dense (``compute_weights``) and
    streaming (``compute_weights_streaming``) weight paths — exact in
    f64 and bitwise-consistent between them (the pairwise
    ``mean_fraction_identity``/``auto_theta`` pair above is kept as the
    independent cross-check the tests compare against). ``Mt``/``Nt``
    are the TRUE sequence/position counts (Python ints or traced
    scalars): padding rows/columns contribute no matches, so only the
    pair count and the per-row self-match (= Nt) appear here.
    """
    total = (total_matches_closed_form(Z, q, dtype) - Mt * Nt) / 2.0
    mfi = total / (Nt * (Mt * (Mt - 1) / 2.0))
    return jnp.minimum(jnp.asarray(0.5, dtype), AUTO_THETA_COEFF / mfi)


def weights_from_matches(D: jax.Array, N, theta: jax.Array,
                         dtype=jnp.float64,
                         n_pad: int = None) -> Tuple[jax.Array, jax.Array]:
    """Similarity weights from the identity-count matrix.

    hamming(a,b) = N - D[a,b]; neighbor iff hamming < floor(theta*N),
    self excluded. W = 1/(1+neighbors), Meff = sum(W). ``N`` is the true
    alignment width (may be traced); ``n_pad`` the padded token width
    when Z carried token-0 padding columns (counts are then computed
    over n_pad columns but padding never matches, so the hamming shifts
    by a constant n_pad - N absorbed into the threshold).
    """
    thresh = jnp.floor(jnp.asarray(theta, dtype) * N)
    np_ = N if n_pad is None else n_pad
    ham = (np_ - D).astype(dtype)
    below = jnp.sum(ham < thresh + (np_ - N), axis=1, dtype=dtype)
    # The diagonal (hamming 0) is counted iff thresh > 0; remove self-match.
    # (Clamped at 0: token-0 padding rows match nothing, not even
    # themselves, and would otherwise go to -1 -> W = inf.)
    below = jnp.maximum(below - (thresh > 0).astype(dtype), 0.0)
    W = 1.0 / (1.0 + below)
    return W, jnp.sum(W)


def compute_weights(
    Z: jax.Array,
    theta: Union[str, float],
    *,
    dtype=jnp.float64,
    m_true: int = None,
    n_true: int = None,
    q: int = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(W, Meff, resolved_theta) for a token matrix Z [M, N].

    ``theta`` is "auto" or a real in [0, 1] (static: selects the traced
    graph). ``m_true`` / ``n_true``: unpadded sequence / position counts (Python
    ints or traced scalars — traced keeps one compiled graph across a
    padding bucket) when Z carries token-0 padding rows / columns.
    Padding matches nothing — not even itself (one-hot semantics in both
    the kernels and the jnp fallback) — so padding columns shift every
    hamming distance by a constant (absorbed into the threshold) and
    padding rows only leave a spurious unit weight, masked here.
    """
    M, Np = Z.shape
    Nt = Np if n_true is None else jnp.asarray(n_true)
    counts = match_counts(Z)
    if isinstance(theta, str):
        if theta != "auto":
            raise ValueError(f"invalid theta: {theta}")
        Mt = (jnp.asarray(m_true, dtype) if m_true is not None
              else jnp.asarray(M, dtype))
        # q=None scans the full 1..31 state range (absent states count 0)
        th = auto_theta_closed_form(Z, q or 31, Mt, Nt, dtype)
    else:
        th = jnp.asarray(theta, dtype)
    W, Meff = weights_from_matches(counts, Nt, th, dtype, n_pad=Np)
    if m_true is not None:
        W = W * (jnp.arange(M) < jnp.asarray(m_true)).astype(dtype)
        Meff = jnp.sum(W)
    return W, Meff, th


def total_matches_closed_form(Z: jax.Array, q: int,
                              dtype=jnp.float64) -> jax.Array:
    """``sum_{a,b} matches(a, b)`` over ALL ordered row pairs (incl. a=b)
    WITHOUT any pairwise pass: matches(a,b) = sum_k 1[Z_ak = Z_bk != 0],
    so the double sum factorizes through the per-column state histogram,

        sum_ab matches = sum_k sum_{c=1..q} n_{k,c}^2,
        n_{k,c} = #{a : Z_ak = c}.

    O(M*N*q) work instead of the O(M^2*N*q) distance pass — this is what
    makes auto-theta effectively free (the mean pairwise identity needs
    only this total, not per-pair data), collapsing the reference's
    two-pass reweighting design (SURVEY.md 7.4) to a single pass. Token 0
    (padding) is excluded by summing c over 1..q only. Exact in f64; in
    f32 the n^2 accumulation carries ~1e-7 relative error.
    """
    def body(c, acc):
        nc = jnp.sum((Z == c).astype(dtype), axis=0)
        return acc + jnp.sum(nc * nc)

    return jax.lax.fori_loop(1, q + 1, body, jnp.asarray(0.0, dtype))


def compute_weights_streaming(
    Z: jax.Array,
    theta: Union[str, float],
    q: int,
    row_stats_fn,
    *,
    dtype=jnp.float64,
    m_true: int = None,
    n_true: int = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(W, Meff, resolved_theta) in O(M) memory via the row-stats kernel.

    ``row_stats_fn(Z, thresh, q) -> (rowsum, below)`` per ops/distance.py
    (integer counts).
    Same semantics as ``compute_weights`` but never materializes the
    [M, M] match matrix, so it scales to 1e5+ sequences. Unlike the
    reference's two-pass design (mean-identity pass, then threshold
    pass), auto-theta here is resolved by the O(M*N*q) closed form
    ``total_matches_closed_form`` — the O(M^2*N*q) distance kernel runs
    exactly ONCE regardless of theta mode.
    """
    M, Np = Z.shape
    Mt = M if m_true is None else jnp.asarray(m_true, dtype)
    Nt = Np if n_true is None else jnp.asarray(n_true, dtype)
    if isinstance(theta, str):
        if theta != "auto":
            raise ValueError(f"invalid theta: {theta}")
        th = auto_theta_closed_form(Z, q, Mt, Nt, dtype)
    else:
        th = jnp.asarray(theta, dtype)
    thresh = jnp.floor(th.astype(dtype) * Nt)
    # the kernel computes hamming over the padded width; padding columns
    # never match, shifting every distance by the constant Np - Nt,
    # absorbed into the threshold
    _, below = row_stats_fn(Z, (thresh + (Np - Nt)).astype(jnp.float32), q)
    # drop the self-match; clamp at 0 (token-0 padding rows match nothing,
    # not even themselves, and would otherwise go to -1 -> W = inf)
    below = jnp.maximum(
        below.astype(dtype) - (thresh > 0).astype(dtype), 0.0)
    W = 1.0 / (1.0 + below)
    if m_true is not None:
        W = W * (jnp.arange(M) < jnp.asarray(m_true)).astype(dtype)
    return W, jnp.sum(W), th


@functools.partial(jax.jit, static_argnames=("theta_is_auto", "dtype_name"))
def _weights_jit(Z, theta_value, *, theta_is_auto: bool, dtype_name: str):
    dtype = jnp.dtype(dtype_name)
    theta = "auto" if theta_is_auto else theta_value
    return compute_weights(Z, theta, dtype=dtype)
