"""Row-chunked mapping helpers.

The pair-block score stages (Frobenius / DI) conceptually build an
``[N, s, N, s]`` tensor; materializing it costs O((N*s)^2) HBM (0.5 GB at
N=400 in f64). Instead we map a per-row function over chunks of rows:
memory drops to O(chunk * N * s^2) while each chunk still vectorizes on
the device via an inner vmap.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def balanced_chunk(n: int, max_chunk: int, align: int = 1) -> int:
    """Chunk size that ceil-splits ``n`` over the minimum chunk count.

    Avoids padding the tail up to a full ``max_chunk`` (which can waste
    up to ~2x compute); the result is rounded up to ``align``.
    """
    if n <= max_chunk:
        return max(n, 1)
    n_chunks = -(-n // max_chunk)
    per = -(-n // n_chunks)
    return -(-per // align) * align


def map_rows(fn: Callable, xs, n_rows: int, chunk: int = 16):
    """Apply ``fn`` (a per-row function) over the leading axis of ``xs``.

    ``xs`` is a pytree whose leaves have leading dimension ``n_rows``.
    Rows are processed ``chunk`` at a time with ``lax.map`` over an inner
    ``vmap``; the row count is padded up to a chunk multiple (``fn`` must
    tolerate junk rows — their outputs are sliced away).
    """
    if n_rows <= chunk:
        return jax.vmap(fn)(xs)
    # prefer a chunk that divides n_rows: the padding path concatenates a
    # full copy of xs, a whole extra (N*s)^2 buffer for the score stages.
    # Only accept divisors >= chunk/2 — otherwise (e.g. prime n_rows) the
    # loop count would blow up and the padded copy is the lesser evil.
    for c in range(chunk, max(chunk // 2, 1) - 1, -1):
        if n_rows % c == 0:
            chunk = c
            break
    pad = (-n_rows) % chunk
    if pad:
        xs = jax.tree_util.tree_map(
            lambda x: jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0),
            xs)
    xs = jax.tree_util.tree_map(
        lambda x: x.reshape((-(n_rows + pad) // -chunk, chunk) + x.shape[1:]),
        xs)
    out = jax.lax.map(jax.vmap(fn), xs)
    out = jax.tree_util.tree_map(
        lambda o: o.reshape((-1,) + o.shape[2:])[:n_rows], out)
    return out
