"""All-pairs sequence-identity row statistics (hot loop #1).

The reference's inner loop is a threaded, bit-packed XOR/popcount Hamming
kernel over all M(M-1)/2 sequence pairs (SURVEY.md 2.5; the q < 32 limit at
/root/reference/src/GaussDCA.jl:26 exists because of its 5-bit packing).
On an accelerator the same counts are a matrix product,

    matches[a, b] = sum_k sum_c 1[Z_ak = c] * 1[Z_bk = c]  =  (E E^T)[a, b]

with E the {0,1} one-hot expansion [M, N*q]. int8 one-hot operands with
int32 accumulation are exact, so every formulation here agrees bit-for-bit
with the pure-jnp reference ``row_stats_rect_jnp``.

The pipeline never needs the [M, M] match matrix, only two per-row
reductions of it (``rowsum[a] = sum_b matches(a, b)`` and
``below[a] = #{b : hamming(a, b) < thresh}``), so every function here
returns O(M) output:

- ``row_stats_xla``: the plain formulation. A ``lax.map`` over row blocks
  of A runs one s8 x s8 -> s32 GEMM of the block's one-hot against the
  one-hot of all of B, then the threshold count and the row sums. XLA
  hands the GEMM to cuBLAS on the GPU; the [block, Mb] int32 product is
  written and reread once per block. It is the mesh path's per-device
  body (rectangular: a row block against all rows), where it beats the
  kernel (PERF.md).
- ``ops/row_stats_triton.py``: the fused, symmetry-halved Hopper kernel
  for the square statistics of one card.
- ``row_stats_rect_jnp``: the broadcast-compare reference (CPU tests and
  the fallback twin of the mesh path).

Token 0 (padding) matches nothing, not even itself, in every formulation:
padded rows and columns are inert.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# bytes of the per-block [block, Mb] int32 product of ``row_stats_xla``
_BLOCK_PRODUCT_BYTES = 2 ** 29
# token-width alignment: K = N*q is then a multiple of 32 (q odd or
# even), which cuBLAS' int8 GEMM wants — at M=100,000 x N=200 it halved
# the row-stats time on the H100 against an 8-token alignment (PERF.md)
_K_ALIGN = 32
# row-block alignment of ``plan_block_rows``
_ROW_ALIGN = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _onehot_i8(Z: jax.Array, q: int) -> jax.Array:
    """[M, N] tokens -> [M, N*q] int8 one-hot (token 0 -> all zero)."""
    states = jnp.arange(1, q + 1, dtype=jnp.int8)
    E = Z.astype(jnp.int8)[:, :, None] == states
    return E.astype(jnp.int8).reshape(Z.shape[0], -1)


def plan_block_rows(Ma: int, Mb: int) -> int:
    """Row block of ``row_stats_xla``: the [block, Mb] int32 product
    stays under ``_BLOCK_PRODUCT_BYTES``, and the blocks split Ma evenly
    (no near-empty tail block), ``_ROW_ALIGN``-aligned."""
    cap = max(_ROW_ALIGN, _BLOCK_PRODUCT_BYTES // (4 * max(Mb, 1))
              // _ROW_ALIGN * _ROW_ALIGN)
    n_blocks = -(-Ma // cap)
    return _round_up(-(-Ma // n_blocks), _ROW_ALIGN)


@functools.partial(jax.jit, static_argnames=("q", "block_rows"))
def row_stats_xla(ZA: jax.Array, ZB: jax.Array, thresh: jax.Array,
                  q: int = 21, *, block_rows: int = 0):
    """Row stats of A's rows against all of B's rows, O(Ma) output.

    Returns ``(rowsum [Ma] int32, below [Ma] int32)``:
    ``rowsum[a] = sum_b matches(a, b)`` and
    ``below[a] = #{b : N - matches(a, b) < thresh}`` (self included when
    A and B share rows and thresh > 0). The square statistics of one
    token matrix are ``row_stats_xla(Z, Z, ...)``; the mesh path calls it
    with a device's row block as A and the full matrix as B.
    """
    Ma, N = ZA.shape
    Mb, Nb = ZB.shape
    assert N == Nb, (N, Nb)
    if block_rows == 0:
        block_rows = plan_block_rows(Ma, Mb)
    # padding tokens (0) match nothing: the hamming distances keep the
    # true width N
    kpad = (-N) % _K_ALIGN
    ZA = jnp.pad(ZA, ((0, (-Ma) % block_rows), (0, kpad)))
    EB = _onehot_i8(jnp.pad(ZB, ((0, 0), (0, kpad))), q)
    th = jnp.asarray(thresh, jnp.float32)

    def one_block(za):
        # precision pinned to DEFAULT: integer products are exact at any
        # precision, and the pipeline's ambient "highest" context must
        # not reach an s8 GEMM
        d = jax.lax.dot_general(
            _onehot_i8(za, q), EB, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
            precision=jax.lax.Precision.DEFAULT)
        near = (N - d).astype(jnp.float32) < th
        return (jnp.sum(d, axis=1, dtype=jnp.int32),
                jnp.sum(near, axis=1, dtype=jnp.int32))

    rs, below = jax.lax.map(one_block,
                            ZA.reshape(-1, block_rows, N + kpad))
    return rs.reshape(-1)[:Ma], below.reshape(-1)[:Ma]


def row_stats_rect_jnp(ZA: jax.Array, ZB: jax.Array, thresh: jax.Array,
                       q: int = 21, *, row_chunk: int = 256):
    """Broadcast-compare reference of ``row_stats_xla`` (same contract).

    One-hot semantics: token 0 (padding) matches nothing, including
    itself — exactly like the GEMM formulation.
    """
    del q  # the comparison needs no alphabet size
    Ma, N = ZA.shape
    pad = (-Ma) % row_chunk
    ZAp = jnp.pad(ZA, ((0, pad), (0, 0)))
    blocks = ZAp.reshape(-1, row_chunk, N)
    th = jnp.asarray(thresh, jnp.float32)

    def one_block(za):
        eq = (za[:, None, :] == ZB[None, :, :]) & (za[:, None, :] > 0)
        d = jnp.sum(eq, axis=-1, dtype=jnp.int32)
        below = jnp.sum((N - d).astype(jnp.float32) < th, axis=1,
                        dtype=jnp.int32)
        return jnp.sum(d, axis=1, dtype=jnp.int32), below

    rs, below = jax.lax.map(one_block, blocks)
    return rs.reshape(-1)[:Ma], below.reshape(-1)[:Ma]
