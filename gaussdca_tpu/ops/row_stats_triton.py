"""Row-stats kernel for Hopper through Pallas' Triton route.

The square statistics of one token matrix, with the contract of
``distance.row_stats_xla(Z, Z, ...)`` (int32 ``rowsum`` and ``below`` per
row), fused into one kernel:

- one program per (i, j >= i) pair of ``block``-row tiles (the match
  matrix is symmetric, so the j < i programs exit at once); each loops
  over the width in ``kc``-token chunks, expands both token tiles into q
  int8 one-hot planes in registers, and accumulates q s8 x s8 -> s32 dots
  into a [block, block] tile — E [M, N*q] never lives in device memory,
  and neither does the [M, M] match matrix;
- the threshold count and the row and column reductions run on the
  tile in registers. Programs run in no order on the SMs, so each one
  stores its [block] partials into its own slots of a [T, T, block]
  buffer: its row reductions in slot (i, j) and, off the diagonal, its
  column reductions — the row reductions of block j against block i —
  in slot (j, i), the slot of the program it replaces. Every slot is
  written exactly once, and one XLA reduction over j finishes the rows
  (no atomics, so the sums are the same on every run).

The partial buffers take 8 * Mp^2 / block bytes (626 MB at M=100,000
with block=128). The defaults (block 128, 32-token chunks) and the
launch constants below won a sweep on the H100 (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_NUM_WARPS = 4
_NUM_STAGES = 3


def _kernel(th_ref, z_ref, rs_ref, cnt_ref, *, q: int, n_valid: int,
            block: int, kc: int, nk: int):
    i = pl.program_id(0)
    j = pl.program_id(1)

    @pl.when(j >= i)
    def _():
        def step(k, acc):
            za = z_ref[pl.ds(i * block, block), pl.ds(k * kc, kc)]
            zb = z_ref[pl.ds(j * block, block), pl.ds(k * kc, kc)]
            for c in range(1, q + 1):
                acc = acc + jax.lax.dot_general(
                    (za == c).astype(jnp.int8), (zb == c).astype(jnp.int8),
                    (((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.int32,
                    precision=jax.lax.Precision.DEFAULT)
            return acc

        d = jax.lax.fori_loop(0, nk, step,
                              jnp.zeros((block, block), jnp.int32))
        near = ((n_valid - d).astype(jnp.float32) < th_ref[0]).astype(
            jnp.int32)
        rs_ref[i, j, :] = jnp.sum(d, axis=1, dtype=jnp.int32)
        cnt_ref[i, j, :] = jnp.sum(near, axis=1, dtype=jnp.int32)

        @pl.when(j != i)
        def _():
            rs_ref[j, i, :] = jnp.sum(d, axis=0, dtype=jnp.int32)
            cnt_ref[j, i, :] = jnp.sum(near, axis=0, dtype=jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("q", "block", "kc", "interpret"))
def row_stats_triton(Z: jax.Array, thresh: jax.Array, q: int = 21, *,
                     block: int = 128, kc: int = 32,
                     interpret: bool = False):
    """(rowsum [M] int32, below [M] int32) of ``Z`` against itself.

    ``block`` and ``kc`` are powers of two with ``kc >= 16`` (the Triton
    dot's minimum); ``interpret=True`` runs the kernel on the CPU.
    """
    M, N = Z.shape
    Kp = _round_up(max(N, kc), kc)
    Mp = _round_up(M, block)
    Zp = jnp.pad(Z.astype(jnp.int8), ((0, Mp - M), (0, Kp - N)))
    T = Mp // block
    th = jnp.asarray(thresh, jnp.float32).reshape(1)
    part = jax.ShapeDtypeStruct((T, T, block), jnp.int32)
    rs, below = pl.pallas_call(
        functools.partial(_kernel, q=q, n_valid=N, block=block, kc=kc,
                          nk=Kp // kc),
        grid=(T, T),
        out_shape=(part, part),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        interpret=interpret,
        name="row_stats_triton",
    )(th, Zp)
    return (jnp.sum(rs, axis=1, dtype=jnp.int32).reshape(-1)[:M],
            jnp.sum(below, axis=1, dtype=jnp.int32).reshape(-1)[:M])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m
