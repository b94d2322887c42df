"""Which formulation of each hot stage runs on this platform.

Mirrors the reference's DCAUTILS_FORCE_FALLBACK pattern
(/root/reference/test/runtests.jl:78-86): every accelerated formulation
has a pure-jnp twin and the two are cross-validated through the same
golden files. This module is the ONE place that maps the platform JAX
runs on (``jax.devices()[0].platform``) to the formulations:

- ``gpu``: streaming row-stats reweighting (the fused int8 kernel of
  ``ops/row_stats_triton.py``, O(M) output) and the gemm-scaffold DI
  (``score/di.di_pairs_flat``) — each faster end to end on the H100
  than its alternative (PERF.md);
- ``cpu``: the dense jnp references (the f64 golden mode).

A platform the table does not know raises; it never falls back
silently. ``force_fallback`` / ``GDCA_FORCE_FALLBACK`` (core/config.py)
is the explicit switch to the jnp twins on any platform.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax


@dataclasses.dataclass(frozen=True)
class Formulation:
    """The formulation choices of one platform."""

    platform: str
    streaming_row_stats: bool   # O(M) row-stats reweighting vs dense jnp
    di_batch_minor: bool        # f32 batch-minor DI core vs gemm scaffold


_TABLE = {
    "gpu": Formulation("gpu", streaming_row_stats=True,
                       di_batch_minor=False),
    "cpu": Formulation("cpu", streaming_row_stats=False,
                       di_batch_minor=False),
}


def formulation(platform: Optional[str] = None) -> Formulation:
    """The formulation table entry of ``platform`` (default: the platform
    of ``jax.devices()[0]``). Unknown platforms raise ``RuntimeError``."""
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return _TABLE[platform]
    except KeyError:
        raise RuntimeError(
            f"no formulation for platform {platform!r} (known: "
            f"{', '.join(sorted(_TABLE))}); pass force_fallback=True to "
            "run the jnp reference path") from None


def kernels() -> Dict[str, Optional[Callable]]:
    """Injectable implementations for this platform (None = jnp path).

    ``row_stats_fn(Z, thresh, q) -> (rowsum, below)``: the square int32
    statistics of ``Z`` (ops/row_stats_triton.py).
    """
    if not formulation().streaming_row_stats:
        return {"row_stats_fn": None}
    from gaussdca_tpu.ops.row_stats_triton import row_stats_triton
    return {"row_stats_fn": row_stats_triton}
