"""Configuration for the Gaussian DCA pipeline.

Mirrors the reference's keyword arguments, defaults, and validation semantics
(``/root/reference/src/GaussDCA.jl:8-15`` for defaults, ``:49-65`` for
``check_arguments``), plus accelerator knobs (dtype, fallback, mesh) that the
reference — a single-process CPU package — has no analog for.
"""

from __future__ import annotations

import dataclasses
import numbers
import os
from typing import Any, Optional, Union

Theta = Union[str, float, int]

_VALID_SCORES = ("frob", "DI")


def _is_real(x: Any) -> bool:
    # numbers.Real admits numpy scalars (np.float32(0.2) from a
    # parameter sweep is a valid pseudocount; plain isinstance against
    # (int, float) rejects it with a confusing in-range error)
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def _is_int(x: Any) -> bool:
    return isinstance(x, numbers.Integral) and not isinstance(x, bool)


@dataclasses.dataclass(frozen=True)
class GDCAConfig:
    """Frozen pipeline configuration.

    Reference-parity fields (same names, defaults, and validation as
    ``gDCA``'s keyword arguments, src/GaussDCA.jl:9-15):

    - ``pseudocount``: shrinkage toward uniform, in [0, 1]. Default 0.8
      (recommended for :frob; 0.2 recommended for :DI).
    - ``theta``: similarity threshold for reweighting; "auto" or a real
      in [0, 1]. Default "auto".
    - ``max_gap_fraction``: sequences with a larger fraction of gaps are
      dropped at ingest. Default 0.9.
    - ``score``: "frob" (APC-corrected Frobenius norm) or "DI"
      (Gaussian Direct Information). Default "frob".
    - ``min_separation``: minimum |i-j| for ranked pairs, >= 1. Default 5.
    - ``remove_dups``: drop duplicate sequences after ingest. Default False.

    Additions:

    - ``dtype``: compute dtype for the statistical pipeline. ``None``
      selects float64 when JAX x64 is enabled (golden/CPU mode), else
      float32 (the accelerator mode).
    - ``force_fallback``: use the pure-jnp reference implementations of
      every stage instead of the platform's accelerated formulations
      (ops/dispatch.py). Analog of the
      reference's ``DCAUTILS_FORCE_FALLBACK`` env switch
      (test/runtests.jl:79); also honored via the ``GDCA_FORCE_FALLBACK``
      environment variable.
    - ``precision``: ambient jax.lax matmul precision of the pipeline.
    - ``m_bucket``: pad the sequence count up to a multiple of this before
      jitting (0 = exact shapes). Padding rows are fully masked out of the
      statistics; families whose depths land in the same bucket share one
      compiled program — the recompilation-storm guard for batch mode
      (SURVEY.md section 7.4).
    - ``n_bucket``: same for the position axis (0 = exact). Padding
      columns are invisible to the statistics and decouple exactly from
      the covariance (identity pad block — stats/pseudocount.py), at the
      cost of the solve running at the bucketed width. With both buckets
      set, one compiled program serves a whole (M, N) shape class.
    """

    pseudocount: float = 0.8
    theta: Theta = "auto"
    max_gap_fraction: float = 0.9
    score: str = "frob"
    min_separation: int = 5
    remove_dups: bool = False

    dtype: Optional[Any] = None
    force_fallback: bool = False
    precision: str = "highest"
    m_bucket: int = 0
    n_bucket: int = 0
    # mesh-path solve thresholds (parallel/sharded.py): N*s at or above
    # solve_min_dim the covariance inverse switches from the replicated
    # Cholesky to the mesh-blocked distributed factorization with
    # solve_block-sized panels. Single-chip runs ignore both.
    solve_min_dim: int = 4096
    solve_block: int = 1024

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Raise ValueError on invalid settings.

        Same checks and bounds as ``check_arguments``
        (src/GaussDCA.jl:49-65); file existence is checked at ingest.
        """
        pc = self.pseudocount
        if not (_is_real(pc) and 0 <= pc <= 1):
            raise ValueError(
                f"invalid pseudocount value: {pc} (must be between 0 and 1)")
        th = self.theta
        theta_ok = (th == "auto") or (_is_real(th) and 0 <= th <= 1)
        if not theta_ok:
            raise ValueError(
                f"invalid theta value: {th} "
                "(must be either 'auto', or a number between 0 and 1)")
        mgf = self.max_gap_fraction
        if not (_is_real(mgf) and 0 <= mgf <= 1):
            raise ValueError(
                f"invalid max_gap_fraction value: {mgf} "
                "(must be between 0 and 1)")
        if self.score not in _VALID_SCORES:
            raise ValueError(
                f"invalid score value: {self.score} "
                "(must be either 'DI' or 'frob')")
        if not (_is_int(self.min_separation)
                and self.min_separation >= 1):
            raise ValueError(
                f"invalid min_separation value: {self.min_separation} "
                "(must be >= 1)")
        if not (isinstance(self.m_bucket, int) and self.m_bucket >= 0):
            raise ValueError(
                f"invalid m_bucket value: {self.m_bucket} (must be >= 0)")
        if not (isinstance(self.n_bucket, int) and self.n_bucket >= 0):
            raise ValueError(
                f"invalid n_bucket value: {self.n_bucket} (must be >= 0)")
        if not (isinstance(self.solve_min_dim, int)
                and self.solve_min_dim >= 1):
            raise ValueError(
                f"invalid solve_min_dim value: {self.solve_min_dim} "
                "(must be >= 1)")
        if not (isinstance(self.solve_block, int) and self.solve_block >= 8):
            raise ValueError(
                f"invalid solve_block value: {self.solve_block} "
                "(must be >= 8)")

    @property
    def auto_theta(self) -> bool:
        return self.theta == "auto"

    def resolve_fallback(self) -> bool:
        """force_fallback flag OR'd with the GDCA_FORCE_FALLBACK env var."""
        env = os.environ.get("GDCA_FORCE_FALLBACK", "").lower()
        return self.force_fallback or env in ("1", "true", "yes")

    def resolve_dtype(self):
        import jax
        import jax.numpy as jnp

        if self.dtype is not None:
            dt = jnp.dtype(self.dtype)
            if dt == jnp.dtype("float64") and not jax.config.jax_enable_x64:
                # without x64, every f64 array silently downcasts to f32 —
                # fail loudly instead of producing mislabeled results
                raise ValueError(
                    "dtype=float64 requires jax x64 mode: call "
                    'jax.config.update("jax_enable_x64", True) before any '
                    "computation")
            return dt
        return jnp.dtype(jnp.float64 if jax.config.jax_enable_x64
                         else jnp.float32)
