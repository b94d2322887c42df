"""Public API: the full Gaussian DCA pipeline.

``gdca(filename, **kwargs)`` mirrors the reference entry point
``gDCA`` (/root/reference/src/GaussDCA.jl:8-47): FASTA -> (dedup) ->
reweighting -> weighted frequencies -> pseudocount -> covariance ->
Cholesky inverse -> FN or DI scores -> APC -> min-separation ranking.

Structure: the host does ingest/dedup and the final sort; one jitted
program does everything in between, so XLA fuses the statistical stages
around the two hot spots (the all-pairs identity matmul and the dense
SPD inverse).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from gaussdca_tpu.core.config import GDCAConfig
from gaussdca_tpu.io import fasta
from gaussdca_tpu.score.apc import correct_apc
from gaussdca_tpu.score.di import di_score
from gaussdca_tpu.score.frob import frob_score
from gaussdca_tpu.score.rank import (Ranking, compute_ranking, printrank,
                                     top_k_device)
from gaussdca_tpu.solve.cholesky import spd_inverse
from gaussdca_tpu.stats.frequencies import weighted_frequencies
from gaussdca_tpu.stats.pseudocount import add_pseudocount, compute_C
from gaussdca_tpu.stats import reweight

MAX_Q = 31  # the reference's 5-bit packing limit (src/GaussDCA.jl:26)


@dataclasses.dataclass
class GDCAResult:
    """Ranking plus the observability handles the reference never exposes."""

    ranking: Ranking
    M: int
    N: int
    q: int
    theta: float
    meff: float
    n_dropped_gaps: int
    n_dropped_dups: int

    def __iter__(self):
        return iter(self.ranking)

    def __len__(self):
        return len(self.ranking)

    def __getitem__(self, k):
        return self.ranking[k]


def scores_pipeline(Z, pc, theta_value, *, q: int, score: str,
                    theta_is_auto: bool, dtype, use_pallas: bool,
                    m_true: Optional[int] = None,
                    n_true: Optional[int] = None,
                    precision: str = "highest"):
    """Device pipeline: tokens -> APC-corrected score matrix (+ theta, Meff).

    A plain traceable function (jit-wrapped by ``_scores_jit``; also the
    body the sharded multi-chip path and the graft entry point reuse).
    ``m_true`` / ``n_true``: unpadded sequence / position counts when Z
    carries token-0 padding rows / columns (bucketed batch mode — row
    padding is masked out of weights, Meff, and the auto-theta pair
    count; column padding shifts hamming by a constant absorbed into the
    threshold and decouples exactly from the covariance, see
    stats/pseudocount.py).
    ``precision``: ambient matmul precision for every dot in the pipeline
    — load-bearing in f32: on the GPU a DEFAULT f32 dot may run in TF32
    (a 10-bit mantissa), and the Cholesky/score stages amplify that
    rounding by cond(C). "highest" keeps every dot without an explicit
    precision in full f32.
    """
    with jax.default_matmul_precision(precision):
        return _scores_body(Z, pc, theta_value, q=q, score=score,
                            theta_is_auto=theta_is_auto, dtype=dtype,
                            use_pallas=use_pallas, m_true=m_true,
                            n_true=n_true)


def _scores_body(Z, pc, theta_value, *, q, score, theta_is_auto, dtype,
                 use_pallas, m_true, n_true=None):
    C, th, Meff = _stats_body(Z, pc, theta_value, q=q,
                              theta_is_auto=theta_is_auto, dtype=dtype,
                              use_pallas=use_pallas, m_true=m_true,
                              n_true=n_true)
    S = _solve_score_body(C, q=q, score=score, n_true=n_true,
                          use_pallas=use_pallas)
    return S, th, Meff


def _stats_body(Z, pc, theta_value, *, q, theta_is_auto, dtype,
                use_pallas, m_true, n_true=None):
    """Tokens -> (covariance C, resolved theta, Meff)."""
    # jax.named_scope per stage: profiler traces (--profile-dir) group ops
    # under these labels, the observability the reference lacks entirely.
    theta: Union[str, Any] = "auto" if theta_is_auto else theta_value
    row_stats_fn = None
    if use_pallas:
        from gaussdca_tpu.ops import dispatch
        row_stats_fn = dispatch.kernels()["row_stats_fn"]
    with jax.named_scope("reweight"):
        if row_stats_fn is not None:
            # streaming path: O(M) memory, int8 one-hot GEMMs
            W, Meff, th = reweight.compute_weights_streaming(
                Z, theta, q, row_stats_fn, dtype=dtype, m_true=m_true,
                n_true=n_true)
        else:
            # dense jnp reference ([M, M] counts; the f64 golden mode)
            W, Meff, th = reweight.compute_weights(
                Z, theta, dtype=dtype, m_true=m_true, n_true=n_true, q=q)
    with jax.named_scope("frequencies"):
        # Stream the frequency accumulation once the one-hot would exceed
        # ~1 GB (keeps 1e5+-sequence MSAs on a single chip).
        M, N = Z.shape
        e_bytes = M * N * (q - 1) * jnp.dtype(dtype).itemsize
        m_chunk = 0 if e_bytes <= 2 ** 30 else max(
            256, (2 ** 30) // (N * (q - 1) * jnp.dtype(dtype).itemsize))
        Pi_t, Pij_t, Meff = weighted_frequencies(Z, W, q, dtype=dtype,
                                                 m_chunk=m_chunk)
    with jax.named_scope("covariance"):
        Pi, Pij = add_pseudocount(Pi_t, Pij_t, pc, q, n_true=n_true)
        C = compute_C(Pi, Pij, n_true=n_true, q=q)
    return C, th, Meff


def _solve_score_body(C, *, q, score, n_true=None, use_pallas=None):
    """Covariance -> APC-corrected score matrix."""
    with jax.named_scope("solve"):
        mJ = spd_inverse(C)
    with jax.named_scope("score"):
        if score == "DI":
            S = di_score(mJ, C, q, use_pallas=use_pallas)
        else:
            S = frob_score(mJ, q)
        S = correct_apc(S, n_true=n_true)
    return S


@functools.partial(
    jax.jit,
    static_argnames=("q", "score", "theta_is_auto", "dtype_name",
                     "use_pallas", "precision"))
def _scores_jit(Z, pc, theta_value, *, q: int, score: str,
                theta_is_auto: bool, dtype_name: str, use_pallas: bool,
                m_true=None, n_true=None, precision: str = "highest"):
    # m_true / n_true are traced (None = no padding): one compiled graph
    # serves a whole (M-bucket, N-bucket) shape class in batch mode.
    return scores_pipeline(
        Z, pc, theta_value, q=q, score=score, theta_is_auto=theta_is_auto,
        dtype=jnp.dtype(dtype_name), use_pallas=use_pallas, m_true=m_true,
        n_true=n_true, precision=precision)


# At and above this N*s the pipeline runs as two programs, so the
# statistics buffers are freed before the solve/score stage allocates
# its own co-resident (Ns)^2 buffers. Correctness-neutral; the value is
# not yet measured on the H100 (ROADMAP.md lists it).
_SPLIT_PIPELINE_MIN_NS = 16384


@functools.partial(
    jax.jit,
    static_argnames=("q", "theta_is_auto", "dtype_name", "use_pallas",
                     "precision"))
def _stats_jit(Z, pc, theta_value, *, q, theta_is_auto, dtype_name,
               use_pallas, m_true=None, n_true=None,
               precision="highest"):
    dtype = jnp.dtype(dtype_name)
    with jax.default_matmul_precision(precision):
        C, th, Meff = _stats_body(
            Z, pc, theta_value, q=q, theta_is_auto=theta_is_auto,
            dtype=dtype, use_pallas=use_pallas, m_true=m_true,
            n_true=n_true)
    return C, th, Meff


@functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("q", "score", "precision", "use_pallas"))
def _solve_score_jit(C, *, q, score, n_true=None, precision="highest",
                     use_pallas=None):
    with jax.default_matmul_precision(precision):
        return _solve_score_body(C, q=q, score=score, n_true=n_true,
                                 use_pallas=use_pallas)


def resolve_mesh(mesh) -> Any:
    """Normalize a ``mesh`` argument: Mesh | "auto" | (dp, tp) -> Mesh."""
    from jax.sharding import Mesh
    from gaussdca_tpu.parallel.mesh import make_mesh

    if isinstance(mesh, Mesh):
        return mesh
    if mesh == "auto":
        return make_mesh()
    if isinstance(mesh, (tuple, list)) and len(mesh) == 2:
        return make_mesh(int(mesh[0]) * int(mesh[1]),
                         shape=(int(mesh[0]), int(mesh[1])))
    raise ValueError(
        f"invalid mesh: {mesh!r} (expected a jax.sharding.Mesh, 'auto', "
        "or a (data, model) shape tuple)")


def put_global(host_array, sharding) -> jax.Array:
    """Place a host array on a (possibly pod-spanning) mesh sharding.

    Single-process: a plain ``jax.device_put`` (no staging copy through
    device 0). Multi-process (a mesh over >1 jax process — the pod
    execution model): ``device_put`` cannot target non-addressable
    devices, so the global array is assembled from per-process local
    shards via ``jax.make_array_from_callback`` — every process holds
    the full host array (each parsed the same file), and the callback
    hands each ADDRESSABLE device exactly its slice.
    """
    if jax.process_count() == 1:
        return jax.device_put(host_array, sharding)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])


def _run_sharded_padded(mesh, tokens, cfg: GDCAConfig, *, q: int,
                        m_true_int: int, n_true_int: int, dtype,
                        theta_is_auto: bool, theta_value: float):
    """Dispatch one family to the multi-chip sharded pipeline.

    ``tokens`` may already carry bucket padding; rows are further padded
    to a device-count multiple. The compiled program is cached per
    (mesh, padded shape, config) — the sharded analog of the single-chip
    shape-class cache. Works unchanged when ``mesh`` spans multiple jax
    processes (the pod execution model: every process runs this same
    function on the same family; see ``put_global``).
    """
    from gaussdca_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from gaussdca_tpu.parallel.sharded import cached_scores_fn
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = resolve_mesh(mesh)
    ndev = mesh.devices.size
    if tokens.shape[0] % ndev != 0:
        pad = ndev - tokens.shape[0] % ndev
        tokens = np.pad(tokens, ((0, pad), (0, 0)))
    # use_pallas=None -> backend auto-detect inside sharded_scores_fn
    # (the sharded flag picks kernels directly, no dispatch-layer gate)
    fn = cached_scores_fn(
        mesh, q=q, score=cfg.score, theta_is_auto=theta_is_auto,
        dtype_name=dtype.name,
        use_pallas=False if cfg.resolve_fallback() else None,
        precision=cfg.precision, solve_min_dim=cfg.solve_min_dim,
        solve_block=cfg.solve_block)
    Zs = put_global(np.asarray(tokens),
                    NamedSharding(mesh, P((DATA_AXIS, MODEL_AXIS), None)))
    repl = NamedSharding(mesh, P())
    scalars = [put_global(np.asarray(v, dt), repl) for v, dt in (
        (float(cfg.pseudocount), dtype), (theta_value, dtype),
        (m_true_int, np.int32), (n_true_int, np.int32))]
    return fn(Zs, *scalars)


def _checked_ranking(S, min_separation: int,
                     top_k: Optional[int]) -> Ranking:
    """Rank S, refusing to emit a solver-poisoned (non-finite) ranking.

    A singular covariance (pseudocount too small for the alignment
    depth) NaNs the inverse, and APC then propagates the NaN to every
    score — the reference fails there with a PosDefException from
    ``inv(cholesky(C))`` (src/GaussDCA.jl:34); silently returning an
    all-NaN ranking would be strictly worse. Checking the two endpoint
    scores is sufficient and O(1): full poisoning NaNs everything,
    and a hypothetical partial NaN sorts last under np.argsort
    (compute_ranking) and first under lax.top_k's descending total
    order (top_k_device).
    """
    if top_k is not None:
        R = top_k_device(S, min_separation, top_k)
    else:
        R = compute_ranking(np.asarray(S), min_separation)
    if R and not (np.isfinite(R[0][2]) and np.isfinite(R[-1][2])):
        raise ArithmeticError(
            "non-finite contact scores: the covariance matrix is not "
            "positive definite (pseudocount too small for this "
            "alignment depth?) — the reference fails here with "
            "PosDefException from inv(cholesky(C))")
    return R


def _bucket_shape(shape, cfg: GDCAConfig):
    """``_bucket_pad``'s shape arithmetic without touching the data:
    (padded (M, N), has_m_true, has_n_true). ``warm_compile`` needs
    only the shape class — padding the real tokens on the prefetch
    thread would copy tens of MB per family just to throw it away.
    tests/test_exe_cache.py pins this against ``_bucket_pad``."""
    M, N = shape
    has_m = cfg.m_bucket > 0 and M % cfg.m_bucket != 0
    has_n = cfg.n_bucket > 0 and N % cfg.n_bucket != 0
    Mp = M + (cfg.m_bucket - M % cfg.m_bucket if has_m else 0)
    Np = N + (cfg.n_bucket - N % cfg.n_bucket if has_n else 0)
    return (Mp, Np), has_m, has_n


def _bucket_pad(tokens: np.ndarray, cfg: GDCAConfig):
    """Apply (m_bucket, n_bucket) padding; -> (tokens, m_true, n_true).

    ``m_true`` / ``n_true`` are traced int32 scalars when the axis was
    padded, else None (so unpadded runs keep the no-masking graph)."""
    m_true = None
    n_true = None
    N_true = tokens.shape[1]
    if cfg.m_bucket > 0 and tokens.shape[0] % cfg.m_bucket != 0:
        pad = cfg.m_bucket - tokens.shape[0] % cfg.m_bucket
        m_true = jnp.asarray(tokens.shape[0], jnp.int32)
        tokens = np.pad(tokens, ((0, pad), (0, 0)))
    if cfg.n_bucket > 0 and tokens.shape[1] % cfg.n_bucket != 0:
        pad = cfg.n_bucket - tokens.shape[1] % cfg.n_bucket
        n_true = jnp.asarray(N_true, jnp.int32)
        tokens = np.pad(tokens, ((0, 0), (0, pad)))
    return tokens, m_true, n_true


# trace-time kernel-dispatch env knobs: an AOT executable compiled under
# one setting must not serve a call made under another. This is THE
# canonical list — the CLI imports it into its artifact cache key, and
# tests/test_cli.py scans the package source for GDCA_* env reads to
# fail the build if a result-affecting knob is added without extending
# it (the drift class: a new knob silently missing from both
# keys).
_TRACE_ENV_KNOBS = ("GDCA_DI_TILED", "GDCA_DI_RB", "GDCA_DI_SHARDED",
                    "GDCA_DI_NS_ITERS", "GDCA_SOLVE_SYRK",
                    "GDCA_SOLVE_RES_PREC")


def _scores_class_key(z_sds, q: int, cfg: GDCAConfig, dtype,
                      theta_is_auto: bool, has_m_true: bool,
                      has_n_true: bool):
    import os

    return ("scores", tuple(z_sds.shape), z_sds.dtype.name, q, cfg.score,
            theta_is_auto,
            dtype.name, not cfg.resolve_fallback(), cfg.precision,
            has_m_true, has_n_true,
            tuple(os.environ.get(k, "") for k in _TRACE_ENV_KNOBS))


def _lower_scores(z_sds, q: int, cfg: GDCAConfig, dtype,
                  theta_is_auto: bool, has_m_true: bool,
                  has_n_true: bool):
    """AOT-compile the single-program pipeline for one shape class."""
    sds = jax.ShapeDtypeStruct
    i32 = sds((), jnp.int32)
    return _scores_jit.lower(
        z_sds, sds((), dtype), sds((), dtype),
        q=q, score=cfg.score, theta_is_auto=theta_is_auto,
        dtype_name=dtype.name, use_pallas=not cfg.resolve_fallback(),
        m_true=i32 if has_m_true else None,
        n_true=i32 if has_n_true else None,
        precision=cfg.precision).compile()


def warm_compile(exe_cache, msa: fasta.MSA, cfg: GDCAConfig) -> bool:
    """Schedule background AOT compilation of ``msa``'s shape class.

    Returns True if the class is warmable (single-chip, below the
    split-pipeline threshold, valid q) — the executable then lands in
    ``exe_cache`` while the caller's current family computes, and
    ``gdca_from_msa(..., exe_cache=...)`` calls it directly. Mesh and
    split-pipeline dispatches are not covered (their programs are cached
    by ``cached_scores_fn`` / jit respectively); invalid alignments are
    skipped silently — the pipeline itself raises the real error.
    """
    if cfg.remove_dups:
        msa = fasta.remove_duplicate_sequences(msa)
    q = msa.q
    if not (2 <= q <= MAX_Q):
        return False
    shape, has_m, has_n = _bucket_shape(msa.tokens.shape, cfg)
    if shape[1] * (q - 1) >= _SPLIT_PIPELINE_MIN_NS:
        return False
    dtype = cfg.resolve_dtype()
    theta_is_auto = cfg.auto_theta
    z_sds = jax.ShapeDtypeStruct(shape, msa.tokens.dtype)
    key = _scores_class_key(z_sds, q, cfg, dtype, theta_is_auto,
                            has_m, has_n)
    exe_cache.warm(key, functools.partial(
        _lower_scores, z_sds, q, cfg, dtype, theta_is_auto,
        has_m, has_n))
    return True


def gdca_from_msa(msa: fasta.MSA, cfg: GDCAConfig,
                  top_k: Optional[int] = None,
                  mesh: Optional[Any] = None,
                  exe_cache=None) -> GDCAResult:
    """Run the device pipeline + ranking on an already-ingested MSA.

    ``top_k``: return only the k best pairs, selected on device
    (jax.lax.top_k) so the full [N, N] score matrix never leaves the
    chip.

    ``mesh``: a ``jax.sharding.Mesh``, a ``(dp, tp)`` shape tuple, or
    "auto" (a mesh over every visible device) — dispatches to the
    multi-chip sharded pipeline (parallel/sharded.py: data-parallel
    sequences, model-parallel statistics, mesh-sharded DI pair batch).
    Results match the single-chip path to floating-point summation
    order; buckets work the same way (the sharded program is compiled
    once per (M-bucket, N-bucket, mesh, config) class).
    """
    if cfg.remove_dups:
        msa = fasta.remove_duplicate_sequences(msa)
    q = msa.q
    if q >= MAX_Q + 1:
        raise ValueError(f"parameter q={q} is too big (max {MAX_Q} is allowed)")
    if q < 2:
        # a single-state alignment has an empty reduced alphabet (s = 0):
        # no statistics exist to estimate
        raise ValueError(
            f"alignment uses only {q} symbol(s); at least 2 are required")

    dtype = cfg.resolve_dtype()
    N_true = msa.tokens.shape[1]
    tokens, m_true, n_true = _bucket_pad(msa.tokens, cfg)
    theta_is_auto = cfg.auto_theta
    theta_value = 0.0 if theta_is_auto else float(cfg.theta)
    if mesh is not None:
        S, th, meff = _run_sharded_padded(
            mesh, tokens, cfg, q=q, m_true_int=msa.M, n_true_int=N_true,
            dtype=dtype, theta_is_auto=theta_is_auto,
            theta_value=theta_value)
        if tokens.shape[1] != N_true:
            S = S[:N_true, :N_true]
        R = _checked_ranking(S, cfg.min_separation, top_k)
        return GDCAResult(
            ranking=R, M=msa.M, N=msa.N, q=q,
            theta=float(th), meff=float(meff),
            n_dropped_gaps=msa.n_dropped_gaps,
            n_dropped_dups=msa.n_dropped_dups,
        )
    Z = jnp.asarray(tokens)
    kw = dict(
        q=q,
        theta_is_auto=theta_is_auto,
        dtype_name=dtype.name,
        use_pallas=not cfg.resolve_fallback(),
        m_true=m_true,
        n_true=n_true,
        precision=cfg.precision,
    )
    pc_a = jnp.asarray(float(cfg.pseudocount), dtype)
    th_a = jnp.asarray(theta_value, dtype)
    if tokens.shape[1] * (q - 1) >= _SPLIT_PIPELINE_MIN_NS:
        # wide alignments: two dispatches so the statistics buffers are
        # freed before the (Ns)^2-heavy solve/score stage allocates
        C, th, meff = _stats_jit(Z, pc_a, th_a, **kw)
        S = _solve_score_jit(C, q=q, score=cfg.score, n_true=n_true,
                             precision=cfg.precision,
                             use_pallas=not cfg.resolve_fallback())
    elif exe_cache is not None:
        # batch mode with --warm-compile: call the AOT executable of
        # this shape class directly (compiled in the background while
        # the previous family ran — utils/exe_cache.py). Same program
        # jit would dispatch; the key pins the trace-time env knobs.
        z_sds = jax.ShapeDtypeStruct(tokens.shape, tokens.dtype)
        key = _scores_class_key(z_sds, q, cfg, dtype,
                                theta_is_auto, m_true is not None,
                                n_true is not None)
        compiled = exe_cache.get(key, functools.partial(
            _lower_scores, z_sds, q, cfg, dtype, theta_is_auto,
            m_true is not None, n_true is not None))
        S, th, meff = compiled(Z, pc_a, th_a, m_true=m_true,
                               n_true=n_true)
    else:
        S, th, meff = _scores_jit(Z, pc_a, th_a, score=cfg.score, **kw)
    if n_true is not None:
        S = S[:N_true, :N_true]  # pad scores are exactly zero; drop them
    R = _checked_ranking(S, cfg.min_separation, top_k)
    return GDCAResult(
        ranking=R, M=msa.M, N=msa.N, q=q,
        theta=float(th), meff=float(meff),
        n_dropped_gaps=msa.n_dropped_gaps,
        n_dropped_dups=msa.n_dropped_dups,
    )


def gdca(
    filename: str,
    *,
    pseudocount: float = 0.8,
    theta: Union[str, float] = "auto",
    max_gap_fraction: float = 0.9,
    score: str = "frob",
    min_separation: int = 5,
    remove_dups: bool = False,
    dtype: Optional[Any] = None,
    force_fallback: bool = False,
    top_k: Optional[int] = None,
    m_bucket: int = 0,
    n_bucket: int = 0,
    precision: str = "highest",
    mesh: Optional[Any] = None,
) -> GDCAResult:
    """Contact-prediction ranking of an MSA file.

    Same signature, defaults, and validation as the reference ``gDCA``
    (src/GaussDCA.jl:8-15; ``theta`` spelled out since Python identifiers
    can't be Greek). Returns a GDCAResult — an iterable of 1-based
    (i, j, score) triples sorted by descending score, plus run metadata.

    Extras (all optional; results are identical either way):

    - ``top_k``: return only the k best pairs, selected on device so the
      full [N, N] score matrix never leaves the chip.
    - ``m_bucket`` / ``n_bucket``: pad the sequence count / alignment
      width to a bucket multiple so similar-shaped families share one
      compiled program (batch mode; padding is masked exactly).
    - ``precision``: ambient matmul precision ("highest" default — a
      DEFAULT f32 dot may run in TF32 on the GPU, which costs ~3 digits).
    - ``mesh``: a ``jax.sharding.Mesh`` (or "auto" to build one over all
      visible devices) — runs the multi-chip sharded pipeline
      (data-parallel sequences + model-parallel statistics) instead of
      the single-chip one.
    """
    cfg = GDCAConfig(
        pseudocount=pseudocount, theta=theta,
        max_gap_fraction=max_gap_fraction, score=score,
        min_separation=min_separation, remove_dups=remove_dups,
        dtype=dtype, force_fallback=force_fallback,
        m_bucket=m_bucket, n_bucket=n_bucket, precision=precision,
    )
    msa = fasta.read_fasta_alignment(filename, cfg.max_gap_fraction)
    return gdca_from_msa(msa, cfg, top_k=top_k, mesh=mesh)


__all__ = ["gdca", "gdca_from_msa", "printrank", "GDCAConfig", "GDCAResult"]
