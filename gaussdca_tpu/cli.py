"""Batch CLI: run the gDCA pipeline over one or many MSA files.

The reference has no CLI (usage is from the Julia REPL,
/root/reference/README.md:100-117); this is the batch/streaming front-end
for the 100+-family production mode (SURVEY.md section 7):

    python -m gaussdca_tpu family1.fasta.gz family2.fasta ... -o out/

Per family it writes ``<stem>.rank.txt`` in the reference's "%i %i %e"
emission format and logs one structured JSON record (M, N, q, drop
counts, resolved theta, Meff, stage timings) to stderr.

Artifacts are content-addressed (sha256 of file bytes + the scoring
config) in ``--cache-dir``: re-running a batch skips families whose
inputs and parameters are unchanged — the checkpoint/resume analog for a
pipeline whose unit of work is one stateless family (SURVEY.md section 5).

Batch-throughput machinery (all new relative to the reference):

- ``--m-bucket``: pads each family's sequence count to a bucket multiple
  (masked out of the statistics) so families of similar depth share one
  compiled program instead of recompiling per exact shape,
- a persistent XLA compilation cache (``--compile-cache``, on by
  default) that survives across batch invocations,
- ingest prefetch: family i+1 parses on a host thread while family i
  computes on the device,
- ``--profile-dir``: wraps the batch in a ``jax.profiler`` trace.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import sys
import time
from typing import List, Optional

from gaussdca_tpu.core.config import GDCAConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gaussdca_tpu",
        description="Gaussian Direct Coupling Analysis on JAX: "
                    "contact-prediction rankings from MSA files.")
    p.add_argument("inputs", nargs="+", help="FASTA alignment file(s), "
                   "optionally gzipped")
    p.add_argument("-o", "--output-dir", default=".",
                   help="directory for <stem>.rank.txt outputs")
    p.add_argument("--pseudocount", type=float, default=0.8)
    p.add_argument("--theta", default="auto",
                   help='"auto" or a number in [0, 1]')
    p.add_argument("--max-gap-fraction", type=float, default=0.9)
    p.add_argument("--score", choices=["frob", "DI"], default="frob")
    p.add_argument("--min-separation", type=int, default=5)
    p.add_argument("--remove-dups", action="store_true")
    p.add_argument("--dtype", choices=["float32", "float64"], default=None,
                   help="compute dtype (default: f64 if x64 enabled, "
                        "else f32)")
    p.add_argument("--fallback", action="store_true",
                   help="force the pure-jnp reference formulations")
    p.add_argument("--top-k", type=int, default=None,
                   help="emit only the top K pairs")
    p.add_argument("--cache-dir", default=None,
                   help="content-addressed artifact cache; unchanged "
                        "(file, params) pairs are skipped")
    p.add_argument("--m-bucket", type=int, default=256,
                   help="pad sequence counts to this multiple so similar-"
                        "depth families share compiled programs (0 = exact "
                        "shapes; results are identical either way)")
    p.add_argument("--n-bucket", type=int, default=32,
                   help="pad alignment widths to this multiple (padding "
                        "decouples exactly from the statistics; results "
                        "are identical); combined with --m-bucket one "
                        "compiled program serves a whole (M, N) shape "
                        "class")
    p.add_argument("--compile-cache", default="auto",
                   help="persistent XLA compilation cache dir; 'auto' = "
                        "$JAX_COMPILATION_CACHE_DIR when set, else "
                        "<checkout>/.jax_cache; 'none' disables")
    p.add_argument("--no-prefetch", action="store_true",
                   help="disable threaded ingest prefetch")
    p.add_argument("--warm-compile", action="store_true",
                   help="AOT-compile the next family's shape class on a "
                        "background thread while the current family "
                        "computes, and run each family through the "
                        "in-process executable cache (hides the "
                        "per-class executable load; single-chip batch "
                        "mode only, needs prefetch; results are "
                        "identical — opt-in pending a measurement "
                        "on the card)")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace of the batch here")
    p.add_argument("--mesh", default=None, metavar="DPxTP|auto",
                   help="run the multi-chip sharded pipeline on a "
                        "(data, model) device mesh: 'auto' lays one over "
                        "every visible device, or give an explicit shape "
                        "like '4,2' / '4x2' (data x model; product must "
                        "equal the device count used)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host mode: initialize jax.distributed and "
                        "shard the family list round-robin across "
                        "processes (each family still runs on this "
                        "host's devices). Combined with --mesh this "
                        "becomes the POD execution model: every process "
                        "jointly executes the same sharded program over "
                        "one global mesh spanning all processes' devices "
                        "(process 0 writes the outputs)")
    p.add_argument("--merge-output", default=None,
                   help="additionally write one merged ranking file: "
                        "'<family> <i> <j> <score>' lines, all families "
                        "concatenated in batch order (with --distributed "
                        "and >1 process, each process writes its own "
                        "<path>.part<i>of<n> shard — concatenate them)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-family JSON logs")
    return p


def _parse_theta(s):
    if s == "auto":
        return "auto"
    try:
        return float(s)
    except ValueError:
        raise SystemExit(f"invalid --theta value: {s}")


def _parse_mesh(s: Optional[str]):
    """'auto' | '4,2' | '4x2' -> the api.resolve_mesh argument (or None)."""
    if s is None:
        return None
    if s == "auto":
        return "auto"
    for sep in (",", "x", "X"):
        if sep in s:
            parts = s.split(sep)
            if len(parts) == 2:
                try:
                    return (int(parts[0]), int(parts[1]))
                except ValueError:
                    break
    raise SystemExit(f"invalid --mesh value: {s} (expected 'auto' or "
                     "'DP,TP' like '4,2')")


def _cache_key(path: str, cfg: GDCAConfig, top_k: Optional[int],
               mesh_desc: str = "") -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        h.update(fh.read())
    # the RESOLVED dtype: f32 and f64 runs of the same family must not
    # share an artifact (cfg.dtype=None resolves per-backend). Buckets
    # are included too: bucketed scores match exact-shape scores only to
    # f.p. summation order, so the %e-formatted text can differ — and the
    # same goes for every knob that selects a kernel path (fallback,
    # precision, and the GDCA_* kernel-dispatch env overrides).
    from gaussdca_tpu import __version__
    from gaussdca_tpu.api import _TRACE_ENV_KNOBS
    from gaussdca_tpu.score.di import bm_ns_iters
    from gaussdca_tpu.solve.cholesky import _residual_precision, _syrk_impl

    key = (cfg.pseudocount, cfg.theta, cfg.max_gap_fraction, cfg.score,
           cfg.min_separation, cfg.remove_dups, cfg.resolve_dtype().name,
           cfg.m_bucket, cfg.n_bucket, top_k,
           cfg.resolve_fallback(), cfg.precision,
           # the ONE canonical trace-time knob list (api.py) — a knob
           # listed there must never be missing here, or the artifact
           # cache serves results computed under a different kernel
           # path / iteration count / precision (a past finding:
           # GDCA_DI_NS_ITERS, GDCA_SOLVE_{SYRK,RES_PREC} were missing
           # from both keys when added)
           tuple(os.environ.get(k, "") for k in _TRACE_ENV_KNOBS),
           # RESOLVED defaults + version: a code-default flip (e.g.
           # BM_NS_ITERS or the residual precision changing between
           # releases) must invalidate on-disk artifacts even when the
           # env knobs above are all unset
           __version__, bm_ns_iters(), str(_residual_precision()),
           _syrk_impl(),
           mesh_desc)
    h.update(repr(key).encode())
    return h.hexdigest()


def _mesh_desc(mesh) -> str:
    """Cache-key descriptor of a resolved Mesh ('' = single-chip):
    mesh runs sum in a different order, so artifacts must not be shared."""
    if mesh is None:
        return ""
    return "mesh:" + "x".join(
        f"{a}{mesh.shape[a]}" for a in mesh.axis_names)


def _stem(path: str) -> str:
    stem = os.path.basename(path)
    for suf in (".gz", ".fasta", ".fa", ".afa", ".fna"):
        if stem.endswith(suf):
            stem = stem[: -len(suf)]
    return stem


def _output_stems(paths: List[str]) -> List[str]:
    """Per-input output stems, disambiguating basename collisions so
    famA/align.fasta and famB/align.fasta don't overwrite each other."""
    seen: dict = {}
    out = []
    for p in paths:
        s = _stem(p)
        n = seen.get(s, 0)
        seen[s] = n + 1
        out.append(s if n == 0 else f"{s}.{n + 1}")
    return out


def run_family(path: str, cfg: GDCAConfig, out_dir: str,
               top_k: Optional[int], cache_dir: Optional[str],
               quiet: bool, msa_future=None, stem: str = None,
               cache_key: str = None, mesh=None, emit: bool = True,
               cache_read: bool = True,
               cache_only: bool = False,
               emit_errors_fatal: bool = True,
               exe_cache=None) -> Optional[str]:
    """Process one family; returns the output path.

    ``msa_future``: optional concurrent.futures.Future holding the
    prefetched ingest result (or raising its parse error).
    ``cache_key``: precomputed ``_cache_key`` (the batch loop computes it
    for prefetch decisions; avoids hashing the file twice).
    ``emit=False``: run the compute but write nothing (pod-mesh
    non-writer processes — they participate in the collectives but
    process 0 owns the output files). ``cache_read=False``: never
    short-circuit on an existing artifact (pod-mesh mode decides cache
    hits collectively — a single process skipping the collective
    program on a locally-visible artifact would hang the pod).
    ``emit_errors_fatal=False``: writer-local I/O failures AFTER the
    collective program (output/cache writes) are recorded in the run
    log and reported as ``None`` instead of raised — in pod-mesh mode
    process 0 dying on a local disk error while peers proceed to the
    next family's collectives would wedge the pod with no timeout.
    ``cache_only=True``: the pod already AGREED this family is a cache
    hit (every peer skipped it) — serve from the artifact or record a
    writer-local failure, but NEVER fall through to compute: entering
    the pod-spanning collective program alone (if the artifact vanished
    between the broadcast and this family's turn) would wedge the pod.
    """
    from gaussdca_tpu import api
    from gaussdca_tpu.io import fasta
    from gaussdca_tpu.score.rank import format_rank
    from gaussdca_tpu.utils.log import RunLog

    if stem is None:
        stem = _stem(path)
    out_path = os.path.join(out_dir, stem + ".rank.txt")
    if emit:
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError:
            if emit_errors_fatal:
                raise
            # nonfatal mode: defer — the wrapped emit stage retries the
            # makedirs and records the failure without desyncing a pod

    log = RunLog(stem, enabled=not quiet)

    cached = None
    if cache_dir and emit:
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError:
            if emit_errors_fatal:
                raise
        if cache_key is None:
            cache_key = _cache_key(path, cfg, top_k, _mesh_desc(mesh))
        cached = os.path.join(cache_dir, cache_key)
        if cache_read and os.path.exists(cached):
            try:
                with open(cached) as fh, open(out_path, "w") as out:
                    out.write(fh.read())
            except OSError as e:
                if emit_errors_fatal:
                    raise
                log.set(emit_error=f"{type(e).__name__}: {e}")
                log.emit()
                return None
            log.set(cached=True, output=out_path)
            log.emit()
            return out_path
    if cache_only:
        # pod-agreed hit, but the artifact is gone (evicted/cleaned
        # between the broadcast and this family's turn). Recomputing is
        # forbidden — peers skipped this family, so this process would
        # run the collective program alone and wedge the pod. No
        # collectives are involved in serving a cache hit, so this is a
        # purely writer-local failure: record it and stay in lockstep.
        err = f"pod-agreed cache artifact missing: {cached}"
        if emit_errors_fatal:
            raise RuntimeError(err)
        log.set(emit_error=err)
        log.emit()
        return None

    with log.stage("ingest"):
        if msa_future is not None:
            msa = msa_future.result()
        else:
            msa = fasta.read_fasta_alignment(path, cfg.max_gap_fraction)
    with log.stage("pipeline"):
        result = api.gdca_from_msa(msa, cfg, top_k=top_k, mesh=mesh,
                                   exe_cache=exe_cache)
    if not emit:
        return None
    try:
        with log.stage("emit"):
            R = result.ranking
            text = format_rank(R)
            os.makedirs(out_dir, exist_ok=True)
            with open(out_path, "w") as fh:
                fh.write(text)
            if cached:
                with open(cached, "w") as fh:
                    fh.write(text)
    except OSError as e:
        # post-program writer I/O failure: the collective program is
        # already complete, so (when requested) degrade to a recorded
        # per-family error instead of killing this process
        if emit_errors_fatal:
            raise
        log.set(emit_error=f"{type(e).__name__}: {e}")
        log.emit()
        return None

    from gaussdca_tpu.ops import dispatch
    from gaussdca_tpu.utils.flops import pipeline_flops
    # account the EXECUTED program: bucket-padded dims and the kernel
    # family the dispatch actually took (f64 golden / forced-fallback
    # runs execute the gemm scaffold, not the dense-tile bm plan)
    (Mp, Np), _, _ = api._bucket_shape((result.M, result.N), cfg)
    bm = (not cfg.resolve_fallback()
          and dispatch.formulation().di_batch_minor
          and cfg.resolve_dtype().name == "float32")
    fl = pipeline_flops(Mp, Np, result.q, score=cfg.score,
                        auto_theta=cfg.auto_theta, bm=bm,
                        sharded=mesh is not None)
    pipe_s = log.timings.get("pipeline", 0.0)
    log.set(M=result.M, N=result.N, q=result.q,
            dropped_gaps=result.n_dropped_gaps,
            dropped_dups=result.n_dropped_dups,
            theta=round(result.theta, 6), meff=round(result.meff, 4),
            pairs=len(R), score=cfg.score, output=out_path, cached=False,
            tflop=round(fl["total"] / 1e12, 4),
            tflop_per_s=round(fl["total"] / 1e12 / pipe_s, 2)
            if pipe_s > 0 else None)
    log.emit()
    return out_path


_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "INTERNAL", "UNAVAILABLE",
                      "DEADLINE_EXCEEDED", "ABORTED")


def _retryable(e: BaseException) -> bool:
    """One-retry policy: retry only runtime-flavored failures.

    Deterministic errors (bad input/config/shape bugs: ValueError,
    TypeError, AssertionError, ...) would fail identically on a retry —
    retrying them doubles time-to-failure across a large batch for zero
    benefit. Transient device/runtime state is the retry target:
    RuntimeError subclasses (XlaRuntimeError is one) and anything whose
    message carries an XLA/gRPC transient status code.
    """
    # (the RuntimeError carve-out only matters for exotic
    # multiply-inherited exception classes — keep those retryable)
    if isinstance(e, (ValueError, OSError)) and \
            not isinstance(e, RuntimeError):
        return False
    if isinstance(e, (NotImplementedError, RecursionError)):
        # RuntimeError subclasses by inheritance, but deterministic —
        # an unsupported op or a runaway recursion fails identically
        # on retry
        return False
    if isinstance(e, RuntimeError):
        return True
    name = type(e).__name__
    if "Runtime" in name or "Xla" in name:
        return True
    msg = str(e)
    return any(m in msg for m in _TRANSIENT_MARKERS)


# the fixed in-checkout compile cache (listed in .gitignore): a path
# that never moves, so one checkout's runs find each other's programs
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(spec: str = "auto") -> Optional[str]:
    """The persistent compile-cache directory ``spec`` selects.

    ``auto``: None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then
    reads that directory itself and no other may be set in code), else
    ``DEFAULT_COMPILE_CACHE``. ``none``: None. Anything else: that path.
    """
    if spec == "none":
        return None
    if spec == "auto":
        if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            return None
        return DEFAULT_COMPILE_CACHE
    return spec


def setup_compile_cache(spec: str = "auto") -> None:
    """Point JAX's persistent compile cache at ``compile_cache_dir``."""
    import jax

    path = compile_cache_dir(spec)
    if path is None:
        return
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return  # cache is an optimization only
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = GDCAConfig(
        pseudocount=args.pseudocount,
        theta=_parse_theta(args.theta),
        max_gap_fraction=args.max_gap_fraction,
        score=args.score,
        min_separation=args.min_separation,
        remove_dups=args.remove_dups,
        dtype=args.dtype,
        force_fallback=args.fallback,
        m_bucket=args.m_bucket,
        n_bucket=args.n_bucket,
    )
    if args.dtype == "float64":
        # f64 is only honored when x64 is enabled; without this the
        # pipeline would silently downcast to f32
        import jax
        jax.config.update("jax_enable_x64", True)
    setup_compile_cache(args.compile_cache)
    mesh_spec = _parse_mesh(args.mesh)  # validate early; resolve later
    # --distributed alone round-robins WHOLE families across processes
    # (each process runs its own independent program on its own
    # host-local devices). --distributed WITH --mesh is the POD
    # execution model: every process executes the SAME sharded program
    # over one global mesh spanning all processes' devices (NVLink
    # within a host, the network across hosts) — the multi-host
    # scale-out of the
    # reference's only parallelism (/root/reference/README.md:92-94).
    pod_mesh = bool(args.distributed and mesh_spec is not None)

    from gaussdca_tpu.io import fasta

    # stems must be assigned over the FULL batch (collision disambiguation
    # has to agree across --distributed processes sharing an output dir)
    all_stems = _output_stems(args.inputs)
    stems = all_stems

    merge_path = args.merge_output
    is_writer = True
    pcnt = 1
    if args.distributed:
        from gaussdca_tpu.parallel import mesh as meshlib
        pidx, pcnt = meshlib.init_distributed(force=True)
        if pod_mesh:
            # pod mesh: all processes run the FULL family list in the
            # same order (they jointly execute one sharded program per
            # family); process 0 is the designated writer so outputs
            # land exactly once (on a shared filesystem, or on host 0)
            is_writer = pidx == 0
            if not is_writer:
                merge_path = None
        else:
            args.inputs = meshlib.shard_families(args.inputs, pidx, pcnt)
            stems = meshlib.shard_families(all_stems, pidx, pcnt)
            if merge_path is not None and pcnt > 1:
                # every process opening the same path with mode "w" would
                # truncate/interleave the others; write per-process shard
                # files instead (concatenate them afterwards in any order
                # — family order within each shard is preserved)
                merge_path = f"{merge_path}.part{pidx}of{pcnt}"
        if not args.quiet:
            print(json.dumps({"process": pidx, "of": pcnt,
                              "pod_mesh": pod_mesh,
                              "families": len(args.inputs)}),
                  file=sys.stderr, flush=True)

    # the mesh is resolved AFTER init_distributed: resolve_mesh touches
    # jax.devices(), which initializes the XLA backend, and
    # jax.distributed.initialize must run before any backend init (with
    # --distributed the mesh then spans the whole pod, not one host)
    mesh_obj = None
    if mesh_spec is not None:
        from gaussdca_tpu import api as _api
        mesh_obj = _api.resolve_mesh(mesh_spec)
        if not args.quiet:
            print(json.dumps({
                "mesh": {a: int(mesh_obj.shape[a])
                         for a in mesh_obj.axis_names}}),
                  file=sys.stderr, flush=True)
    mesh_desc = _mesh_desc(mesh_obj)

    # the profiler trace is entered AFTER init_distributed/mesh
    # resolution for the same reason the mesh is: start_trace queries
    # the backend, and backend init must not precede
    # jax.distributed.initialize
    profile_ctx = None
    if args.profile_dir:
        import jax
        os.makedirs(args.profile_dir, exist_ok=True)
        profile_ctx = jax.profiler.trace(args.profile_dir)
        profile_ctx.__enter__()

    t0 = time.perf_counter()
    n_err = 0
    pool = None if args.no_prefetch else \
        concurrent.futures.ThreadPoolExecutor(max_workers=1)

    # --warm-compile: in-process executable cache + background AOT of
    # upcoming shape classes (utils/exe_cache.py). Single-chip batch
    # mode only: the mesh path caches its programs via cached_scores_fn
    # already, and warming needs the prefetch pool to learn the next
    # family's shape.
    exe_cache = None
    if args.warm_compile and mesh_obj is None and pool is not None:
        from gaussdca_tpu.utils.exe_cache import ExecutableCache
        exe_cache = ExecutableCache()

    cache_keys = [None] * len(args.inputs)

    # Pod-mesh artifact-cache agreement: a cache hit must skip the
    # collective program on EVERY process or on none (one process
    # skipping while the rest enter the sharded computation would hang
    # the pod — caches on different hosts need not have the same
    # contents). Process 0 decides from its local cache; one broadcast
    # ships the per-family decisions before any compute starts.
    pod_cache_skip = [False] * len(args.inputs)
    if pod_mesh and args.cache_dir:
        # only the writer's keys are ever used (run_family gates cache
        # I/O on emit, and the skip decision arrives by broadcast) —
        # don't make every peer read + hash the whole input batch
        if is_writer:
            for k in range(len(args.inputs)):
                try:
                    cache_keys[k] = _cache_key(args.inputs[k], cfg,
                                               args.top_k, mesh_desc)
                except OSError:
                    cache_keys[k] = None
        if is_writer:
            pod_cache_skip = [
                bool(ck and os.path.exists(
                    os.path.join(args.cache_dir, ck)))
                for ck in cache_keys]
        if pcnt > 1:
            import numpy as _np
            from jax.experimental import multihost_utils
            dec = multihost_utils.broadcast_one_to_all(
                _np.asarray(pod_cache_skip, _np.bool_))
            pod_cache_skip = [bool(x) for x in _np.asarray(dec)]

    # Pod-mesh writer-setup agreement: every writer-side directory is
    # created (and the merge output opened) BEFORE any compute, and the
    # outcome is broadcast — if process 0 died on a local I/O error
    # (unwritable output dir, quota) while peers entered the first
    # family's collective program, the mismatched collectives would
    # wedge the pod with no timeout. A failed setup aborts ALL
    # processes, visibly, before compute.
    pod_merge_fh = None
    if pod_mesh and pcnt > 1:
        setup_err = ""
        if is_writer:
            try:
                os.makedirs(args.output_dir, exist_ok=True)
                if args.cache_dir:
                    os.makedirs(args.cache_dir, exist_ok=True)
                if merge_path:
                    os.makedirs(os.path.dirname(
                        os.path.abspath(merge_path)), exist_ok=True)
                    pod_merge_fh = open(merge_path, "w")
            except OSError as e:
                setup_err = f"{type(e).__name__}: {e}"
        import numpy as _np
        from jax.experimental import multihost_utils
        bad = multihost_utils.broadcast_one_to_all(
            _np.asarray([1 if setup_err else 0], _np.int32))
        if int(_np.asarray(bad)[0]):
            print(json.dumps({"pod_abort": True, "setup": True,
                              "error": setup_err[:500] or
                              "writer setup failed on process 0"}),
                  file=sys.stderr, flush=True)
            return 2

    def _submit(k: int, futures) -> None:
        # skip the parse for families the artifact cache will short-circuit
        # (the key is kept and passed down — the file is hashed only once)
        if pool is None or k >= len(args.inputs):
            return
        if pod_mesh:
            if pod_cache_skip[k]:
                return
        elif args.cache_dir:
            try:
                cache_keys[k] = _cache_key(args.inputs[k], cfg, args.top_k,
                                           mesh_desc)
                if os.path.exists(os.path.join(args.cache_dir,
                                               cache_keys[k])):
                    return
            except OSError:
                pass
        futures[k] = pool.submit(fasta.read_fasta_alignment,
                                 args.inputs[k], cfg.max_gap_fraction)
        if exe_cache is not None:
            def _warm_cb(f):
                # runs on the prefetch thread once the parse lands;
                # schedules the AOT compile on the cache's own thread.
                # Warming is an optimization only — parse errors are
                # raised (and handled) by the consuming run_family
                try:
                    from gaussdca_tpu import api as _api
                    _api.warm_compile(exe_cache, f.result(), cfg)
                except Exception:
                    pass
            futures[k].add_done_callback(_warm_cb)

    merge_fh = pod_merge_fh
    if merge_path and merge_fh is None:
        parent = os.path.dirname(os.path.abspath(merge_path))
        os.makedirs(parent, exist_ok=True)
        merge_fh = open(merge_path, "w")
    try:
        futures = [None] * len(args.inputs)
        _submit(0, futures)
        for k, path in enumerate(args.inputs):
            _submit(k + 1, futures)
            if pod_mesh and pod_cache_skip[k] and not is_writer:
                continue  # pod-agreed artifact hit: nobody computes
            # pod mode: non-writers compute but emit nothing; cache
            # reads follow the pod-agreed decision, never local state
            emit = is_writer
            cache_read = (not pod_mesh) or pod_cache_skip[k]
            # pod-agreed hit in a >1-process pod: the writer serves the
            # artifact but must never recompute (peers skipped — see
            # run_family's cache_only contract)
            cache_only = pod_mesh and pcnt > 1 and pod_cache_skip[k]
            quiet = args.quiet or not is_writer
            # in a >1-process pod, writer-local I/O failures after the
            # collective program must not kill process 0 (peers would
            # wedge in the next family's collectives) — downgrade them
            # to recorded per-family errors instead
            emit_fatal = not (pod_mesh and pcnt > 1)
            try:
                try:
                    out_path = run_family(path, cfg, args.output_dir,
                                          args.top_k, args.cache_dir,
                                          quiet,
                                          msa_future=futures[k],
                                          stem=stems[k],
                                          cache_key=cache_keys[k],
                                          mesh=mesh_obj, emit=emit,
                                          cache_read=cache_read,
                                          cache_only=cache_only,
                                          emit_errors_fatal=emit_fatal,
                                          exe_cache=exe_cache)
                except Exception as e:
                    if pod_mesh and pcnt > 1:
                        raise  # pod: handled below — never retried
                    if not _retryable(e):
                        raise  # deterministic errors: fail fast
                    # runtime/compile failures (XlaRuntimeError,
                    # RESOURCE_EXHAUSTED, ...) can be transient device
                    # state: one bounded retry, re-ingesting from scratch
                    # (the prefetched future is already consumed)
                    print(json.dumps({"family": path, "retry": True,
                                      "error": str(e)[:500]}),
                          file=sys.stderr, flush=True)
                    out_path = run_family(path, cfg, args.output_dir,
                                          args.top_k, args.cache_dir,
                                          quiet, stem=stems[k],
                                          cache_key=cache_keys[k],
                                          mesh=mesh_obj, emit=emit,
                                          cache_read=cache_read,
                                          cache_only=cache_only,
                                          emit_errors_fatal=emit_fatal,
                                          exe_cache=exe_cache)
                if emit and out_path is None:
                    # non-fatal writer emit failure (pod mode): already
                    # logged by run_family; count it and stay in
                    # lockstep with the other processes
                    n_err += 1
                elif merge_fh is not None and out_path is not None:
                    try:
                        with open(out_path) as fh:
                            for line in fh:
                                merge_fh.write(f"{stems[k]} {line}")
                    except OSError:
                        if emit_fatal:
                            raise
                        n_err += 1
                        print(json.dumps({"family": path,
                                          "merge_error": True}),
                              file=sys.stderr, flush=True)
            except Exception as e:
                if pod_mesh and pcnt > 1:
                    # A failure inside a pod-spanning collective program
                    # cannot be recovered per-process: peers may already
                    # be blocked in the program's collectives, and a
                    # local retry (or skipping to the next family) runs
                    # a DIFFERENT program on this process — mismatched
                    # collectives wedge the pod with no timeout. The
                    # cache-skip broadcast above agrees on what every
                    # process runs BEFORE compute; mid-program errors
                    # abort the whole batch visibly instead.
                    print(json.dumps({"family": path, "pod_abort": True,
                                      "error_type": type(e).__name__,
                                      "error": str(e)[:500]}),
                          file=sys.stderr, flush=True)
                    raise
                # a family that fails twice (or has bad input) must not
                # abort the rest of the batch — record and continue
                n_err += 1
                print(json.dumps({"family": path,
                                  "error_type": type(e).__name__,
                                  "error": str(e)[:500]}),
                      file=sys.stderr, flush=True)
    finally:
        if merge_fh is not None:
            merge_fh.close()
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        if exe_cache is not None:
            exe_cache.shutdown()
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
    if not args.quiet:
        print(json.dumps({
            "batch": len(args.inputs), "errors": n_err,
            "total_s": round(time.perf_counter() - t0, 3),
        }), file=sys.stderr, flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
