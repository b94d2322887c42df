"""CLI batch runner: outputs, logging, caching, error handling."""

import json
import os

import pytest

from gaussdca_tpu.cli import main


@pytest.fixture
def small(golden_dir):
    return os.path.join(golden_dir, "small.fasta.gz")


def read_rank(path):
    out = {}
    for line in open(path):
        t = line.split()
        assert len(t) == 3
        out[(int(t[0]), int(t[1]))] = float(t[2])
    return out


def test_cli_single_family(small, tmp_path, capsys):
    rc = main([small, "-o", str(tmp_path)])
    assert rc == 0
    out = tmp_path / "small.rank.txt"
    assert out.exists()
    d = read_rank(out)
    assert len(d) == 1176
    log = capsys.readouterr().err.strip().splitlines()
    rec = json.loads(log[0])
    assert rec["M"] == 106 and rec["N"] == 53 and rec["q"] == 21
    assert rec["meff"] == pytest.approx(92.0)
    assert "pipeline" in rec["timings_s"]


def test_cli_golden_output(small, tmp_path, golden_dir):
    main([small, "-o", str(tmp_path), "--quiet"])
    got = read_rank(tmp_path / "small.rank.txt")
    want = read_rank(os.path.join(golden_dir, "small.FNRout.txt"))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)


def test_cli_top_k(small, tmp_path):
    main([small, "-o", str(tmp_path), "--top-k", "25", "--quiet"])
    assert len(read_rank(tmp_path / "small.rank.txt")) == 25


def test_cli_cache_hit(small, tmp_path, capsys):
    cache = str(tmp_path / "cache")
    out = str(tmp_path / "out")
    main([small, "-o", out, "--cache-dir", cache])
    first = capsys.readouterr().err
    main([small, "-o", out, "--cache-dir", cache])
    second = capsys.readouterr().err
    rec1 = json.loads(first.strip().splitlines()[0])
    rec2 = json.loads(second.strip().splitlines()[0])
    assert rec1["cached"] is False
    assert rec2["cached"] is True
    # different params -> cache miss
    main([small, "-o", out, "--cache-dir", cache, "--min-separation", "4"])
    rec3 = json.loads(capsys.readouterr().err.strip().splitlines()[0])
    assert rec3["cached"] is False
    assert rec3["pairs"] == 1225


def test_cli_batch_with_error(small, tmp_path, capsys):
    rc = main([small, str(tmp_path / "missing.fa"), "-o", str(tmp_path)])
    assert rc == 1
    lines = capsys.readouterr().err.strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert any("error" in r for r in recs)
    batch = recs[-1]
    assert batch["batch"] == 2 and batch["errors"] == 1


class _FakeXlaError(RuntimeError):
    """Stand-in for jaxlib's XlaRuntimeError (not ValueError/OSError)."""


def test_cli_batch_transient_runtime_error(small, tmp_path, capsys,
                                           monkeypatch):
    """A transient runtime failure (XlaRuntimeError-shaped) is retried
    once and the batch completes cleanly (VERDICT r1 item 5)."""
    from gaussdca_tpu import api

    real = api.gdca_from_msa
    calls = {"n": 0}

    def flaky(msa, cfg, top_k=None, mesh=None, exe_cache=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise _FakeXlaError("RESOURCE_EXHAUSTED: out of memory")
        return real(msa, cfg, top_k=top_k, mesh=mesh, exe_cache=exe_cache)

    monkeypatch.setattr(api, "gdca_from_msa", flaky)
    rc = main([small, small, "-o", str(tmp_path)])
    assert rc == 0
    # first family: attempt + retry; second family: one attempt
    assert calls["n"] == 3
    assert (tmp_path / "small.rank.txt").exists()
    assert (tmp_path / "small.2.rank.txt").exists()
    recs = [json.loads(line) for line in
            capsys.readouterr().err.strip().splitlines()]
    assert any(r.get("retry") for r in recs)
    assert recs[-1]["errors"] == 0


def test_cli_batch_deterministic_error_not_retried(small, tmp_path,
                                                   capsys, monkeypatch):
    """Deterministic failures (TypeError-shaped config/shape bugs) fail
    fast — exactly ONE attempt per family, no re-ingest + recompile
    retry that would double time-to-failure across a batch (ADVICE r2)."""
    from gaussdca_tpu import api

    calls = {"n": 0}

    def broken(msa, cfg, top_k=None, mesh=None, exe_cache=None):
        calls["n"] += 1
        raise TypeError("bad config wiring")

    monkeypatch.setattr(api, "gdca_from_msa", broken)
    rc = main([small, small, "-o", str(tmp_path)])
    assert rc == 1
    assert calls["n"] == 2  # one attempt per family, zero retries
    recs = [json.loads(line) for line in
            capsys.readouterr().err.strip().splitlines()]
    assert not any(r.get("retry") for r in recs)
    assert recs[-1]["errors"] == 2


def test_retryable_predicate():
    from gaussdca_tpu.cli import _retryable

    class FakeXla(RuntimeError):
        pass

    class OddError(Exception):
        pass

    assert _retryable(RuntimeError("boom"))
    assert _retryable(FakeXla("RESOURCE_EXHAUSTED"))
    assert _retryable(OddError("DEADLINE_EXCEEDED: collective"))
    assert not _retryable(ValueError("q too big"))
    assert not _retryable(OSError("no such file"))
    assert not _retryable(TypeError("bad arg"))
    assert not _retryable(AssertionError("shape"))
    assert not _retryable(KeyError("k"))


def test_cli_batch_persistent_runtime_error(small, tmp_path, capsys,
                                            monkeypatch):
    """A family that fails BOTH attempts is recorded and the rest of the
    batch still completes — no abort on runtime/compile errors."""
    from gaussdca_tpu import api

    real = api.gdca_from_msa
    calls = {"n": 0}

    def broken_then_ok(msa, cfg, top_k=None, mesh=None, exe_cache=None):
        calls["n"] += 1
        if calls["n"] <= 2:  # family 1: attempt + retry both fail
            raise _FakeXlaError("INTERNAL: compilation failure")
        return real(msa, cfg, top_k=top_k, mesh=mesh, exe_cache=exe_cache)

    monkeypatch.setattr(api, "gdca_from_msa", broken_then_ok)
    rc = main([small, small, "-o", str(tmp_path)])
    assert rc == 1
    assert not (tmp_path / "small.rank.txt").exists()
    assert (tmp_path / "small.2.rank.txt").exists()
    recs = [json.loads(line) for line in
            capsys.readouterr().err.strip().splitlines()]
    err = [r for r in recs if "error_type" in r]
    assert err and err[0]["error_type"] == "_FakeXlaError"
    assert recs[-1] == {"batch": 2, "errors": 1,
                        "total_s": recs[-1]["total_s"]}


def test_cli_di_mode(small, tmp_path, golden_dir):
    main([small, "-o", str(tmp_path), "--quiet", "--score", "DI",
          "--pseudocount", "0.2", "--remove-dups"])
    got = read_rank(tmp_path / "small.rank.txt")
    want = read_rank(os.path.join(golden_dir, "small.DIRout.txt"))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)


def test_pipeline_flops_accounting():
    from gaussdca_tpu.utils.flops import pipeline_flops
    fl = pipeline_flops(1000, 100, 21, score="DI", auto_theta=True)
    assert fl["total"] == sum(v for k, v in fl.items() if k != "total")
    # reweighting dominates at deep M
    fl2 = pipeline_flops(100000, 100, 21, score="frob", auto_theta=True)
    assert fl2["reweight"] > 0.9 * fl2["total"]
    # ONE distance pass in both theta modes (single-pass closed-form
    # auto-theta since round 2): auto adds only the O(M*N*q) histogram
    # term, NOT a second O(M^2*N*q) pass
    M, N, q = 1000, 100, 21
    fl3 = pipeline_flops(M, N, q, score="frob", auto_theta=False)
    fl4 = pipeline_flops(M, N, q, score="frob", auto_theta=True)
    assert fl3["reweight"] == 2.0 * M * M * N * q
    extra = fl4["reweight"] - fl3["reweight"]
    assert 0 < extra < 0.01 * fl3["reweight"]


def test_di_flops_track_scoring_code(monkeypatch):
    """The DI TFLOP accounting must be derived from constants the
    scoring code owns (round-3 verdict weak #4: a drifted iters copy in
    flops.py skewed every per-family DI log)."""
    import inspect

    from gaussdca_tpu.score import di
    from gaussdca_tpu.utils import flops

    # flops.py holds NO private DI constants — it imports the ONE
    # dispatch mirror (di.accounting_plan: lanes, iters, trimmed) and
    # the per-lane matmul count from di.py (the NS-loop trim would
    # otherwise drift the accounting the same way iters did)
    src = inspect.getsource(flops)
    assert "DI_SQRTM_ITERS" not in src
    assert "accounting_plan" in src and "matmuls_per_lane" in src
    assert di.matmuls_per_lane(di.BM_NS_ITERS, trimmed=True) \
        == 3 + (3 * di.BM_NS_ITERS - 3) + 1
    assert di.matmuls_per_lane(di.FALLBACK_NS_ITERS, trimmed=False) \
        == 3 + 3 * di.FALLBACK_NS_ITERS + 1

    # the production core resolves its iteration count through the one
    # knob function (defaults to the constant; GDCA_DI_NS_ITERS
    # overrides at trace time — and the accounting follows)
    sig = inspect.signature(di._di_pairs_bm_minor)
    assert sig.parameters["iters"].default is None
    sig2 = inspect.signature(di._di_pairs_bm)
    assert sig2.parameters["iters"].default is None
    monkeypatch.delenv("GDCA_DI_NS_ITERS", raising=False)
    assert di.bm_ns_iters() == di.BM_NS_ITERS
    monkeypatch.setenv("GDCA_DI_NS_ITERS", "14")
    assert di.bm_ns_iters() == 14
    fl14 = flops.pipeline_flops(100, 400, 21, score="DI")
    monkeypatch.delenv("GDCA_DI_NS_ITERS", raising=False)
    fl20 = flops.pipeline_flops(100, 400, 21, score="DI")
    assert fl14["score"] / fl20["score"] == (
        di.matmuls_per_lane(14, trimmed=True)
        / di.matmuls_per_lane(di.BM_NS_ITERS, trimmed=True))

    # lane planner mirrors the dispatch: the mapped default at N=400
    # computes ~2.05x lanes (RB=128 -> Npd=512, 10 tiles, one
    # 16384-lane strip each = the 163840 documented in _plan_row_block)
    monkeypatch.delenv("GDCA_DI_TILED", raising=False)
    monkeypatch.delenv("GDCA_DI_RB", raising=False)
    N = 400
    P = N * (N - 1) // 2
    lanes_tiled = di.planned_lane_count(N)
    assert lanes_tiled == 10 * 128 * 128 == 163840
    assert 2.0 < lanes_tiled / P < 2.1
    # gathered A/B override is accounted under its own plan
    monkeypatch.setenv("GDCA_DI_TILED", "0")
    lanes_gathered = di.planned_lane_count(N)
    assert P <= lanes_gathered < P + 2 * 128 * (P // 65536 + 1)
    # exact-fit RB shrinks the UNROLLED (A/B-only)
    # lane count...
    monkeypatch.setenv("GDCA_DI_TILED", "unrolled")
    assert di.planned_lane_count(N) == lanes_tiled
    monkeypatch.setenv("GDCA_DI_RB", "exact")
    assert lanes_tiled > di.planned_lane_count(N) >= P
    # ...and the MAPPED path honors it under the single-strip guard
    # (N=400: nb=3, RB=134, 6 tiles of pad128(134^2) lanes)
    monkeypatch.delenv("GDCA_DI_TILED", raising=False)
    lanes_exact = di.planned_lane_count(N)
    assert lanes_exact == 6 * 18048
    assert P <= lanes_exact < lanes_tiled
    monkeypatch.delenv("GDCA_DI_RB", raising=False)
    assert di.planned_lane_count(N) == lanes_tiled
    # integer RB override is honored by the mapped accounting
    monkeypatch.setenv("GDCA_DI_RB", "256")
    assert di.planned_lane_count(N) == 3 * 65536
    monkeypatch.delenv("GDCA_DI_RB", raising=False)
    # non-bm fallback (f64 golden / small P): exact chunk-padded P
    assert di.planned_lane_count(53, bm=False) == 53 * 52 // 2

    # and the DI stage flops scale with the planner's lane count
    fl_tiled = flops.pipeline_flops(100, N, 21, score="DI")
    monkeypatch.setenv("GDCA_DI_TILED", "0")
    fl_gath = flops.pipeline_flops(100, N, 21, score="DI")
    assert fl_tiled["score"] / fl_gath["score"] == (
        lanes_tiled / lanes_gathered)
    per_lane = di.matmuls_per_lane(di.BM_NS_ITERS, trimmed=True) \
        * 2.0 * 20 ** 3
    assert fl_gath["score"] == lanes_gathered * per_lane
    monkeypatch.delenv("GDCA_DI_TILED", raising=False)

    # accounting_plan mirrors the REAL bm gate, not the caller's coarse
    # flag (mesh and small-N runs were
    # billed under the mapped dense-tile trimmed plan they never run):
    # small P (< _BM_MIN_PAIRS: N=100 -> P=4950) executes the gemm
    # scaffold — exact lanes, FALLBACK iters, untrimmed
    lanes, iters, trimmed = di.accounting_plan(100, requested_bm=True)
    assert (lanes, iters, trimmed) == (4950, di.FALLBACK_NS_ITERS, False)
    # mesh runs execute the storage-sharded bodies: gathered-style
    # exact-P slabs even though the single-chip default is mapped
    lanes_sh, iters_sh, trimmed_sh = di.accounting_plan(
        N, requested_bm=True, sharded=True)
    assert lanes_sh == lanes_gathered and trimmed_sh
    assert iters_sh == di.BM_NS_ITERS
    # requested_bm=False (the platform's table picks the gemm scaffold,
    # or f64 / forced fallback): exact chunk-padded lanes, untrimmed
    lanes_f, iters_f, trimmed_f = di.accounting_plan(N, requested_bm=False)
    assert lanes_f == di.planned_lane_count(N, bm=False)
    assert iters_f == di.FALLBACK_NS_ITERS and not trimmed_f
    # and pipeline_flops(sharded=True) bills the sharded plan
    fl_sh = flops.pipeline_flops(100, N, 21, score="DI", sharded=True)
    assert fl_sh["score"] / fl_gath["score"] == 1.0


def test_trace_env_knobs_cover_every_result_knob():
    """Every result-affecting GDCA_* env knob in the package must be in
    api._TRACE_ENV_KNOBS — the ONE list both the AOT executable-cache
    class key and the CLI artifact-cache key fold in. Round-5 review
    finding: GDCA_DI_NS_ITERS / GDCA_SOLVE_{SYRK,RES_PREC} were added
    with neither key extended, so caches served results computed under
    a different iteration count / precision. This scan fails the build
    the next time a knob is added without extending the list."""
    import os
    import re

    import gaussdca_tpu
    from gaussdca_tpu.api import _TRACE_ENV_KNOBS

    # knobs that deliberately do NOT affect results: FORCE_FALLBACK is
    # folded into both keys via cfg.resolve_fallback(); NO_NATIVE picks
    # the parser (token-matrix parity is differential-fuzzed); POD_NPROC
    # configures the test-only pod spawner
    non_result = {"GDCA_FORCE_FALLBACK", "GDCA_NO_NATIVE",
                  "GDCA_POD_NPROC"}
    pkg = os.path.dirname(gaussdca_tpu.__file__)
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    found |= set(re.findall(r"environ(?:\.get)?[(\[]\s*"
                                            r"['\"](GDCA_[A-Z_0-9]+)",
                                            fh.read()))
    assert found, "scan found no knobs — regex rotted?"
    uncovered = found - set(_TRACE_ENV_KNOBS) - non_result
    assert not uncovered, (
        f"result-affecting env knob(s) {sorted(uncovered)} are read by "
        "the package but missing from api._TRACE_ENV_KNOBS — AOT and "
        "artifact caches will serve stale results across settings. Add "
        "them to the list (or to this test's non_result set with a "
        "written rationale).")


def test_output_stem_collisions(tmp_path):
    from gaussdca_tpu.cli import _output_stems
    paths = [str(tmp_path / "a" / "fam.fasta"),
             str(tmp_path / "b" / "fam.fasta"),
             str(tmp_path / "c" / "other.fa"),
             str(tmp_path / "d" / "fam.fasta.gz")]
    stems = _output_stems(paths)
    assert len(set(stems)) == len(stems)
    assert stems[0] == "fam" and stems[2] == "other"
    assert stems[1] != stems[0] and stems[3] not in (stems[0], stems[1])


def test_cache_key_uses_resolved_dtype(tmp_path):
    from gaussdca_tpu.cli import _cache_key
    from gaussdca_tpu.core.config import GDCAConfig
    p = tmp_path / "x.fasta"
    p.write_text(">a\nACDEF\n")
    k32 = _cache_key(str(p), GDCAConfig(dtype="float32"), None)
    k64 = _cache_key(str(p), GDCAConfig(dtype="float64"), None)
    assert k32 != k64


def test_cache_key_tracks_resolved_defaults(tmp_path, monkeypatch):
    """A code-default flip (no env override set) must invalidate
    on-disk artifacts: the key folds in the RESOLVED knob values
    (bm_ns_iters / residual precision / syrk impl), not just the raw
    env strings — which are '' both before and after a release that
    changes a default."""
    from gaussdca_tpu import score
    from gaussdca_tpu.cli import _cache_key
    from gaussdca_tpu.core.config import GDCAConfig
    p = tmp_path / "x.fasta"
    p.write_text(">a\nACDEF\n")
    k_before = _cache_key(str(p), GDCAConfig(), None)
    monkeypatch.setattr(score.di, "BM_NS_ITERS",
                        score.di.BM_NS_ITERS + 1)
    k_after = _cache_key(str(p), GDCAConfig(), None)
    assert k_before != k_after


def test_merge_output(tmp_path, golden_dir):
    import os
    from gaussdca_tpu.cli import main
    small = os.path.join(golden_dir, "small.fasta.gz")
    merged = tmp_path / "new_subdir" / "merged.txt"  # parent must be created
    rc = main([small, small, "-o", str(tmp_path), "--top-k", "5",
               "--quiet", "--merge-output", str(merged),
               "--theta", "0.2"])
    assert rc == 0
    lines = merged.read_text().splitlines()
    assert len(lines) == 10
    fams = {ln.split()[0] for ln in lines}
    assert fams == {"small", "small.2"}
    for ln in lines:
        t = ln.split()
        assert len(t) == 4 and int(t[1]) >= 1 and float(t[3])


def test_run_family_cache_only_missing_artifact(small, tmp_path, capsys):
    """A pod-agreed cache hit whose artifact vanished must NEVER fall
    through to compute (peers skipped the family — the writer entering
    the collective program alone would wedge the pod): nonfatal mode
    records a writer-local emit error and returns None; fatal mode
    raises."""
    from gaussdca_tpu.cli import run_family
    from gaussdca_tpu.core.config import GDCAConfig

    cfg = GDCAConfig()
    cache = tmp_path / "cache"
    cache.mkdir()
    out = run_family(small, cfg, str(tmp_path / "out"), None, str(cache),
                     quiet=False, cache_read=True, cache_only=True,
                     emit_errors_fatal=False)
    assert out is None
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert "artifact missing" in rec["emit_error"]
    # no compute happened: no pipeline timing was recorded
    assert "pipeline" not in rec.get("timings_s", {})

    with pytest.raises(RuntimeError, match="artifact missing"):
        run_family(small, cfg, str(tmp_path / "out"), None, str(cache),
                   quiet=True, cache_read=True, cache_only=True,
                   emit_errors_fatal=True)


def test_di_flops_fallback_accounting():
    """pipeline_flops(bm=False) must account the gemm-scaffold path
    (exact chunk-padded lanes, FALLBACK_NS_ITERS) — f64 golden and
    forced-fallback runs were previously billed under the dense-tile
    bm plan they never execute (round-4 review finding)."""
    from gaussdca_tpu.score import di
    from gaussdca_tpu.utils import flops

    N = 400
    fb = flops.pipeline_flops(100, N, 21, score="DI", bm=False)
    bm = flops.pipeline_flops(100, N, 21, score="DI", bm=True)
    per_fb = (3 + 3 * di.FALLBACK_NS_ITERS + 1) * 2.0 * 20 ** 3
    assert fb["score"] == di.planned_lane_count(N, bm=False) * per_fb
    assert fb["score"] != bm["score"]
    # the constant is the fallback core's actual default
    import inspect
    sig = inspect.signature(di.sqrtm_spd_fixed)
    assert sig.parameters["iters"].default == di.FALLBACK_NS_ITERS


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, 'auto' sets no directory of
    its own (JAX reads the variable itself)."""
    from gaussdca_tpu import cli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cli.compile_cache_dir("auto") is None
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda *a: calls.append(a))
    cli.setup_compile_cache("auto")
    assert calls == []


def test_compile_cache_default_is_in_checkout(monkeypatch):
    """Without the variable, 'auto' is one fixed path inside the
    checkout (never the home directory, a temporary name or a PID)."""
    import os

    from gaussdca_tpu import cli

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cli.compile_cache_dir("auto")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    assert path == os.path.join(repo, ".jax_cache") == \
        cli.DEFAULT_COMPILE_CACHE
    assert cli.compile_cache_dir("auto") == path
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_explicit_and_none(monkeypatch, tmp_path):
    from gaussdca_tpu import cli

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cli.compile_cache_dir("none") is None
    assert cli.compile_cache_dir(str(tmp_path / "x")) == str(tmp_path / "x")
    calls = []
    monkeypatch.setattr("jax.config.update",
                        lambda *a: calls.append(a))
    cli.setup_compile_cache(str(tmp_path / "x"))
    assert ("jax_compilation_cache_dir", str(tmp_path / "x")) in calls
    assert (tmp_path / "x").is_dir()
