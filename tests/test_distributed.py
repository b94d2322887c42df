"""Multi-process (multi-host analog) tests with two REAL processes.

The reference has no multi-process mode at all (SURVEY.md 2.9). Three
levels are exercised here, all with real OS processes on the CPU
backend (the 2-host analog of a one-process-per-host layout):

1. wiring: ``parallel/mesh.init_distributed`` + round-robin family
   sharding + one psum over a 2-device global mesh,
2. ``--distributed`` CLI: families round-robined across processes, each
   running its own independent program,
3. the POD execution model (``--distributed --mesh``): both processes
   jointly execute ONE sharded program per family over a global
   8-device mesh (2 processes x 4 virtual devices, gloo collectives),
   golden-checked against the reference output and against the
   single-process 8-device mesh run.
"""

import os
import subprocess
import sys

import pytest

from gaussdca_tpu.parallel.podspawn import spawn_pod

# children are BODIES — podspawn.CHILD_PRELUDE supplies the CPU pin,
# gloo selection, and coordinator env wiring, and leaves the string
# variables ``port`` and ``pid`` in scope
_CHILD = r"""
pid = int(pid)

from gaussdca_tpu.parallel import mesh as meshlib

# the wiring test exercises the EXPLICIT-argument path (not the env
# vars the prelude also set)
idx, cnt = meshlib.init_distributed(coordinator=f"localhost:{port}",
                                    num_processes=2, process_id=pid)
assert (idx, cnt) == (pid, 2), (idx, cnt)

fams = meshlib.shard_families(["a", "b", "c", "d", "e"], idx, cnt)
want = ["a", "c", "e"] if pid == 0 else ["b", "d"]
assert fams == want, (fams, want)

print(f"WIRING-OK p{pid} devices={jax.device_count()}", flush=True)

try:
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.device_count() == 2
    m = meshlib.make_mesh(2, shape=(2, 1))
    sh = NamedSharding(m, P(("data", "model")))
    # each process contributes its own row of the global array
    local = np.asarray([10.0 * (pid + 1)], dtype=np.float32)
    garr = jax.make_array_from_process_local_data(sh, local, (2,))
    total = jax.jit(lambda x: jnp.sum(x),
                    out_shardings=NamedSharding(m, P()))(garr)
    assert float(total) == 30.0, float(total)
    print(f"COLLECTIVE-OK p{pid} total={float(total)}", flush=True)
except Exception as e:  # missing gloo/mpi CPU-collective support
    print(f"COLLECTIVE-UNSUPPORTED p{pid}: {type(e).__name__}: {e}",
          flush=True)
"""


def test_two_process_distributed_wiring(tmp_path):
    # default 1 CPU device per process
    outs = spawn_pod(_CHILD, devices_per_process=1, timeout=240,
                     script_dir=tmp_path)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} failed:\n{out}\n{err}"
        assert f"WIRING-OK p{i}" in out, (out, err)
        assert (f"COLLECTIVE-OK p{i}" in out
                or "COLLECTIVE-UNSUPPORTED" in out), (out, err)
    # the collective outcome must agree across processes
    ok = ["COLLECTIVE-OK" in o for _, o, _ in outs]
    assert all(ok) or not any(ok)


_CLI_CHILD = r"""
out_dir, merge = sys.argv[3:5]
inputs = sys.argv[5:]

from gaussdca_tpu.cli import main

rc = main(inputs + ["-o", out_dir, "--distributed", "--quiet",
                    "--merge-output", merge,
                    "--m-bucket", "0", "--n-bucket", "0",
                    "--compile-cache", "none", "--top-k", "5",
                    "--min-separation", "2"])
print(f"CLI-RC p{pid} {rc}", flush=True)
"""


def test_cli_distributed_two_process(tmp_path):
    """End-to-end --distributed CLI across two real processes: families
    round-robin, per-process merge shard files (the ADVICE r1 fix for
    the merge-output truncation race), all outputs present."""
    import numpy as np

    # four tiny synthetic families
    rng = np.random.default_rng(0)
    inputs = []
    for k in range(4):
        lines = []
        for m in range(30):
            seq = "".join("ACDEFGHIKLMNPQRSTVWY-"[c] for c in
                          rng.integers(0, 21, size=12))
            lines.append(f">s{m}\n{seq}\n")
        p = tmp_path / f"fam{k}.fasta"
        p.write_text("".join(lines))
        inputs.append(str(p))

    out_dir = tmp_path / "out"
    merge = str(tmp_path / "merged.txt")
    outs = spawn_pod(_CLI_CHILD, devices_per_process=1, timeout=240,
                     script_dir=tmp_path,
                     args_per_proc=lambda i: [str(out_dir), merge]
                     + inputs)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} failed:\n{out}\n{err}"
        assert f"CLI-RC p{i} 0" in out, (out, err)
    # all four families produced rankings (2 per process)
    for k in range(4):
        f = out_dir / f"fam{k}.rank.txt"
        assert f.exists(), sorted(os.listdir(out_dir))
        assert len(f.read_text().splitlines()) == 5
    # per-process merge shards, no shared-file truncation
    part0 = tmp_path / "merged.txt.part0of2"
    part1 = tmp_path / "merged.txt.part1of2"
    assert part0.exists() and part1.exists()
    assert not (tmp_path / "merged.txt").exists()
    fams0 = {line.split()[0] for line in part0.read_text().splitlines()}
    fams1 = {line.split()[0] for line in part1.read_text().splitlines()}
    assert fams0 == {"fam0", "fam2"} and fams1 == {"fam1", "fam3"}


_POD_CHILD = r"""
jax.config.update("jax_enable_x64", True)  # before any computation

out_dir, cache_dir = sys.argv[3:5]
inputs = sys.argv[5:]

from gaussdca_tpu.cli import main

rc = main(inputs + ["-o", out_dir, "--distributed", "--mesh", "auto",
                    "--dtype", "float64", "--cache-dir", cache_dir,
                    "--m-bucket", "0", "--n-bucket", "0",
                    "--compile-cache", "none"])
print(f"POD-RC p{pid} {rc} ndev={jax.device_count()}", flush=True)
"""


def _spawn_pod_cli(tmp_path, args_per_proc, timeout=300):
    # 4 virtual devices per process -> an 8-device global mesh
    return spawn_pod(_POD_CHILD, devices_per_process=4, timeout=timeout,
                     script_dir=tmp_path, args_per_proc=args_per_proc)


def test_cli_pod_mesh_two_process(tmp_path, golden_dir):
    """The pod execution model end-to-end: 2 processes x 4 virtual
    devices jointly run ONE sharded program (gloo collectives over the
    8-device global mesh) on the golden small alignment, in f64.

    Asserts (a) the pod run reproduces the reference's golden frob
    ranking, (b) it matches the single-process 8-device mesh run to
    1e-9, (c) only process 0 writes outputs, and (d) a rerun hits the
    artifact cache with the pod-agreed (broadcast) skip decision.
    """
    import numpy as np

    small = os.path.join(golden_dir, "small.fasta.gz")
    out_dirs = [tmp_path / f"out{i}" for i in range(2)]
    cache = tmp_path / "cache"

    outs = _spawn_pod_cli(
        tmp_path, lambda i: [str(out_dirs[i]), str(cache), small])
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} failed:\n{out}\n{err}"
        assert f"POD-RC p{i} 0 ndev=8" in out, (out, err)

    # (c) process 0 is the writer; process 1 emits nothing
    rank0 = out_dirs[0] / "small.rank.txt"
    assert rank0.exists()
    assert not (out_dirs[1] / "small.rank.txt").exists()

    # (a) golden frob parity (f64 exact-mode comparison semantics)
    from tests.test_golden import todict
    got = todict(rank0.read_text())
    want = todict(
        open(os.path.join(golden_dir, "small.FNRout.txt")).read())
    assert set(got) == set(want)
    g = np.array([got[k] for k in sorted(want)])
    w = np.array([want[k] for k in sorted(want)])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)

    # (b) pod run == single-process 8-device mesh run to 1e-9
    from gaussdca_tpu import gdca
    from gaussdca_tpu.score.rank import format_rank
    r1 = gdca(small, mesh="auto", dtype="float64")
    ref = todict(format_rank(r1.ranking))
    assert set(got) == set(ref)
    a = np.array([got[k] for k in sorted(ref)])
    b = np.array([ref[k] for k in sorted(ref)])
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)

    # (d) rerun: pod-agreed artifact-cache skip (broadcast decision)
    outs2 = _spawn_pod_cli(
        tmp_path, lambda i: [str(out_dirs[i]), str(cache), small])
    for i, (rc, out, err) in enumerate(outs2):
        assert rc == 0, f"rerun process {i} failed:\n{out}\n{err}"
    assert '"cached": true' in outs2[0][2], outs2[0][2]
    assert todict(rank0.read_text()) == got


def test_cli_pod_mesh_writer_setup_abort(tmp_path, golden_dir):
    """A writer-local setup failure (unwritable output dir on process
    0) must abort the WHOLE pod before any compute — not kill process 0
    while the peers enter the first family's collective program (a
    mismatched-collectives wedge with no timeout). Both processes exit
    rc=2 via the broadcast setup decision."""
    small = os.path.join(golden_dir, "small.fasta.gz")
    # output "dir" is an existing FILE -> os.makedirs raises on the
    # writer; the test shares one FS, but only process 0 attempts it
    blocked = tmp_path / "blocked_out"
    blocked.write_text("not a directory")
    cache = tmp_path / "cache"

    outs = _spawn_pod_cli(
        tmp_path, lambda i: [str(blocked), str(cache), small])
    for i, (rc, out, err) in enumerate(outs):
        # the child wrapper always exits 0; main()'s return code is in
        # the POD-RC marker
        assert rc == 0, f"process {i} crashed:\n{out}\n{err}"
        assert f"POD-RC p{i} 2" in out, (out, err)
        assert '"pod_abort": true' in err, err
        assert '"setup": true' in err, err


def test_run_family_emit_errors_nonfatal(tmp_path, golden_dir):
    """run_family(emit_errors_fatal=False): a post-program writer I/O
    failure is recorded and reported as None instead of raised (the
    pod-mesh lockstep requirement)."""
    from gaussdca_tpu.cli import run_family
    from gaussdca_tpu.core.config import GDCAConfig

    small = os.path.join(golden_dir, "small.fasta.gz")
    blocked = tmp_path / "blocked_out"
    blocked.write_text("not a directory")
    cfg = GDCAConfig(dtype="float64")
    out = run_family(small, cfg, str(blocked), None, None, quiet=True,
                     emit=False)
    assert out is None  # non-writer path: no writes attempted at all
    out = run_family(small, cfg, str(blocked), None, None, quiet=True,
                     emit_errors_fatal=False)
    assert out is None
    with pytest.raises(OSError):
        run_family(small, cfg, str(blocked), None, None, quiet=True)


def test_dryrun_multichip_self_pins_cpu_platform(tmp_path):
    """The driver's multichip dryrun must not depend on env vars: on a
    machine with a card, JAX would otherwise initialize the card's
    backend. __graft_entry__._force_cpu_platform pins the CPU platform
    (and injects the virtual-device flag) before any backend exists —
    so a bare interpreter with NO jax env vars must complete the
    8-device dryrun."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME", "XLA_FLAGS")}
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla_cache")
    out = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as e; e.dryrun_multichip(8)"],
        capture_output=True, text=True, env=env, cwd=repo_root,
        timeout=420)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "dryrun_multichip: OK on 8 devices" in out.stdout, out.stdout


_POD_DI_CHILD = r"""
jax.config.update("jax_enable_x64", True)  # before any computation

out_dir, cache_dir = sys.argv[3:5]
inputs = sys.argv[5:]

from gaussdca_tpu.cli import main

rc = main(inputs + ["-o", out_dir, "--distributed", "--mesh", "auto",
                    "--score", "DI", "--dtype", "float64",
                    "--cache-dir", cache_dir,
                    "--m-bucket", "0", "--n-bucket", "0",
                    "--compile-cache", "none"])
print(f"POD-RC p{pid} {rc} ndev={jax.device_count()}", flush=True)
"""


def test_cli_pod_mesh_storage_sharded_di(tmp_path):
    """The at-scale pod configuration across 2 REAL processes: gloo pod
    mesh + storage-sharded solve (solve/distributed.spd_inverse_dist) +
    local-gather DI (parallel/sharded._di_sharded_local), all engaged
    by PRODUCTION gates (no monkeypatching): q=21, N=205 -> Ns=4100 >=
    solve_min_dim=4096. Round-3 verdict weak #5: this composition — the
    configuration a real pod would run at scale — previously executed
    only single-process (test_composed_scale) or below the gate (the
    golden pod test at Ns=1060).

    Asserts the pod ranking matches the single-process 8-device mesh
    run (same global program, gloo vs local collectives), and that the
    mesh run matches the replicated single-chip pipeline to 1e-9
    relative on the RAW f64 scores.
    """
    import numpy as np
    from gaussdca_tpu.core.config import GDCAConfig

    q, N, M = 21, 205, 48
    cfg = GDCAConfig()
    assert N * (q - 1) >= cfg.solve_min_dim   # storage-sharded engages

    rng = np.random.default_rng(77)
    letters = "ACDEFGHIKLMNPQRSTVWY-"
    # correlated rows (prototype + mutations) so C has realistic cond
    base = rng.integers(0, 21, size=(6, N))
    rows = base[rng.integers(0, 6, size=M)]
    mut = rng.random((M, N)) < 0.3
    rows = np.where(mut, rng.integers(0, 21, size=(M, N)), rows)
    fam = tmp_path / "deepfam.fasta"
    fam.write_text("".join(
        f">s{m}\n{''.join(letters[c] for c in rows[m])}\n"
        for m in range(M)))

    out_dirs = [tmp_path / f"out{i}" for i in range(2)]
    cache = tmp_path / "cache"
    outs = spawn_pod(_POD_DI_CHILD, devices_per_process=4, timeout=900,
                     script_dir=tmp_path,
                     args_per_proc=lambda i: [str(out_dirs[i]),
                                              str(cache), str(fam)])
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} failed:\n{out}\n{err}"
        assert f"POD-RC p{i} 0 ndev=8" in out, (out, err)

    rank0 = out_dirs[0] / "deepfam.rank.txt"
    assert rank0.exists()
    assert not (out_dirs[1] / "deepfam.rank.txt").exists()

    from tests.test_golden import todict
    from gaussdca_tpu import gdca
    from gaussdca_tpu.score.rank import format_rank

    got = todict(rank0.read_text())

    # single-process 8-device mesh: the same sharded program the pod
    # ran, with local instead of gloo collectives
    r_mesh = gdca(str(fam), score="DI", dtype="float64", mesh="auto")
    mesh_fmt = todict(format_rank(r_mesh.ranking))
    assert set(got) == set(mesh_fmt)
    keys = sorted(got)
    g = np.array([got[k] for k in keys])
    a = np.array([mesh_fmt[k] for k in keys])
    np.testing.assert_allclose(g, a, rtol=1e-9, atol=1e-12)

    # replicated single-chip pipeline (spd_inverse + gathered DI) vs
    # the mesh run, compared on RAW f64 scores (no %e formatting)
    r_one = gdca(str(fam), score="DI", dtype="float64")
    mesh_raw = {(i, j): v for i, j, v in r_mesh.ranking}
    one_raw = {(i, j): v for i, j, v in r_one.ranking}
    assert set(mesh_raw) == set(one_raw)
    pk = sorted(one_raw)
    mr = np.array([mesh_raw[k] for k in pk])
    onr = np.array([one_raw[k] for k in pk])
    scale = np.abs(onr).max()
    assert np.abs(mr - onr).max() / scale < 1e-9
