"""Warm-batch executable cache (--warm-compile): semantics + parity.

The AOT path must be invisible in the results — same program jit would
dispatch, called directly (utils/exe_cache.py). Its latency win is a
measurement on the card (not yet taken); these tests pin correctness.
"""

import os

import numpy as np
import pytest


def test_executable_cache_semantics():
    from gaussdca_tpu.utils.exe_cache import ExecutableCache

    calls = []

    def mk(tag):
        def thunk():
            calls.append(tag)
            return f"exe-{tag}"
        return thunk

    c = ExecutableCache()
    # get on a miss compiles inline, once
    assert c.get("a", mk("a")) == "exe-a"
    assert c.get("a", mk("a2")) == "exe-a"
    assert calls == ["a"]

    # warm schedules in the background; get returns the same object
    c.warm("b", mk("b"))
    c.warm("b", mk("b2"))          # second warm is a no-op
    assert c.get("b", mk("b3")) == "exe-b"
    assert calls.count("b") == 1 and "b2" not in calls
    assert len(c) == 2

    # a failing thunk poisons only its own attempt: the entry is
    # dropped so a later get can retry
    def boom():
        calls.append("boom")
        raise RuntimeError("transient")

    c.warm("c", boom)
    with pytest.raises(RuntimeError):
        c.get("c", boom)
    assert c.get("c", mk("c")) == "exe-c"
    c.shutdown()


@pytest.mark.parametrize("bucketed", [False, True])
def test_warm_compile_parity(golden_dir, bucketed):
    """gdca_from_msa through the AOT executable must be bitwise-equal
    to the jit dispatch, warmed or not, bucketed or not."""
    import jax.numpy as jnp
    from gaussdca_tpu.api import gdca_from_msa, warm_compile
    from gaussdca_tpu.core.config import GDCAConfig
    from gaussdca_tpu.io import fasta
    from gaussdca_tpu.utils.exe_cache import ExecutableCache

    msa = fasta.read_fasta_alignment(
        os.path.join(golden_dir, "small.fasta.gz"), 0.9)
    kw = dict(m_bucket=256, n_bucket=32) if bucketed else {}
    cfg = GDCAConfig(dtype="float64", **kw)

    cache = ExecutableCache()
    assert warm_compile(cache, msa, cfg)
    r_aot = gdca_from_msa(msa, cfg, exe_cache=cache)
    r_jit = gdca_from_msa(msa, cfg)
    assert list(r_aot.ranking) == list(r_jit.ranking)
    assert (r_aot.theta, r_aot.meff) == (r_jit.theta, r_jit.meff)
    # one executable per shape class; a cold get also works (no warm)
    assert len(cache) == 1
    cold = ExecutableCache()
    r_cold = gdca_from_msa(msa, cfg, exe_cache=cold)
    assert list(r_cold.ranking) == list(r_jit.ranking)
    cache.shutdown()
    cold.shutdown()


def test_cli_warm_compile_batch_identical(tmp_path, golden_dir):
    """--warm-compile across a 2-class batch: outputs byte-identical to
    the plain run; classes are warmed ahead via the prefetch callback."""
    from gaussdca_tpu.cli import main

    small = os.path.join(golden_dir, "small.fasta.gz")
    # two shape classes: the golden family + a synthetic wider one
    rng = np.random.default_rng(3)
    letters = "ACDEFGHIKLMNPQRSTVWY-"
    rows = rng.integers(0, 21, size=(24, 70))
    fam2 = tmp_path / "fam2.fasta"
    fam2.write_text("".join(
        f">s{m}\n{''.join(letters[c] for c in rows[m])}\n"
        for m in range(24)))

    out_a = tmp_path / "a"
    out_b = tmp_path / "b"
    base = [small, str(fam2), "--dtype", "float64",
            "--compile-cache", "none", "--quiet"]
    assert main(base + ["-o", str(out_a), "--warm-compile"]) == 0
    assert main(base + ["-o", str(out_b)]) == 0
    for stem in ("small", "fam2"):
        a = (out_a / f"{stem}.rank.txt").read_text()
        b = (out_b / f"{stem}.rank.txt").read_text()
        assert a == b and a


def test_bucket_shape_matches_bucket_pad():
    """_bucket_shape (warm_compile's zero-copy shape arithmetic) must
    agree with _bucket_pad on every padding regime."""
    from gaussdca_tpu.api import _bucket_pad, _bucket_shape
    from gaussdca_tpu.core.config import GDCAConfig

    for (M, N), mb, nb in (((106, 53), 256, 32), ((256, 64), 256, 32),
                           ((106, 53), 0, 0), ((5, 7), 4, 4),
                           ((4, 8), 4, 4), ((257, 33), 256, 32)):
        cfg = GDCAConfig(m_bucket=mb, n_bucket=nb)
        padded, m_true, n_true = _bucket_pad(
            np.zeros((M, N), np.uint8), cfg)
        shape, has_m, has_n = _bucket_shape((M, N), cfg)
        assert padded.shape == shape, (M, N, mb, nb)
        assert (m_true is not None) == has_m
        assert (n_true is not None) == has_n
