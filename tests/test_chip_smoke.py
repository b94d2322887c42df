"""chip_smoke.py off the card: it must refuse to run and print no result.

The script checks the system on an NVIDIA card; here (the CPU backend)
it has to exit non-zero without its final ``{"ok": true, ...}`` line,
both in a checkout and as a lone file without the package beside it.
"""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script_dir, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run(REPO, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs 1 GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_synth_family_shape_and_planted_pairs():
    sys.path.insert(0, REPO)
    import chip_smoke

    Z = chip_smoke.synth_family(300, 40, n_founders=8, n_pairs=3, seed=0)
    assert Z.shape == (300, 40) and Z.min() >= 1 and Z.max() <= 21
    assert Z.dtype.itemsize == 1


def test_write_fasta_roundtrip(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke
    from gaussdca_tpu.io import fasta

    Z = chip_smoke.synth_family(50, 17, n_founders=4, seed=3)
    path = str(tmp_path / "f.fasta.gz")
    chip_smoke.write_fasta_gz(path, Z)
    msa = fasta.read_fasta_alignment(path, 1.0)
    assert msa.tokens.shape == (50, 17)
    # the letter table maps tokens 1..21 back onto the parser's states
    assert len({tuple(r) for r in msa.tokens}) == len({tuple(r) for r in Z})
