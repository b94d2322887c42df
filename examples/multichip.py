"""Multi-card usage: one entry point that scales (run on any host).

On a host with several GPUs, run with GDCA_EXAMPLE_GPUS=1 — `mesh="auto"`
lays a (data, model) mesh over every visible card. By default this
script demonstrates on a virtual 8-device CPU mesh (no card required):

    python examples/multichip.py path/to/family.fasta.gz
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
import jax

# default: demonstrate on the virtual CPU mesh (checking the backend
# would itself initialize it). On a GPU host run with
# GDCA_EXAMPLE_GPUS=1 to use the cards instead.
if os.environ.get("GDCA_EXAMPLE_GPUS", "") != "1":
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))
import gaussdca_tpu as g

path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(__file__), "..", "tests", "data", "small.fasta.gz")

# single-device and sharded runs of the same family, same entry point
r1 = g.gdca(path)
r8 = g.gdca(path, mesh="auto")          # or mesh=(4, 2), or a jax Mesh

print(f"devices: {jax.device_count()}  M={r8.M} N={r8.N} q={r8.q} "
      f"theta={r8.theta:.4f} Meff={r8.meff:.2f}")
print("top-5 (sharded):", [(i, j, round(s, 4)) for i, j, s in r8[:5]])
# f32 reductions run in a different order on the mesh: scores agree
# to summation-order noise (~1e-4 relative through the f32 solve)
agree = all(abs(a[2] - b[2]) < 5e-4 * max(1.0, abs(a[2]))
            for a, b in zip(sorted(r1.ranking), sorted(r8.ranking)))
print("single-device == sharded (to f32 summation order):", agree)
