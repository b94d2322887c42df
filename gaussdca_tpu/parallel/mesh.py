"""Device mesh construction and sharding helpers.

The reference's only parallelism is shared-memory Julia threading
(/root/reference/README.md:92-94); the scale-out design here is new
(SURVEY.md section 2.9): a 2-D ``(data, model)`` mesh where

- ``data`` shards the sequence axis M (distance tiles, weights, and the
  frequency-matmul contraction — merged by XLA-inserted psums),
- ``model`` shards the N*s statistical dimension (frequency/covariance
  rows, score rows) and, later, the blocked covariance solve.

Collectives are never written by hand: shardings are declared via
NamedSharding / sharding constraints under jit and GSPMD inserts
all-gathers/reduce-scatters (NCCL over NVLink between the cards of
one host).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into (dp, tp) with tp the largest power-of-two <= sqrt-ish
    divisor — a balanced default when the caller doesn't specify shape."""
    tp = 1
    while tp * 2 <= n and n % (tp * 2) == 0 and tp * 2 <= 4:
        tp *= 2
    return n // tp, tp


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` devices."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} visible")
        devs = devs[:n_devices]
    n = len(devs)
    dp, tp = shape if shape is not None else _factor2(n)
    if dp * tp != n:
        raise ValueError(f"mesh shape {dp}x{tp} != device count {n}")
    return Mesh(np.asarray(devs).reshape(dp, tp), (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (sequences) split over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS, None))


def model_sharding(mesh: Mesh) -> NamedSharding:
    """Rows (statistical dimension) split over the model axis."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     force: bool = False) -> Tuple[int, int]:
    """Initialize multi-host JAX.

    Call once per host before building a mesh; afterwards
    ``jax.devices()`` spans the pod slice and the (data, model) mesh laid
    over it rides NVLink/NCCL within a host and the network across hosts.
    Arguments fall
    back to the ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` env vars, then to ``jax.distributed.initialize``'s
    own cluster auto-detection (SLURM, ...).

    ``force=True`` (what the CLI's ``--distributed`` passes) initializes
    unconditionally and lets ``jax.distributed.initialize`` fail loudly
    when no cluster configuration can be resolved — silently running
    single-process would contradict what the user asked for. Without
    ``force``, initialization happens only when a coordinator or a
    process count > 1 is actually configured (no-op single-process path).
    Returns (process_index, process_count).
    """
    import os

    coordinator = coordinator or os.environ.get(
        "JAX_COORDINATOR_ADDRESS") or None
    if num_processes is None:
        env_np = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env_np) if env_np else None
    if process_id is None:
        env_pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env_pid) if env_pid else None
    if force or coordinator or (num_processes is not None
                                and num_processes > 1):
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id)
    return jax.process_index(), jax.process_count()


def shard_families(paths: Sequence[str],
                   process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> list:
    """Round-robin family assignment for multi-host batch runs.

    The batch pipeline is embarrassingly parallel at the family level
    (each MSA is independent); host p of P takes families p, p+P, ...
    """
    p = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    return [f for k, f in enumerate(paths) if k % n == p]
