"""Multi-process pod-spawn harness (dev/test tooling, stdlib only).

ONE copy of the machinery that launches an N-process CPU "pod" (the
multi-host layout: one OS process per host, gloo collectives over a
coordinator), shared by the driver's pod dryrun
(``__graft_entry__.dryrun_pod``) and the 2-process distributed tests
(``tests/test_distributed.py``). Keeping it in one place means a fix to
the port pick, the gloo/env wiring, or the timeout/kill handling cannot
silently miss one of the copies.

The child script is ``CHILD_PRELUDE + body``: the prelude pins the CPU
platform BEFORE any backend init (the children are CPU-virtual by
design, even on a machine with a card), selects gloo cross-process CPU
collectives, and wires the coordinator env vars from argv; the body
does the actual work with ``port``/``pid`` (strings) in scope.
"""

import os
import socket
import subprocess
import sys
import tempfile

CHILD_PRELUDE = r"""
import os, sys
import jax

# before any backend init: CPU platform and gloo cross-process
# collectives for the multi-process CPU client
jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:
    pass

port, pid = sys.argv[1], sys.argv[2]
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = os.environ.get("GDCA_POD_NPROC", "2")
os.environ["JAX_PROCESS_ID"] = pid
"""


def free_port() -> int:
    """Pick a free localhost port for the pod coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def spawn_pod(body: str, *, n_processes: int = 2,
              devices_per_process: int = 4,
              args_per_proc=None, timeout: float = 600,
              script_dir: str = None, prelude: str = CHILD_PRELUDE):
    """Run ``prelude + body`` in ``n_processes`` real processes.

    Each child gets argv ``[script, port, process_id, *extra]`` with
    ``extra = args_per_proc(process_id)`` (default none), and an env
    with the CPU platform pinned, ``devices_per_process`` virtual CPU
    devices (1 = jax's default: XLA_FLAGS is removed), and the repo on
    PYTHONPATH. Returns ``[(returncode, stdout, stderr)]`` in process
    order; on timeout every child is killed and TimeoutExpired raised.
    """
    port = free_port()
    root = repo_root()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["GDCA_POD_NPROC"] = str(n_processes)
    if devices_per_process and devices_per_process > 1:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices_per_process}")
    else:
        env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")

    own_td = None
    if script_dir is None:
        own_td = tempfile.TemporaryDirectory()
        script_dir = own_td.name
    try:
        script = os.path.join(str(script_dir), "pod_child.py")
        with open(script, "w") as fh:
            fh.write(prelude + body)
        procs = [subprocess.Popen(
            [sys.executable, script, str(port), str(i)]
            + ([] if args_per_proc is None
               else [str(a) for a in args_per_proc(i)]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=root) for i in range(n_processes)]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append((p.returncode, out, err))
        return outs
    finally:
        if own_td is not None:
            own_td.cleanup()
