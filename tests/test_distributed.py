"""Multi-process rendezvous smoke test.

The reference is single-process by design (SURVEY.md §5: no MPI/NCCL
anywhere); our multi-host story is jax.distributed.initialize + the same
device mesh (parallel/sharding.py::init_distributed).  This test actually
exercises the rendezvous: two OS processes, each owning one CPU device,
initialize against a shared coordinator, agree on the global topology,
and run a cross-process all-gather.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import jax

# Rendezvous MUST precede importing simd_raytracer (module-level jnp
# constants would initialize the XLA backend first) — the same ordering
# init_distributed's docstring requires on real pods.
coord, pid = sys.argv[1], int(sys.argv[2])
jax.distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2, jax.device_count()
assert len(jax.local_devices()) == 1

import jax.numpy as jnp
from jax.experimental import multihost_utils
from simd_raytracer.parallel.sharding import make_mesh

# Cross-process collective: every process contributes its id; both must
# see [0, 1] — proof the rendezvous produced a working global mesh.
got = multihost_utils.process_allgather(jnp.int32(pid))
assert list(got) == [0, 1], got
mesh = make_mesh()   # global 2-device mesh spanning both processes
assert mesh.devices.size == 2, mesh
print("OK", pid)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_rendezvous(tmp_path):
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    # One real CPU device per process (override the suite's 8-device sim).
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_PROCESSES", None)

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=os.path.dirname(os.path.dirname(__file__)))
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"OK {pid}" in out
