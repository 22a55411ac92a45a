"""The port's multi-host entry (``dexnerf_tpu_torch/parallel/multihost.py``)
beside the JAX package's (``tests/test_multihost.py``): two real processes
join one gloo group on the CPU, with explicit arguments, through torch's
``env://`` variables and through a SLURM launch's, then run one
``all_reduce`` over ``global_mesh()``; the no-op outside a cluster and at
one process; the single-process helpers; the refusals. Every worker has a
timeout.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from dexnerf_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120

_WORKER = r"""
import sys
import torch

from dexnerf_tpu_torch.parallel import multihost
from dexnerf_tpu_torch.parallel.mesh import all_reduce_sum

mode, addr, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
if mode == "explicit":
    started = multihost.initialize(coordinator_address=addr, num_processes=2, process_id=pid,
                                   device_type="cpu")
else:
    started = multihost.initialize(device_type="cpu")
assert started, "initialize() returned False in a cluster"
assert multihost.process_count() == 2
assert multihost.is_primary() == (pid == 0)
assert multihost.local_device_count() >= 1
mesh = multihost.global_mesh()
assert (mesh.rank, mesh.world_size, mesh.backend, mesh.device.type) == (pid, 2, "gloo", "cpu")
got = all_reduce_sum(mesh, torch.tensor([pid + 1.0, 10.0 * pid]))
assert got.tolist() == [3.0, 10.0], got
multihost.shutdown()
assert multihost.process_count() == 1
print("WORKER-OK", pid)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k not in multihost._CLUSTER_ENV_VARS
           and k not in multihost._RANK_VARS + multihost._WORLD_VARS + multihost._LOCAL_RANK_VARS}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("mode", ["explicit", "env", "slurm"])
def test_two_process_initialize_all_reduce(mode):
    """Two processes join one gloo group, by ``tcp://`` with explicit
    arguments (JAX's ``coordinator_address``/``num_processes``/
    ``process_id``), by torch's ``env://`` variables, or by a SLURM launch's
    rank and task count with the address in ``MASTER_ADDR``/``MASTER_PORT``;
    each sees two processes, rank 0 alone primary, a two-rank
    ``global_mesh()`` on gloo, and one ``all_reduce`` sums both."""
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    procs = []
    for pid in (0, 1):
        env = _clean_env()
        if mode == "env":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(pid),
                       WORLD_SIZE="2")
        elif mode == "slurm":
            env.update(SLURM_JOB_ID="1", SLURM_PROCID=str(pid), SLURM_NTASKS="2",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, mode, addr, str(pid)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail("multihost worker timed out")
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER-OK {pid}" in out


def test_initialize_noop_outside_cluster(monkeypatch):
    """No arguments and no cluster environment, or one process: a
    single-process no-op in both packages."""
    from dexnerf_tpu.parallel import multihost as j_multihost

    for v in set(multihost._CLUSTER_ENV_VARS) | set(j_multihost._CLUSTER_ENV_VARS):
        monkeypatch.delenv(v, raising=False)
    assert not multihost.in_cluster_env() and not j_multihost.in_cluster_env()
    for pkg in (multihost, j_multihost):
        assert pkg.initialize() is False
        assert pkg.initialize(num_processes=1) is False
    assert not torch.distributed.is_initialized()


def test_single_process_helpers():
    """Outside a group: primary, one process, at least one local device and
    a one-rank global mesh, as JAX's helpers report for one process."""
    from dexnerf_tpu.parallel import multihost as j_multihost

    assert multihost.is_primary() == j_multihost.is_primary() is True
    assert multihost.process_count() == j_multihost.process_count() == 1
    assert multihost.local_device_count() >= 1
    mesh = multihost.global_mesh()
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    multihost.shutdown()  # safe when nothing runs


@pytest.mark.parametrize("var", ["MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                                 "SLURM_JOB_ID", "OMPI_MCA_orte_hnp_uri"])
def test_in_cluster_env(monkeypatch, var):
    """Each launcher variable alone marks a cluster; the two that JAX also
    reads (SLURM, OpenMPI) mark one in both packages."""
    from dexnerf_tpu.parallel import multihost as j_multihost

    for v in set(multihost._CLUSTER_ENV_VARS) | set(j_multihost._CLUSTER_ENV_VARS):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, "1")
    assert multihost.in_cluster_env()
    if var in j_multihost._CLUSTER_ENV_VARS:
        assert j_multihost.in_cluster_env()


@pytest.mark.parametrize("case", ["no-card", "no-rank", "device"])
def test_initialize_refusals(monkeypatch, case):
    """NCCL is asked for with no card visible (no silent switch to gloo); a
    cluster environment without a rank or world size; an unknown device
    type. Nothing is started."""
    for v in multihost._CLUSTER_ENV_VARS + multihost._RANK_VARS + multihost._WORLD_VARS:
        monkeypatch.delenv(v, raising=False)
    if case == "no-card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA card is visible"):
            multihost.initialize(coordinator_address="127.0.0.1:1", num_processes=2,
                                 process_id=0)
    elif case == "no-rank":
        monkeypatch.setenv("SLURM_JOB_ID", "1")
        with pytest.raises(ValueError, match="the rank and the world size are unknown"):
            multihost.initialize(device_type="cpu")
    else:
        with pytest.raises(ValueError, match="unknown device type 'tpu'"):
            multihost.initialize(num_processes=2, process_id=0, device_type="tpu")
    assert not torch.distributed.is_initialized()
