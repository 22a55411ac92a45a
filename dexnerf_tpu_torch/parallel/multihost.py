"""Multi-host (multi-process) entry over ``torch.distributed``.

Counterpart of ``dexnerf_tpu/parallel/multihost.py``. JAX starts its
distributed runtime once per host and ``shard_map``s over every chip of
the slice; the port runs one process a device (``parallel.mesh``), so a
multi-host run is one process group over every card of every host, each
process joined to it here:

    from dexnerf_tpu_torch.parallel import multihost
    multihost.initialize()          # reads the cluster's environment (or pass args)
    mesh = multihost.global_mesh()  # this rank's Mesh over every rank
    ...build the store and make_parallel_train_step(mesh, ...) as on one host...

The environment contract is torch's ``env://`` (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) in place of JAX's coordinator
variables; a SLURM or OpenMPI launch (``SLURM_JOB_ID``,
``OMPI_MCA_orte_hnp_uri``) gives the rank and world size through its own
variables when ``RANK``/``WORLD_SIZE`` are unset. The backend is NCCL
between cards and gloo on the CPU, never the one in place of the other.
Each host builds the same replicated ray store; the per-rank draws of
``parallel.sharding`` give every rank its own rays.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from dexnerf_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, Mesh

# Variables whose presence means a cluster launcher (torch's env://,
# SLURM, OpenMPI) configured this process
_CLUSTER_ENV_VARS = (
    "MASTER_ADDR",
    "MASTER_PORT",
    "RANK",
    "WORLD_SIZE",
    "SLURM_JOB_ID",
    "OMPI_MCA_orte_hnp_uri",
)
# where a launcher that is not torch's own puts the rank, the world size and
# the rank on this host
_RANK_VARS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
_WORLD_VARS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")


def in_cluster_env() -> bool:
    """True when a known cluster launcher environment is detected."""
    return any(v in os.environ for v in _CLUSTER_ENV_VARS)


def _env_int(names) -> Optional[int]:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device_type: str = "cuda",
    timeout: float = DEFAULT_TIMEOUT,
) -> bool:
    """Join this process to the group of every process of the run.

    Returns True when the group was started. Explicit arguments cover
    manual clusters (``coordinator_address`` "host:port" of rank 0, joined
    as ``tcp://host:port``); with none, the environment is read only when a
    cluster launcher set it (otherwise this is a single-process no-op, as
    JAX's, rather than a hang on a machine outside a cluster), and
    ``num_processes <= 1`` is a no-op too. ``device_type`` "cuda" joins
    over NCCL and takes this host's card of the process's local rank (it
    raises when no card is visible); "cpu" joins over gloo."""
    if num_processes is not None and num_processes <= 1:
        return False
    if (
        coordinator_address is None
        and num_processes is None
        and process_id is None
        and not in_cluster_env()
    ):
        return False
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize(device_type='cuda'): no CUDA card is visible")
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unknown device type {device_type!r}: expected 'cuda' or 'cpu'")
    rank = process_id if process_id is not None else _env_int(_RANK_VARS)
    world = num_processes if num_processes is not None else _env_int(_WORLD_VARS)
    if rank is None or world is None:
        raise ValueError("multihost.initialize: the rank and the world size are unknown (pass "
                         "process_id and num_processes, or set RANK and WORLD_SIZE)")
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    if device_type == "cuda":
        local = _env_int(_LOCAL_RANK_VARS)
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def shutdown() -> None:
    """Tear the group down (safe to call when none is running). With more
    than one rank every rank first meets the others at a barrier, so that
    no rank destroys the group while a peer's collective threads still use
    it (a gloo peer torn down under them aborts its process at exit)."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() > 1:
            dist.barrier()
        dist.destroy_process_group()


def _running() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_mesh() -> Mesh:
    """This process's ``Mesh`` over every rank of the run (its card on
    NCCL, the CPU on gloo). Outside a group: a one-rank mesh on this
    process's card, or the CPU, with no process group."""
    if not _running():
        dev = (torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
               else torch.device("cpu"))
        return Mesh(rank=0, world_size=1, device=dev, group=None, backend=None)
    backend = dist.get_backend()
    dev = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
           else torch.device("cpu"))
    return Mesh(rank=dist.get_rank(), world_size=dist.get_world_size(), device=dev,
                group=dist.group.WORLD, backend=backend)


def process_count() -> int:
    return dist.get_world_size() if _running() else 1


def is_primary() -> bool:
    """True on the process that should write logs and checkpoints."""
    return not _running() or dist.get_rank() == 0


def local_device_count() -> int:
    """The cards this host's processes may take (1, the CPU, without a
    card)."""
    return torch.cuda.device_count() or 1
