"""Process groups for data-parallel training: one process a device.

Counterpart of ``dexnerf_tpu/parallel/mesh.py``. JAX builds a 1-D
``Mesh`` over the devices of one process and ``shard_map``s the step over
it; PyTorch's idiom is one process a device joined by a
``torch.distributed`` process group: NCCL between CUDA cards, gloo between
CPU processes (the analog of JAX's
``--xla_force_host_platform_device_count`` CPU mesh, how the tests run).
:func:`make_mesh` joins one rank to the group; :func:`spawn_ranks` starts
the ranks on this host and collects what each returns. A card has one
rank: asking for more ranks than there are cards raises JAX's
``requested {n} devices, have {m}``, and a card never falls back to gloo
unless the caller names that backend.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# seconds a rank waits for the others at the process group's set-up and at
# every collective
DEFAULT_TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the group: its rank, the number of ranks,
    its device, the process group and its backend."""

    rank: int
    world_size: int
    device: torch.device
    group: Any
    backend: str

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def device_count(device_type: str) -> int:
    """The devices ranks may take: the visible cards, or the CPU's cores."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return os.cpu_count() or 1
    raise ValueError(f"unknown device type {device_type!r}: expected 'cuda' or 'cpu'")


def mesh_devices(num_devices: int, device_type: str = "cuda",
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device of each of ``num_devices`` ranks: ``devices`` when given
    (as JAX's ``make_mesh(devices=)``; two ranks may then share a card),
    else ``cuda:<rank>``, or the CPU for every rank. Raises JAX's words when
    there are fewer devices than ranks."""
    if devices is None:
        have = device_count(device_type)
        if num_devices > have:
            raise ValueError(f"requested {num_devices} devices, have {have}")
        if device_type == "cuda":
            return [torch.device("cuda", r) for r in range(num_devices)]
        return [torch.device("cpu")] * num_devices
    devices = [torch.device(d) for d in devices]
    if num_devices > len(devices):
        raise ValueError(f"requested {num_devices} devices, have {len(devices)}")
    return devices[:num_devices]


def make_mesh(
    num_devices: int,
    device_type: str = "cuda",
    *,
    rank: int,
    init_method: str,
    devices: Optional[Sequence] = None,
    backend: Optional[str] = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> Mesh:
    """Join rank ``rank`` of ``num_devices`` to the process group at
    ``init_method`` (``tcp://host:port``) and return its :class:`Mesh`.
    The backend is NCCL on cards and gloo on the CPU unless ``backend``
    names another; ``devices`` as :func:`mesh_devices`."""
    devs = mesh_devices(num_devices, device_type, devices)
    dev = devs[rank]
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=num_devices, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return Mesh(rank=rank, world_size=num_devices, device=dev, group=dist.group.WORLD,
                backend=backend)


def all_reduce_sum(mesh: Mesh, buf: torch.Tensor) -> torch.Tensor:
    """Sum ``buf`` over the ranks, in place, every rank getting the same
    bits. Gloo reduces in host memory: a card's tensor goes through a CPU
    copy."""
    if mesh.backend == "gloo" and buf.device.type != "cpu":
        host = buf.cpu()
        dist.all_reduce(host, group=mesh.group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, group=mesh.group)
    return buf


def all_gather(mesh: Mesh, buf: torch.Tensor) -> torch.Tensor:
    """Every rank's ``buf`` (the same shape on each), stacked by rank:
    ``[world_size, *buf.shape]`` on every rank. Gloo gathers in host memory:
    a card's tensor goes through a CPU copy."""
    src = buf.cpu() if mesh.backend == "gloo" else buf
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts).to(buf.device)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, num_devices, device_type, devices, backend, port, group_timeout,
                threads, args, outdir):
    mesh = make_mesh(num_devices, device_type, rank=rank, init_method=f"tcp://127.0.0.1:{port}",
                     devices=devices, backend=backend, timeout=group_timeout)
    if mesh.device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(threads)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(
    fn: Callable,
    num_devices: int,
    device_type: str = "cuda",
    args: Sequence = (),
    *,
    devices: Optional[Sequence] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``num_devices`` new processes (start
    method ``spawn``), one a rank, joined on a free 127.0.0.1 port, and
    return what each rank's call returned (saved with ``torch.save``; keep
    it on the CPU), by rank. ``fn`` and ``args`` must pickle. A rank that
    raises raises here. With ``timeout`` (seconds), every rank is killed and
    ``TimeoutError`` raised once the run outlasts it, and the process group
    waits at most that long at a collective; without, the run may last as
    long as it needs (a training run) and a collective waits
    ``DEFAULT_TIMEOUT``."""
    mesh_devices(num_devices, device_type, devices)  # refuse before starting anything
    outdir = tempfile.mkdtemp(prefix="dexnerf_ranks_")
    threads = max(1, torch.get_num_threads() // num_devices)
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, nprocs=num_devices, join=False, start_method="spawn",
            args=(fn, num_devices, device_type, devices, backend, free_port(),
                  DEFAULT_TIMEOUT if timeout is None else timeout, threads, tuple(args), outdir))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{num_devices} ranks still running after {timeout:g} s")
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(num_devices)]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
