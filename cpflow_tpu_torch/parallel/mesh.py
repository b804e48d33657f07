"""The restart split over several cards (counterpart of
cpflow_tpu/parallel/mesh.py).

The only parallel axis of the synthesis is the batch of random restarts,
and restarts are independent. The JAX package shards that axis over a 1-d
``jax.sharding.Mesh`` and lets XLA partition the program. Here the split
is explicit: a ``RestartMesh`` lists the devices of this process, in
order, and the process group's rank and world size when
``distributed_init`` ran. The whole batch is cut in restart order into
``mesh.size`` contiguous shards, shard ``rank * len(devices) + i`` on local
device i; each shard runs its own sweep on its device, and the results
are joined back in restart order. ``split_restarts`` and
``gather_restarts`` are the one place where that happens. The hot loop
has no collective: only the per-restart results are gathered, across
processes by a gloo ``all_gather`` of CPU copies, so that every process
holds the whole result, as every JAX process holds the global array.

A mesh may name one device more than once (two shards on one card, or
several CPU entries): that runs the split logic, shard by shard, where
there is one card.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

RESTART_AXIS = 'restarts'


@dataclass(frozen=True)
class RestartMesh:
    """The devices of this process, in shard order, and the process group's
    rank and world size (0 and 1 without one). ``size`` is the number of
    shards over all processes."""
    devices: tuple
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        return len(self.devices) * self.world_size

    def shard_index(self, i: int) -> int:
        """The global shard number of local device i."""
        return self.rank * len(self.devices) + i


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'mesh device {device}: no CUDA device is '
                               f'visible')
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
        if device.index >= torch.cuda.device_count():
            raise RuntimeError(f'mesh device {device} does not exist: '
                               f'{torch.cuda.device_count()} CUDA device(s) '
                               f'visible')
    elif device.type != 'cpu':
        raise ValueError(f'mesh device {device}: cuda or cpu only')
    return device


def restart_mesh(devices: Optional[Sequence] = None) -> RestartMesh:
    """A mesh over the given devices (names or torch.devices, repeats
    allowed), by default every visible CUDA device. Raises if a device does
    not exist, or if no CUDA device is visible and none is given. Takes the
    rank and world size of the process group if one is initialized."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('restart_mesh: no CUDA device is visible; '
                               'name the devices (e.g. ["cpu"] * 4)')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(_check_device(d) for d in devices)
    if not devices:
        raise ValueError('restart_mesh: no devices')
    rank, world = 0, 1
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    return RestartMesh(devices, rank, world)


def restart_sharding(mesh: RestartMesh) -> RestartMesh:
    """The sharding of arrays whose leading axis is the restart batch: the
    mesh itself (the port has no separate sharding object)."""
    return mesh


def padded_batch_size(num_samples: int, mesh: Optional[RestartMesh]) -> int:
    """Round the restart count up to a multiple of the mesh size (restarts
    are i.i.d., so extra samples only improve coverage)."""
    if mesh is None:
        return num_samples
    d = mesh.size
    return ((num_samples + d - 1) // d) * d


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: float = 60.0) -> None:
    """Join the process group that gathers the restart shards (gloo over
    TCP; no-op without an address, as in the JAX package).
    coordinator_address: 'host:port' of process 0 (or 'tcp://host:port').
    Raises if the peers do not all arrive within `timeout` seconds."""
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError('distributed_init needs num_processes and '
                         'process_id with an address')
    address = coordinator_address
    if not address.startswith('tcp://'):
        address = f'tcp://{address}'
    torch.distributed.init_process_group(
        'gloo', init_method=address, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout))


def split_restarts(x: torch.Tensor, mesh: RestartMesh,
                   dim: int = 0) -> List[torch.Tensor]:
    """This process's shards of the whole batch x (restarts along `dim`),
    one per local device, each moved to its device. The batch must be a
    multiple of mesh.size (padded_batch_size), so that every shard has the
    same number of restarts."""
    batch = x.shape[dim]
    if batch % mesh.size:
        raise ValueError(f'a batch of {batch} restarts does not split into '
                         f'{mesh.size} equal shards; pad it to a multiple '
                         f'(padded_batch_size)')
    per = batch // mesh.size
    return [x.narrow(dim, mesh.shard_index(i) * per, per).to(device)
            for i, device in enumerate(mesh.devices)]


def gather_restarts(parts: Sequence[torch.Tensor], mesh: RestartMesh,
                    dim: int = 0) -> torch.Tensor:
    """The whole batch from this process's shards (restarts along `dim`),
    in restart order, on the mesh's first device. Across processes the
    shards travel as CPU copies through the process group's all_gather,
    so that every process holds the whole batch."""
    home = mesh.devices[0]
    local = torch.cat([p.to(home) for p in parts], dim=dim)
    if mesh.world_size == 1:
        return local
    local = local.detach().cpu().contiguous()
    every = [torch.empty_like(local) for _ in range(mesh.world_size)]
    torch.distributed.all_gather(every, local)
    return torch.cat(every, dim=dim).to(home)
