"""Meshes over the ranks of a ``torch.distributed`` world: the sim mesh
for the sharded sim engine (``repro_torch.sim``) and the LM mesh for the
model's logical-axis sharding (``models.ShardCtx``, ``launch.train
--mesh``, ``launch.dryrun``).

Port of ``repro.launch.mesh``: ``make_sim_mesh``, ``make_debug_mesh``,
``make_production_mesh`` and ``mesh_chips``. The reference's meshes span
the local accelerators of one JAX process; the port's span ranks, one
process each, so one rank's device holds one shard. The first mesh a
process asks for joins the default process group if there is one, and
otherwise starts it:

  * under a launcher (``WORLD_SIZE`` in the environment, as ``torchrun``
    sets it) from ``env://``;
  * otherwise a one-rank world on an in-process store.

It starts ``nccl`` when the rank's device is CUDA (each rank on
``cuda:LOCAL_RANK``, ``utils.device.resolve_device``) and ``gloo`` on the
CPU. A world it started stays up for the life of the process, as JAX's
device state does, and the other mesh kind reuses it. A caller that
wants another layout, such as several ranks on one card, starts the
world itself (``gloo``: NCCL refuses two ranks on one GPU).

The sim mesh (``SimMesh``) is a 1-D ``devices`` axis. Every rank of the
world holds the whole federation and runs the same host code, so every
rank calls the same collectives in the same order: the mesh ranks
gather their shards of a group (``SimMesh.gather``), and ranks outside
the mesh receive the result from mesh rank 0.

The LM mesh (``LmMesh``) wraps a ``DeviceMesh`` with the reference's
axis names: ``("data", "model")``, or ``("pod", "data", "model")`` on
the multi-pod mesh. Parameters, optimizer state, batches and caches are
``DTensor``s on it, placed by ``sharding.rules``; ``make_production_mesh``
needs a world of 256 or 512 ranks (the dry-run's fake process group).
"""
from __future__ import annotations

import dataclasses
import os
from typing import ClassVar, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class SimMesh:
    """The ``devices`` mesh over world ranks ``0 .. n_shards - 1``.

    Duck-typed like the reference's ``jax.sharding.Mesh`` for
    ``sharding.rules``: ``axis_names`` and ``devices.shape``."""

    axis_names: ClassVar[Tuple[str, ...]] = ("devices",)

    devices: np.ndarray         # (n_shards,) the mesh's world ranks
    group: object               # the process group over them; None outside the mesh
    rank: Optional[int]         # this rank's index in the mesh; None outside it
    device: torch.device        # this rank's device

    @property
    def n_shards(self) -> int:
        return int(self.devices.size)

    def _comm_device(self) -> torch.device:
        # gloo has no CUDA all-gather: it moves host copies
        if self.device.type == "cuda" and "nccl" in dist.get_backend():
            return self.device
        return torch.device("cpu")

    def gather(self, part: Optional[torch.Tensor], shape: Tuple[int, ...]) -> torch.Tensor:
        """The mesh ranks' fp32 ``part``s, each ``shape[0] // n_shards``
        rows of ``shape``, concatenated in mesh-rank order, on every rank
        of the world: one all-gather over the mesh, then, where the world
        is larger than the mesh, one broadcast from mesh rank 0 to the
        ranks outside it (whose ``part`` is ``None``)."""
        comm = self._comm_device()
        if self.rank is not None:
            src = part.to(comm).contiguous()
            parts = [torch.empty_like(src) for _ in range(self.n_shards)]
            dist.all_gather(parts, src, group=self.group)
            full = torch.cat(parts)
        else:
            full = torch.empty(shape, dtype=torch.float32, device=comm)
        if dist.get_world_size() > self.n_shards:
            dist.broadcast(full, src=0)
        return full


# meshes by (shards, device), process groups by shards: every rank must
# call ``dist.new_group`` for the same shard counts in the same order
_MESHES: Dict[tuple, SimMesh] = {}
_GROUPS: Dict[int, object] = {}


def _start_world(device: torch.device) -> None:
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh_group(n: int, world: int):
    if n not in _GROUPS:
        # new_group is collective over the world, members or not
        _GROUPS[n] = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return _GROUPS[n] if dist.get_rank() < n else None


def make_sim_mesh(shards: Optional[int] = None, device="cuda") -> SimMesh:
    """1-D ``devices`` mesh for the sharded sim engine, on ``device``.

    ``shards`` defaults to the world size; it is capped at the world
    size and floored to a power of two, so it always divides the
    engine's power-of-two group padding (a one-rank world degenerates
    to the bucketed layout)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        _start_world(dev)
    backend = dist.get_backend()
    if dev.type == "cpu" and "gloo" not in backend:
        raise ValueError(f"the process group runs {backend!r}, which gathers no CPU "
                         "tensors; run the CPU sim mesh in a gloo world")
    world = dist.get_world_size()
    n = world if shards is None else max(1, min(int(shards), world))
    n = 1 << (n.bit_length() - 1)  # floor to a power of two
    key = (n, dev)
    if key not in _MESHES:
        group = _mesh_group(n, world)
        rank = dist.get_rank()
        _MESHES[key] = SimMesh(np.arange(n), group, rank if rank < n else None, dev)
    return _MESHES[key]


@dataclasses.dataclass(frozen=True, eq=False)
class LmMesh:
    """The LM mesh: a ``DeviceMesh`` and the reference's axis names.

    Duck-typed like the reference's ``jax.sharding.Mesh`` for
    ``sharding.rules`` and ``roofline.analytic``: ``axis_names`` and
    ``devices.shape`` (``devices`` holds the mesh's world ranks)."""

    device_mesh: DeviceMesh
    axis_names: Tuple[str, ...]
    devices: np.ndarray
    device: torch.device        # this rank's device ("cpu" on the dry-run's fake world)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


_LM_MESHES: Dict[tuple, LmMesh] = {}


def _lm_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], dev: torch.device) -> LmMesh:
    if not dist.is_initialized():
        _start_world(dev)
    backend = dist.get_backend()
    if dev.type == "cpu" and "gloo" not in backend and "fake" not in backend:
        raise ValueError(f"the process group runs {backend!r}, which moves no CPU tensors; "
                         "run the CPU LM mesh in a gloo world")
    world, need = dist.get_world_size(), int(np.prod(shape))
    if world < need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} ranks; the world "
                         f"has {world}")
    key = (shape, axes, dev)
    if key not in _LM_MESHES:
        ranks = np.arange(need).reshape(shape)
        # DeviceMesh's own process groups: collective over the world
        mesh = DeviceMesh(dev.type, torch.from_numpy(ranks), mesh_dim_names=axes)
        _LM_MESHES[key] = LmMesh(mesh, axes, ranks, dev)
    return _LM_MESHES[key]


def make_debug_mesh(data: int = 1, model: int = 1, device="cuda") -> LmMesh:
    """A (data, model) mesh over the first ``data * model`` ranks of the
    world (the tests' meshes; on one card a one-rank world)."""
    return _lm_mesh((int(data), int(model)), ("data", "model"), resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> LmMesh:
    """16 x 16 = 256 ranks, or 2 x 16 x 16 = 512 multi-pod, the
    reference's two production layouts. Raises naming the world's size
    when it has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _lm_mesh(shape, axes, resolve_device(device))


def mesh_chips(mesh) -> int:
    return int(np.prod(mesh.devices.shape))
