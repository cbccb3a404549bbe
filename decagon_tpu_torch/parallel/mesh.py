"""Process groups and the (row, edge) device mesh.

Port of ``decagon_tpu/parallel/mesh.py``.  The JAX package runs one
controller over all devices; here every rank is a process of its own
(``torch.distributed``), holding only its slot of the sharded graph and
of the relation-sharded parameters.  The mesh has the JAX package's two
named axes (``parallel/rowshard.py``):

* ``row``: destination-node row blocks (the cross-host axis),
* ``edge``: edge shards and dense relation splits within a row block
  (the intra-host axis).

``make_mesh(shape=(nr, ne))`` is ``init_device_mesh(device_type, (nr,
ne), mesh_dim_names=("row", "edge"))`` over a process group that must
already exist: rank ``r * ne + e`` sits at mesh coordinate ``(r, e)``, the
JAX package's slot ``r * ne + e``.  ``initialize_distributed`` creates the
group from explicit arguments or from the ``torchrun`` environment.  The
backend is named, never guessed from an error: ``"nccl"`` when each rank
has its own card, ``"gloo"`` on the CPU and where several ranks share one
card.  Nothing degrades to a single process: a missing group, a mesh
whose size is not the world's, or a backend other than the one asked for
raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("row", "edge")
BACKENDS = ("nccl", "gloo")


def default_backend(device: torch.device) -> str:
    """``"nccl"`` for ranks on CUDA devices, ``"gloo"`` on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> None:
    """Create the default process group (idempotent: a second call, or a
    call in a process whose group exists, does nothing).

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` name the world size and this rank; without it they come
    from the ``torchrun`` environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), and a missing variable raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if dist.is_initialized():
        return
    if coordinator_address is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
                   if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize_distributed: no coordinator address and the torchrun "
                f"environment lacks {missing}; run under `python -m torch.distributed.run` "
                f"or pass coordinator_address, num_processes and process_id"
            )
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and process_id")
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend, init_method=address, world_size=int(num_processes), rank=int(process_id)
    )


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = AXES,
    shape: Optional[Tuple[int, int]] = None,
    multihost: bool = False,
    backend: Optional[str] = None,
) -> DeviceMesh:
    """The (row, edge) mesh over the existing process group.

    ``make_mesh(4)`` -> 1 x 4 (pure edge sharding); ``make_mesh(shape=(2,
    2))`` -> 2 row blocks x 2 edge shards; no argument -> 1 x world size.
    ``nr * ne`` must equal the world size.  ``multihost=True`` also checks
    that the ``edge`` axis stays within a host (``ne`` divides
    ``LOCAL_WORLD_SIZE``) so that the ``row`` axis strides across hosts,
    the layout of the JAX package's ``create_hybrid_device_mesh``.
    ``backend``, when given, must be the group's.  The mesh's device type
    is ``cuda`` under NCCL and ``cpu`` under gloo (gloo's ranks may share
    one card, or have none)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call initialize_distributed first"
        )
    world = dist.get_world_size()
    if shape is None:
        shape = (1, world if n_devices is None else int(n_devices))
    nr, ne = (int(s) for s in shape)
    if nr < 1 or ne < 1 or nr * ne != world:
        raise ValueError(
            f"mesh shape {(nr, ne)} needs {nr * ne} ranks; the world has {world}"
        )
    group_backend = str(dist.get_backend())
    if backend is not None and backend != group_backend:
        raise ValueError(f"mesh asks for backend {backend!r}; the process group runs "
                         f"{group_backend!r}")
    if multihost:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local % ne:
            raise ValueError(
                f"multihost mesh {(nr, ne)}: the edge axis ({ne}) must divide the ranks "
                f"of a host (LOCAL_WORLD_SIZE={local}) to stay within it"
            )
    device_type = "cuda" if group_backend == "nccl" else "cpu"
    return init_device_mesh(device_type, (nr, ne), mesh_dim_names=tuple(axes))


def mesh_groups(mesh: DeviceMesh):
    """(row group, edge group) of this rank."""
    names = mesh.mesh_dim_names
    return mesh.get_group(names[0]), mesh.get_group(names[1])


def mesh_shape(mesh: DeviceMesh) -> Tuple[int, int]:
    return tuple(int(s) for s in mesh.shape)


def mesh_slot(mesh: DeviceMesh) -> int:
    """This rank's slot ``r * ne + e``."""
    r, e = mesh.get_coordinate()
    return int(r) * int(mesh.shape[1]) + int(e)


def process_rank() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def barrier() -> None:
    """Wait for every rank of the default group (nothing without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
