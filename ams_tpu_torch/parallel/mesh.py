"""Device meshes and the multi-process runtime, in PyTorch.

Counterpart of ``ams_tpu/parallel/mesh.py``.  JAX's ``Mesh`` is a grid of
devices that one program spans; the port has no such program, so its
``Mesh`` is only the grid, a ``(data, model)`` array of ``torch.device``
with the axis names, which the multi-video round and the sharded labeler
split their work over.  ``init_multi_host`` joins a ``torch.distributed``
process group, one process per rank, which the minibatch-parallel round
sums over.

The ``model`` axis partitions the activation width of one network over
the devices of a mesh row, as JAX's GSPMD does; the port keeps a row's
shards in one process (``parallel.spatial``).  A row may name one device
more than once (``Mesh([[cuda:0, cuda:0]])`` partitions the width on a
one-card machine).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ams_tpu_torch.utils.platform import resolve_device

# torch's launcher variables, which play the part of JAX_COORDINATOR_ADDRESS
LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``: ``devices`` is the
    numpy object array, ``axis_names`` its axes, ``size`` the device count
    and ``shape`` the axis sizes by name, as JAX's mesh has them."""

    def __init__(self, devices, axis_names: Sequence[str] = ("data",
                                                             "model")):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError("a %d-axis device grid needs %d axis names, "
                             "got %r" % (grid.ndim, grid.ndim, axis_names))
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def device_list(self):
        """The devices in row-major order, the order JAX's ``P(axes)``
        splits a leading axis over."""
        return list(self.devices.flat)

    def rows(self, axis: str = "data"):
        """The mesh's rows along ``axis``: for each of its entries, the
        devices of the other axis (a width-partitioned network's row)."""
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return [list(row.flat) for row in grid]

    def __repr__(self):
        return "Mesh(%s, %r)" % (self.shape, [str(d) for d in
                                              self.device_list()])


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("data", "model"),
              model_parallelism: Optional[int] = None,
              device=None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_devices`` CUDA devices
    (all of them by default), ``model_parallelism`` (default 1) devices
    per row; ``device="cpu"`` gives ``n_devices`` CPU entries (1 by
    default), so the per-device split runs on a host without a card.
    Asking for more cards than exist, or a device count that
    ``model_parallelism`` does not divide, raises ``ValueError`` (JAX
    asserts the latter)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devices):
                # truncating would hand back a smaller mesh than the caller
                # sized its work for (e.g. V videos over n_devices)
                raise ValueError("requested a %d-device mesh but only %d "
                                 "devices exist" % (n_devices, len(devices)))
            devices = devices[:n_devices]
    else:
        devices = [dev] * (1 if n_devices is None else n_devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    m = 1 if model_parallelism is None else int(model_parallelism)
    if m < 1 or len(devices) % m:
        raise ValueError("model_parallelism=%r does not divide %d devices"
                         % (model_parallelism, len(devices)))
    return Mesh([devices[i:i + m] for i in range(0, len(devices), m)],
                axis_names)


def init_multi_host(coordinator_address: Optional[str] = None,
                    num_processes: Optional[int] = None,
                    process_id: Optional[int] = None,
                    auto: bool = False,
                    backend: Optional[str] = None) -> int:
    """Join a ``torch.distributed`` process group, one process per rank,
    and return its world size.

    ``coordinator_address`` is ``host:port`` of rank 0 (or an
    ``init_method`` URL), ``num_processes`` the world size and
    ``process_id`` this rank.  Without them, torch's launcher variables
    (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them)
    configure the group, as ``JAX_COORDINATOR_ADDRESS`` does JAX's.  With
    neither, a process stays alone and joins nothing (returns 1) unless
    ``auto=True``, which reads the launcher variables and fails without
    them: as in JAX, joining is opt-in.  The backend is ``nccl`` (which
    needs a card: without one this raises) unless ``backend`` names another,
    such as ``"gloo"`` for ranks on the CPU or ranks that share one card.
    """
    explicit = coordinator_address is not None or num_processes is not None \
        or process_id is not None \
        or any(k in os.environ for k in LAUNCHER_ENV)
    if not explicit and not auto:
        return 1
    if backend is None:
        resolve_device(None)        # nccl needs a card: raise here without one
        backend = "nccl"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    world = num_processes if num_processes is not None \
        else int(os.environ.get("WORLD_SIZE", -1))
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", -1))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return dist.get_world_size()
