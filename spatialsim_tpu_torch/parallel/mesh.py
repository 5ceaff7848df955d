"""The bodies axis as a ``torch.distributed`` process group (port of
``spatialsim_tpu/parallel/mesh.py``).

JAX's ``shard_map`` is one program over a device mesh; here each rank is
one process with one device, and a :class:`BodyMesh` names the group the
sharded engines talk over.  :func:`make_mesh` joins the group the way
``torchrun`` describes it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
rendezvous in ``MASTER_ADDR``/``MASTER_PORT``), or a one-rank group when
none of them is set; a caller that initialised the default group already
(the tests' ``file://`` rendezvous) gets that group.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

BODY_AXIS = "bodies"


class BodyMesh(NamedTuple):
    """The 1-D bodies axis: ``group`` (None: the default group), this
    process's ``rank`` in it, its ``size`` and the ``device`` the rank's
    shard lives on."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device=None,
              timeout: float = 600.0) -> BodyMesh:
    """The bodies axis over every rank of the job.

    ``device=None`` (or ``"cuda"``): NCCL, the rank's shard on
    ``cuda:LOCAL_RANK``; it raises when there is no card.  ``device="cpu"``:
    gloo on the CPU, as the tests run it.  Without ``torchrun``'s variables
    the group has one rank, joined through an in-memory store.  ``timeout``
    (seconds) bounds the rendezvous and every collective, so that a rank
    left waiting fails instead of hanging.  ``n_devices``, when given, must
    be the group's size.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (torch.cuda."
                           "is_available() is False); pass device='cpu' "
                           "for gloo on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: unsupported device {dev}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        wait = datetime.timedelta(seconds=timeout)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=wait)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=wait)
    elif dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, not {backend} for {dev}")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, the group has "
                         f"{size} ranks")
    if dev.type == "cuda":
        index = (dev.index if dev.index is not None
                 else int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    return BodyMesh(None, rank, size, dev)
