"""Process-group initialization, the 2-D host mesh and hardware provenance.

PyTorch port of ``mlff_tpu.parallel.distributed``.  The JAX package maps the
reference's SGE node table (src/tools/cluster_information.py:1-65) and its
independent array jobs onto ``jax.distributed``; here one process per rank
joins a ``torch.distributed`` group (NCCL for CUDA tensors, gloo on the CPU)
and the ranks form a ``DeviceMesh``.  Nothing on the host tells a program of
a cluster: the caller gives the group its address, size and rank, or the
launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) does.
"""

from __future__ import annotations

import os
import platform as platform_mod

import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.log import get_logger

log = get_logger(__name__)


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     device=None, timeout=None) -> None:
    """Join the default process group (one process per rank).

    Does nothing in a single process: the group is set up only when
    ``world_size`` > 1, when ``init_method`` is given (a one-rank group at an
    explicit address) or when the launcher's ``WORLD_SIZE`` asks for more
    than one rank.  ``backend`` defaults to ``nccl`` when the device
    (``resolve_device(device)``: cuda unless the caller asks for the CPU) is
    CUDA and ``gloo`` on the CPU.  ``timeout``: a ``datetime.timedelta``
    for the group's collectives (torch's default when None).  A second call
    after the group exists does nothing."""
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if not ((world_size or 1) > 1 or init_method):
        return
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=world_size if world_size is not None else 1,
        rank=rank if rank is not None else 0, **kw)
    log.info("torch.distributed initialized: rank %d / %d (%s)",
             dist.get_rank(), dist.get_world_size(), backend)


def make_host_mesh(device_type: str | None = None):
    """2-D ('hosts', 'rows') mesh over every rank of the default group: one
    row of the mesh per host (``LOCAL_WORLD_SIZE`` ranks each, all ranks on
    one host when unset).  The kernel operator's row sharding
    (``parallel.mesh``) runs over the flattened mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // per_host, per_host),
                            mesh_dim_names=("hosts", "rows"))


def hardware_info() -> dict:
    """Result-provenance record (the reference's SGE-node -> GPU/CPU map,
    cluster_information.py:17-66), with the JAX package's keys and torch's
    and CUDA's versions in place of JAX's."""
    cuda = torch.cuda.is_available()
    initialized = dist.is_available() and dist.is_initialized()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda
        else platform_mod.processor() or "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "n_hosts": (dist.get_world_size()
                    // int(os.environ.get("LOCAL_WORLD_SIZE",
                                          dist.get_world_size()))
                    if initialized else 1),
        "uname": platform_mod.uname()._asdict(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
