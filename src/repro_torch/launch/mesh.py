"""Mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing touches no process
group.  ``make_production_mesh`` builds the reference's TPU v5e pod layouts
as ``DeviceMesh``es; they need a process group of at least 256 (one pod)
or 512 (two pods) ranks, which only a fake group
(``torch.testing._internal.distributed.fake_pg``) gives one process: the
dry run (``launch.dryrun``) and the tests create one.  ``make_local_mesh``
builds a ``("data", "model")`` mesh over the ranks of the group that
exists, and makes a one-rank group where none exists.
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_local_mesh"]


def _make_mesh(device_type: str, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over the first 256 or 512 ranks of the
    process group that exists (a fake one in one process).  A CPU mesh:
    the dry run's meta-device stand-ins are placed on it."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_production_mesh needs a process group of "
            f"{math.prod(shape)} ranks or more; in one process, create a "
            f"fake one (torch.testing._internal.distributed.fake_pg), as "
            f"launch.dryrun does")
    return _make_mesh("cpu", shape, axes)


def make_local_mesh(data: int | None = None, model: int = 1, *,
                    device=None):
    """A ``("data", "model")`` mesh over the ranks of the process group.

    Where no group exists, one of one rank is made over a ``HashStore``:
    ``nccl`` for the card, ``gloo`` for the CPU (``device`` unset means
    the card, and an error without one).  ``data x model`` must equal the
    group's size.  The reference spans every device that
    ``jax.device_count()`` sees from one process; a PyTorch process drives
    one card, so a mesh of several cards needs one process a card
    (``torchrun``), each calling this."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        kw = ({"backend": "nccl", "device_id": torch.device(
            "cuda", dev.index or 0)} if dev.type == "cuda"
              else {"backend": "gloo"})
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    world = dist.get_world_size()
    data = data or world // model
    if data * model != world:
        raise ValueError(f"a mesh of data {data} x model {model} = "
                         f"{data * model} ranks over a process group of "
                         f"{world}")
    return _make_mesh("cuda" if dev.type == "cuda" else "cpu",
                      (data, model), ("data", "model"))
