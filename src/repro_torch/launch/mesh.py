"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level state, so importing touches no distributed
state.  Single pod: 16x16 = 256 devices.  Multi-pod: 2 pods = 512 devices
with a dedicated "pod" axis (data-parallel across the pod boundary).

The dry run has no 256 devices: :func:`make_production_mesh` builds a
``DeviceMesh`` over a *fake* process group of that many ranks (this
process is rank 0), on which DTensor places and redistributes tensors
without moving a byte.  A real process group of another size is an
error; a fake one of another size (an earlier cell's) is replaced.
"""

from __future__ import annotations

import math


def _fake_group(world_size: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is up; the production mesh "
                f"needs {world_size}")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over a fake process
    group of ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    _fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1, device: str = "cuda"):
    """Small mesh over the devices of this host's process group (one
    process per device, as ``torchrun`` starts them); without a group, a
    group of this one process and its device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into model={model_axis}")
    return init_device_mesh(device, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
