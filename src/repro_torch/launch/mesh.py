"""Production and host meshes (mirrors `repro.launch.mesh`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the default
process group's ranks, with the reference's axis names:

  pod     crosses the inter-pod boundary: pure data parallelism
  data    intra-pod data parallelism + fsdp (ZeRO-3 parameter sharding)
  model   tensor / sequence parallelism (Megatron-style)

Every function builds a mesh when it is called (no module-level state),
and every rank calls it, as every rank calls a collective. A mesh is on
the card unless the caller asks for ``device_type="cpu"``; without CUDA
the default raises (`repro_torch.device.resolve_device`). The production
shapes are the reference's: (16, 16) for one pod and (2, 16, 16) for two.
They describe the reference's topology (256 and 512 chips), not an H100
cluster; the dry run (`repro_torch.launch.dryrun`) builds them over a
fake process group of that many ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _mesh(shape: tuple, names: tuple, device_type: Optional[str] = None):
    from torch.distributed.device_mesh import DeviceMesh

    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed's default "
                           "process group (init_process_group)")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the default process group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, pod: Optional[int] = None,
                   *, device_type: Optional[str] = None):
    """A small mesh over the first data x model (x pod) ranks of the
    default process group (tests, examples, the chip check)."""
    if pod is None:
        return _mesh((data, model), ("data", "model"), device_type)
    return _mesh((pod, data, model), ("pod", "data", "model"), device_type)


def mesh_devices_required(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def mesh_shape(mesh) -> dict:
    """``{axis name: size}``: the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def describe(mesh) -> str:
    shape = mesh_shape(mesh)
    return " x ".join(f"{k}={v}" for k, v in shape.items()) \
        + f" ({mesh.size()} chips)"
