"""Serving submeshes and their collectives (counterpart of the JAX
package's ``launch/mesh.py``).

One tensor-parallel engine instance runs on a ``Mesh``: an ordered list
of ``chips`` torch devices with the axis names ("data", "model") and
shape (1, chips). The engine is single-controller, as the reference's:
one process holds every shard's tensors, each on its shard's device, and
the step's one model dispatch loops over the shards. A device may appear
more than once, so a submesh of k shards can be emulated on one device
(on the CPU, as the reference's tests emulate devices with
``--xla_force_host_platform_device_count``, or on one card); the same
code puts the shards on k cards when k are visible.

The collectives that GSPMD inserts in the reference are explicit calls
here, ``all_reduce`` and ``all_gather``. Both gather the parts to shard
0's device, combine them in shard order and hand every shard its own
result, so a run on one device gives the same bits as a run on k.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """A serve submesh: ``devices[s]`` holds shard s. ``data`` > 1 makes
    a ("data", "model") = (data, len(devices) / data) mesh, devices in
    row-major order (``make_mesh``); only the half-expert MoE path
    (``models/moe_a2a.py``) takes one, a serve submesh has data 1."""
    devices: Tuple[torch.device, ...]
    data: int = 1

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.data, len(self.devices) // self.data)))

    @property
    def size(self) -> int:
        return len(self.devices)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The data-parallel axes (the batch dim's sharding): "pod" and
    "data" where the mesh has them."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def axis_size(mesh: Mesh, axes: Union[str, Sequence[str]]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def visible_devices(platform: str) -> List[torch.device]:
    """The visible cards; on the CPU, one device that any number of
    shards may share (the emulated submesh)."""
    if platform == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no serve submeshes on {platform!r}")


def _take(need: int, devices: Optional[Sequence], platform: str,
          what: str) -> List[torch.device]:
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif platform == "cpu":
        devs = [torch.device("cpu")] * need
    else:
        devs = visible_devices(platform)
    if len(devs) < need:
        raise ValueError(
            f"{what} needs {need} devices, {len(devs)} are visible (pass "
            "device='cpu' to emulate the shards on the CPU, or an explicit "
            "device list, which may repeat a device)")
    return devs


def make_serve_mesh(chips: int, devices: Optional[Sequence] = None,
                    platform: str = "cuda") -> Mesh:
    """Per-instance tensor-parallel submesh ("data", "model") = (1, chips).
    ``devices`` pins the shards' devices (the cluster hands each instance
    its group; a list may repeat a device); by default the first
    ``chips`` visible cards are taken, and too few raise. On the CPU
    every shard is the CPU."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    devs = _take(chips, devices, platform, "a serve submesh")
    return Mesh(tuple(devs[:chips]))


def make_mesh(data: int, model: int, devices: Optional[Sequence] = None,
              platform: str = "cuda") -> Mesh:
    """A ("data", "model") = (data, model) mesh, device (r, c) at index
    r * model + c (the JAX package's ``jax.make_mesh`` order); devices as
    in ``make_serve_mesh``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh shape ({data}, {model})")
    devs = _take(data * model, devices, platform, "a mesh")
    return Mesh(tuple(devs[:data * model]), data)


def row_mesh(mesh: Mesh, r: int) -> Mesh:
    """The "model" axis of data row r: its own 1 x model mesh."""
    m = mesh.shape["model"]
    return Mesh(mesh.devices[r * m:(r + 1) * m])


def column_mesh(mesh: Mesh, c: int) -> Mesh:
    """The "data" axis of model column c, as a 1 x data mesh (the
    collectives of ``all_gather`` run over it in data order)."""
    return Mesh(mesh.devices[c::mesh.shape["model"]])


def partition_devices(chips_per_instance: Sequence[int],
                      devices: Optional[Sequence] = None,
                      platform: str = "cuda") -> List[List[torch.device]]:
    """Carve the devices into disjoint per-instance groups (the
    mesh-of-meshes): instance i gets chips_per_instance[i] of them, in
    order. ``devices`` defaults to the visible cards (on the CPU, to as
    many CPU shards as needed)."""
    need = sum(max(c, 1) for c in chips_per_instance)
    devs = _take(need, devices, platform,
                 f"a cluster of {list(chips_per_instance)} chips")
    groups, ofs = [], 0
    for c in chips_per_instance:
        c = max(c, 1)
        groups.append(devs[ofs:ofs + c])
        ofs += c
    return groups


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def broadcast(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every shard's own copy of ``t`` (which lies on shard 0's device):
    shard 0 gets ``t``, the others a copy on their device, never an
    alias."""
    return [t] + [t.to(d, copy=True) for d in mesh.devices[1:]]


def replicate(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A read-only input on every shard's device: a shard on ``t``'s
    device reads ``t`` itself (no copy), another gets a copy. For
    tensors no shard writes (a step's batch)."""
    return [t if t.device == d else t.to(d) for d in mesh.devices]


def all_reduce(parts: Sequence[torch.Tensor], mesh: Mesh
               ) -> List[torch.Tensor]:
    """The sum of every shard's part, on every shard: the parts are
    gathered to shard 0's device and added in shard order in float32,
    then cast back to the parts' dtype and broadcast."""
    dev0 = mesh.devices[0]
    acc = parts[0].to(dev0, dtype=torch.float32, copy=True)
    for p in parts[1:]:
        acc += p.to(dev0)
    return broadcast(acc.to(parts[0].dtype), mesh)


def gather(parts: Sequence[torch.Tensor], dim: int,
           mesh: Mesh) -> torch.Tensor:
    """The shards' parts concatenated along ``dim`` in shard order, on
    shard 0's device (the first half of ``all_gather``)."""
    dev0 = mesh.devices[0]
    return torch.cat([p.to(dev0) for p in parts], dim=dim)


def all_gather(parts: Sequence[torch.Tensor], dim: int, mesh: Mesh
               ) -> List[torch.Tensor]:
    """The shards' parts concatenated along ``dim`` in shard order, on
    every shard."""
    return broadcast(gather(parts, dim, mesh), mesh)
