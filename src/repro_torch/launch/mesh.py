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
result, so a run on one device gives the same bits as a run on k. While
an ``analysis.counting.Counter`` is active, each call reports its kind
and bytes to it.

A mesh may also carry named axes of any sizes, as the reference's
production meshes do: ``make_production_mesh`` gives ("data", "model")
(16, 16), ("pod", "data", "model") (2, 16, 16) and, with the expert axis,
("data", "expert", "model") (16, 8, 2) and ("pod", "data", "expert",
"model") (2, 16, 8, 2), over meta devices: the dry-run's meshes, which
hold shapes and run no kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..analysis import counting

@dataclass(frozen=True)
class Mesh:
    """``devices[s]`` holds shard s; ``axes`` names the mesh's axes and
    their sizes, devices in row-major order. A serve submesh is
    ("data", "model") = (1, chips) (``make_serve_mesh``); the half-expert
    MoE path (``models/moe_a2a.py``) also takes data > 1 (``make_mesh``)
    and the dry-run the production meshes (``make_production_mesh``)."""
    devices: Tuple[torch.device, ...]
    axes: Tuple[Tuple[str, int], ...]

    def __post_init__(self):
        if math.prod(n for _, n in self.axes) != len(self.devices):
            raise ValueError(f"mesh axes {self.axes} do not cover "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        return dict(self.axes)

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
    return Mesh(tuple(devs[:chips]), (("data", 1), ("model", chips)))


def make_mesh(data: int, model: int, devices: Optional[Sequence] = None,
              platform: str = "cuda") -> Mesh:
    """A ("data", "model") = (data, model) mesh, device (r, c) at index
    r * model + c (the JAX package's ``jax.make_mesh`` order); devices as
    in ``make_serve_mesh``."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh shape ({data}, {model})")
    devs = _take(data * model, devices, platform, "a mesh")
    return Mesh(tuple(devs[:data * model]), (("data", data), ("model", model)))


def named_mesh(axes: Dict[str, int], devices: Sequence) -> Mesh:
    """A mesh of named axes ``axes`` (name -> size, in row-major order)
    over ``devices`` (a list may repeat a device)."""
    devs = tuple(torch.device(d) for d in devices)
    return Mesh(devs, tuple(axes.items()))


def make_production_mesh(*, multi_pod: bool = False,
                         expert_axis: bool = False,
                         device="meta") -> Mesh:
    """The reference's production meshes (its ``make_production_mesh``),
    in its shapes and axis orders: ("data", "model") = (16, 16), with
    ``multi_pod`` ("pod", "data", "model") = (2, 16, 16), the "pod" axis
    pure data parallelism; ``expert_axis`` re-slices the 16-way model
    axis into ("expert", "model") = (8, 2). Every shard is ``device``
    (meta: shapes only, for the dry-run)."""
    if expert_axis:
        names = ("data", "expert", "model")
        sizes = (16, 8, 2)
    else:
        names, sizes = ("data", "model"), (16, 16)
    if multi_pod:
        names, sizes = ("pod",) + names, (2,) + sizes
    return named_mesh(dict(zip(names, sizes)),
                      [device] * math.prod(sizes))


def make_host_mesh(n_instances: int = 1, devices: Optional[Sequence] = None,
                   platform: str = "cpu") -> Mesh:
    """The reference's small test mesh ("data", "model") = (n, 1): on the
    CPU n = n_instances shards that share the CPU; on cards, as many of
    them as are visible, at most n_instances (the reference takes
    min(n_instances, its device count))."""
    if devices is None and platform != "cpu":
        devices = visible_devices(platform)
    n = n_instances if devices is None else min(n_instances, len(devices))
    return make_mesh(n, 1, devices, platform)


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
    if counting.ACTIVE is not None:
        counting.ACTIVE.collective("all-reduce", counting.nbytes(parts[0]),
                                   len(parts))
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
    if counting.ACTIVE is not None:
        counting.ACTIVE.collective(
            "all-gather", sum(counting.nbytes(p) for p in parts), len(parts))
    return broadcast(gather(parts, dim, mesh), mesh)
