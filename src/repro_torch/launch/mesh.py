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
here: ``all_reduce`` (a sum or a max), ``all_gather``, ``reduce_scatter``
and ``gather_whole``. A reduction runs over all of the mesh's axes or
over a subset: the shards that differ only in those axes form a group
(``groups``), and each group is reduced on its own, as the gradient
reduce of a train step runs over the data axes while the "model" shards
of a data row hold different pieces. Every collective gathers a group's
parts to the group's first device, combines them in shard order (sums
in float32) and hands every shard its own result, so a run on one
device gives the same bits as a run on k. While an
``analysis.counting.Counter`` is active, each call reports its kind and
bytes to it, per group of more than one shard.

A leaf laid out by a PartitionSpec (one entry per leading dim: a mesh
axis, a tuple of axes, or None) has one block a shard: ``block_slices``
gives shard s's, the block that JAX's ``NamedSharding(mesh, pspec)``
gives the device at mesh position s, devices in row-major order (a dim
over a tuple of axes is cut into the product of their sizes, the first
axis the major). ``piece`` cuts a block, ``assemble`` puts the blocks
of a leaf back together.

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
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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


def coords(mesh: Mesh, s: int) -> Dict[str, int]:
    """Shard s's position on each axis (devices in row-major order)."""
    out = {}
    for name, n in reversed(mesh.axes):
        out[name] = s % n
        s //= n
    return out


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(pspec) -> Tuple[str, ...]:
    """Every mesh axis a PartitionSpec names, in its order."""
    return tuple(a for e in pspec for a in entry_axes(e))


def groups(mesh: Mesh, axes: Optional[Sequence[str]] = None
           ) -> List[List[int]]:
    """The shards that agree on every axis outside ``axes`` (default:
    every axis, one group), each group in shard order."""
    axes = set(mesh.shape if axes is None else axes)
    out: Dict[Tuple, List[int]] = {}
    for s in range(mesh.size):
        c = coords(mesh, s)
        out.setdefault(tuple(c[a] for a, _ in mesh.axes if a not in axes),
                       []).append(s)
    return list(out.values())


def block_slices(shape: Sequence[int], pspec, mesh: Mesh, s: int
                 ) -> List[Tuple[int, int, int]]:
    """(dim, start, length) of shard s's block along each split dim."""
    c = coords(mesh, s)
    out = []
    for d, e in enumerate(pspec):
        axes = entry_axes(e)
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + c[a]
            n *= mesh.shape[a]
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({n} ways)")
        ln = shape[d] // n
        out.append((d, idx * ln, ln))
    return out


def block_view(t: torch.Tensor, pspec, mesh: Mesh, s: int) -> torch.Tensor:
    """Shard s's block of the whole tensor ``t``, a view."""
    for d, start, ln in block_slices(t.shape, pspec, mesh, s):
        t = t.narrow(d, start, ln)
    return t


def piece(t: torch.Tensor, pspec, mesh: Mesh, s: int) -> torch.Tensor:
    """Shard s's block of the whole tensor ``t``: a fresh tensor on
    shard s's device."""
    v = block_view(t, pspec, mesh, s)
    out = torch.empty(v.shape, dtype=v.dtype, device=mesh.devices[s])
    return out.copy_(v)


def holders(mesh: Mesh, pspec) -> List[int]:
    """One shard for each distinct block of a leaf laid out by
    ``pspec``: those at position 0 on every axis the spec does not
    name."""
    named = set(spec_axes(pspec))
    return [s for s in range(mesh.size)
            if all(v == 0 for a, v in coords(mesh, s).items()
                   if a not in named)]


def assemble(parts: Sequence[torch.Tensor], shape: Sequence[int], pspec,
             mesh: Mesh, device) -> torch.Tensor:
    """The whole leaf of ``shape`` from its shards' blocks (``parts[s]``
    shard s's), a fresh tensor on ``device``."""
    out = torch.empty(tuple(shape), dtype=parts[0].dtype, device=device)
    for s in holders(mesh, pspec):
        block_view(out, pspec, mesh, s).copy_(parts[s])
    return out


def _report(kind: str, nbytes_: int, members: int, group: int) -> None:
    """Count one collective over ``group`` shards of which ``members``
    receive ``nbytes_`` each; a group of one moves nothing."""
    if counting.ACTIVE is not None and group > 1:
        counting.ACTIVE.collective(kind, nbytes_, members)


def all_reduce(parts: Sequence[torch.Tensor], mesh: Mesh,
               axes: Optional[Sequence[str]] = None, op: str = "sum"
               ) -> List[torch.Tensor]:
    """Every shard's result of combining the parts of its group (the
    shards that differ only in ``axes``; default every axis): the parts
    are gathered to the group's first device and combined in shard order,
    a "sum" in float32 and cast back to the parts' dtype, or the
    elementwise "max"; each shard gets its own copy, never an alias of
    another shard's."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op {op!r}")
    out: List[Any] = [None] * mesh.size
    for g in groups(mesh, axes):
        _report("all-reduce", counting.nbytes(parts[g[0]]), len(g), len(g))
        dev = mesh.devices[g[0]]
        if op == "sum":
            acc = parts[g[0]].to(dev, dtype=torch.float32, copy=True)
            for s in g[1:]:
                acc += parts[s].to(dev)
            acc = acc.to(parts[g[0]].dtype)
        else:
            acc = parts[g[0]].to(dev, copy=True)
            for s in g[1:]:
                acc = torch.maximum(acc, parts[s].to(dev))
        out[g[0]] = acc
        for s in g[1:]:
            out[s] = acc.to(mesh.devices[s], copy=True)
    return out


def reduce_scatter(parts: Sequence[torch.Tensor], pspec, mesh: Mesh,
                   axes: Sequence[str]) -> List[torch.Tensor]:
    """``parts[s]`` is shard s's whole-leaf term; shard s gets its block
    (by ``pspec``) of the sum over its group (the shards that differ only
    in ``axes``): the group's blocks added in shard order in float32 on
    shard s's device and cast back to the parts' dtype. ``pspec`` may
    also split over axes outside ``axes``: those blocks are cut locally,
    with nothing to reduce."""
    out: List[Any] = [None] * mesh.size
    for g in groups(mesh, axes):
        for s in g:
            dev = mesh.devices[s]
            acc = block_view(parts[g[0]], pspec, mesh, s).to(
                dev, dtype=torch.float32, copy=True)
            for t in g[1:]:
                acc += block_view(parts[t], pspec, mesh, s).to(dev)
            out[s] = acc.to(parts[g[0]].dtype)
        _report("reduce-scatter", counting.nbytes(out[g[0]]), len(g),
                len(g))
    return out


def gather_whole(parts: Sequence[torch.Tensor], shape: Sequence[int],
                 pspec, mesh: Mesh, device) -> torch.Tensor:
    """The whole leaf assembled from its shards' blocks on ``device``:
    the all-gather over the axes ``pspec`` names, counted as one device
    receiving the whole leaf (the device that computes on it)."""
    _report("all-gather", math.prod(shape) * parts[0].element_size(), 1,
            math.prod(mesh.shape[a] for a in spec_axes(pspec)))
    return assemble(parts, shape, pspec, mesh, device)


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
    _report("all-gather", sum(counting.nbytes(p) for p in parts),
            len(parts), len(parts))
    return broadcast(gather(parts, dim, mesh), mesh)
