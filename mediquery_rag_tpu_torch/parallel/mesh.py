"""Named device meshes (port of ``mediquery_rag_tpu/parallel/mesh.py``).

A :class:`Mesh` is an array of ``torch.device`` with one name per axis, in
the JAX package's row-major layout. A device may appear more than once, so
several shards can share one card (or, in tests, the CPU). With
``devices=None`` a mesh spans the visible CUDA devices and raises when
there are none: it never falls back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray            # object array of torch.device, one dim per axis
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list[torch.device]:
        """The devices in row-major order: shard ``s`` of a corpus split
        over every axis lives on ``flat()[s]``."""
        return list(self.devices.reshape(-1))


def _visible_cuda() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass devices= to build a mesh "
                           "on other devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _devices(devices) -> list[torch.device]:
    return _visible_cuda() if devices is None else [torch.device(d) for d in devices]


def make_mesh(shape: dict[str, int], devices=None) -> Mesh:
    """Build a mesh with named axes, e.g. ``{"data": 4, "model": 2}``, from
    the first ``prod(shape)`` of ``devices`` (default: the visible cards)."""
    devices = _devices(devices)
    sizes = list(shape.values())
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(sizes), tuple(shape.keys()))


def corpus_mesh(n_shards: int | None = None, axis: str = "shard", devices=None) -> Mesh:
    """1-D mesh over which the corpus rows are sharded (one shard per
    device; ``n_shards`` defaults to the number of devices)."""
    devices = _devices(devices)
    n = len(devices) if n_shards is None else n_shards
    return make_mesh({axis: n}, devices)


def slice_mesh(n_slices: int, per_slice: int | None = None, *, dcn_axis: str = "dcn",
               ici_axis: str = "shard", devices=None) -> Mesh:
    """2-D ``(dcn, ici)`` mesh: the outer axis spans groups of devices (the
    JAX package's slices), the inner one the devices of a group, which are
    consecutive in ``devices``. The merge over it is hierarchical
    (``collectives.hierarchical_topk_merge``)."""
    devices = _devices(devices)
    if per_slice is None:
        if len(devices) % n_slices:
            raise ValueError(f"{len(devices)} devices do not divide into {n_slices} slices")
        per_slice = len(devices) // n_slices
    return make_mesh({dcn_axis: n_slices, ici_axis: per_slice}, devices)
