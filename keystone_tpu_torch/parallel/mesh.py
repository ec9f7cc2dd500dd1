"""The device-mesh enumeration (counterpart of the enumeration half of
keystone_tpu/parallel/mesh.py).

A :class:`Mesh` is a plain record over ``torch.device`` s: a numpy object
array of devices shaped ``(data, model)``, its axis names, and a ``shape``
mapping, so ``mesh.shape["data"]`` reads as it does on a ``jax`` mesh.
Building one opens no process group and needs no card
(``torch.device("cuda:3")`` constructs without one); the placement search
(``core.autoshard``) enumerates candidate factorizations over it.

Not ported: the sharding helpers (``row_sharding``, ``padded_shard_rows``,
``parse_mesh``, ``mask_pad_rows``, ``pad_shard_inputs``) and every
collective, which run a mesh rather than describe one (ROADMAP Queue 1
item 15).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` grid of devices."""

    devices: np.ndarray  #: object array of ``torch.device``, one axis per name
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def default_devices() -> list:
    """Every CUDA card of this process, or the CPU when there is none (the
    counterpart of ``jax.devices()``)."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def make_mesh(data: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Build a (data, model) mesh.  ``data=None`` uses all remaining devices."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    arr = np.empty(data * model, dtype=object)
    arr[:] = devices[: data * model]
    return Mesh(arr.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def reduced_mesh(mesh: Mesh) -> Mesh | None:
    """The next rung of the mesh degradation ladder: the SAME devices with
    the ``model`` axis collapsed into ``data`` — ``(data=4, model=2)`` →
    ``(data=8, model=1)``.  ``None`` when the mesh is already pure
    data-parallel (the next rung is the single-device floor)."""
    if mesh.shape[MODEL_AXIS] <= 1:
        return None
    devices = list(mesh.devices.flat)
    return make_mesh(data=len(devices), model=1, devices=devices)


def mesh_desc(mesh: Mesh) -> str:
    """``'4x2'`` — the (data, model) shape tag used in tier names."""
    return f"{mesh.shape[DATA_AXIS]}x{mesh.shape[MODEL_AXIS]}"


@functools.lru_cache(maxsize=None)
def _mesh_shapes(n_devices: int) -> tuple[tuple[int, int], ...]:
    """Memoized factorization body of :func:`enumerate_mesh_shapes` (the
    placement search re-enumerates on every fit; the device count never
    changes within a process)."""
    if n_devices < 1:
        raise ValueError(f"need >= 1 device, got {n_devices}")
    return tuple(
        (d, n_devices // d)
        for d in range(n_devices, 0, -1)
        if n_devices % d == 0
    )


def enumerate_mesh_shapes(n_devices: int) -> list[tuple[int, int]]:
    """Every (data, model) factorization of ``n_devices``, data-major
    descending: ``[(1, 1)]`` for one device, exactly the two degenerate
    factorizations for a prime count.  Memoized per device count; a fresh
    list is returned per call."""
    return list(_mesh_shapes(n_devices))


#: device tuple -> candidate meshes over exactly those devices, in order.
_mesh_cache: dict[tuple, tuple[Mesh, ...]] = {}


def enumerate_meshes(devices) -> list[Mesh]:
    """:func:`enumerate_mesh_shapes` materialized over a fixed device list:
    the same devices in the same order for every candidate, so two searches
    over one device set enumerate identical meshes.  Memoized per device
    tuple; a fresh list is returned per call."""
    key = tuple(devices)
    cached = _mesh_cache.get(key)
    if cached is None:
        cached = _mesh_cache[key] = tuple(
            make_mesh(data=d, model=m, devices=list(key))
            for d, m in _mesh_shapes(len(key))
        )
    return list(cached)
