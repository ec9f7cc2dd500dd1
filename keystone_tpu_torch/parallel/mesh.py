"""The device mesh and its row-sharded arrays (counterpart of
keystone_tpu/parallel/mesh.py, one process).

A :class:`Mesh` is a ``(data, model)`` grid of device SLOTS in this process:
a numpy object array of ``torch.device`` s, its axis names, and a ``shape``
mapping, so ``mesh.shape["data"]`` reads as it does on a ``jax`` mesh.  A
device may fill more than one slot (``make_mesh(4, 2, devices=[dev] * 8)``):
each entry is a slot of its own, the counterpart of the JAX tests' virtual
CPU devices, so eight slots run on one CPU or one card.  Building one opens
no process group and needs no card.

A :class:`ShardedRows` is the counterpart of a ``jax.Array`` under
``row_sharding``: an explicit record of per-slot tensors, the rows split in
order over the data axis (zero pad rows make the count a multiple of the
axis) and replicated over the model axis; ``nvalid`` counts the true rows.
Work on it runs slot by slot (:meth:`ShardedRows.apply`), each slot inside
its device's scope (``utils.platform.device_scope``), and reductions over
the data axis are ``parallel.collectives``' fixed-order sums.  Where the JAX
package hands a sharded array to ``jnp`` code, the port calls a sharded form
explicitly or gathers the rows in data order (:meth:`ShardedRows.gather`).

A :class:`SpecSharding` is a spec string of the placement search
(``core.autoshard.spec_sharding``: ``replicated``, ``data@dimN``,
``model@dimN``) lowered onto a mesh, the counterpart of a ``NamedSharding``:
its per-slot index map equals ``NamedSharding.devices_indices_map`` slot
for slot.  :meth:`SpecSharding.place` builds the layout: ``data@dim0`` is a
``ShardedRows`` (so the default layout keeps its bits), every other spec a
:class:`SpecLayout`, an explicit record of per-slot tensors.  Slots of one
device share one copy of what they hold; admission charges every slot its
own bytes all the same (:func:`slot_nbytes`).

A layout record is not a tensor: a PyTorch operator handed one raises the
typed :class:`LayoutLeafError`.  A node restored onto a mesh
(``core.checkpoint.load_pipeline(mesh=)``) holds records as its leaves and
computes once they are lowered: :func:`replicate` turns every record a node
holds into the whole tensor on one device (a ``SpecLayout``'s window over
its whole shape, read on a slot of that device; a ``ShardedRows``' rows
joined in data order), one copy per device, and then builds the node's
derived state (``_restore``).  So ``map_rows(node, rows)`` runs a restored
node slot by slot on sharded rows, and ``replicate(node, x.device)(x)`` on
a plain tensor; the lowering moves bytes and does no arithmetic.  A
``Pipeline`` hands sharded rows to each node that computes on tensors
through :func:`map_rows` (``core.pipeline``).

**Meshes that span processes.**  Each slot records the rank of the process
that owns it (``Mesh.ranks``; None means every slot is this process's, the
single-process mesh) and the mesh records which rank is this process
(``Mesh.me``).  With a live ``parallel.distributed`` group of more than one
rank, :func:`make_mesh` with no devices gathers every rank's local slots in
rank order into one data axis (the counterpart of ``jax.devices()`` turning
global after ``jax.distributed`` bring-up); ``make_mesh(..., ranks=, me=)``
builds one from explicit per-slot ranks.  :func:`mesh_spans_processes` says
whether a mesh holds another process's slots, :func:`host_local_mesh` is the
pure-data mesh over this process's.  On a spanning mesh a ``ShardedRows`` or
``SpecLayout`` holds tensors for this process's slots only (None for the
others); ``addressable_shards()`` lists each of them with its index window
of the whole, the counterpart of ``jax.Array.addressable_shards``.  Nothing
computes across processes: every consumer that would read another process's
slot (``gather``, ``apply``, :func:`map_rows`, :func:`unshard`,
:func:`replicate`, :func:`padded_shard_rows` and so the solvers' mesh tiers,
the ``Cacher``) raises the typed :class:`SpanningMeshError` naming the mesh,
where the JAX package's GSPMD would run one program over every process.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools

import numpy as np
import torch

from ..utils.platform import device_scope, resolve_device
from . import distributed as kdist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` grid of devices.  ``ranks`` (an int array of the
    grid's shape, or None for a mesh of this process alone) is each slot's
    owning process; ``me`` is this process's rank.  A slot of another
    process names that process's device (``cuda:0`` there)."""

    devices: np.ndarray  #: object array of ``torch.device``, one axis per name
    axis_names: tuple
    ranks: np.ndarray | None = None
    me: int = 0

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def owns(self, slot: tuple) -> bool:
        """Is slot ``(d, m)`` this process's?"""
        return self.ranks is None or int(self.ranks[slot]) == self.me

    def local_slots(self) -> list[tuple]:
        """This process's slots, in data-major order."""
        return [s for s in np.ndindex(self.devices.shape) if self.owns(s)]


def default_devices() -> list:
    """This process's devices (the counterpart of ``jax.local_devices()``):
    ``KEYSTONE_DIST_DEVICE`` that many times where ``KEYSTONE_DIST_LOCAL_SLOTS``
    is set (a spawned worker's slots, ``parallel.distributed.worker_env``),
    else every CUDA card, or the CPU when there is none."""
    slots = kdist.local_slots()
    if slots is not None:
        return [resolve_device(slots[0])] * slots[1]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def make_mesh(data: int | None = None, model: int = 1, devices=None, *, ranks=None,
              me: int | None = None) -> Mesh:
    """Build a (data, model) mesh.  ``data=None`` uses all remaining devices.

    ``devices=None`` takes :func:`default_devices`, or, with a live process
    group of more than one rank (``parallel.distributed``), every rank's
    in rank order: a mesh spanning the processes.  ``ranks`` (one per
    device, in the same order) and ``me`` build a spanning mesh from
    explicit owners; ``me`` defaults to this process's rank."""
    if devices is None and ranks is None and kdist.process_count() > 1:
        local = [str(d) for d in default_devices()]
        per_rank = kdist.all_gather_object(local)
        if len(per_rank) > 1:
            devices = [torch.device(d) for part in per_rank for d in part]
            ranks = [r for r, part in enumerate(per_rank) for _ in part]
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
    owners = None
    if ranks is not None:
        if len(ranks) != n:
            raise ValueError(f"{len(ranks)} slot ranks for {n} devices")
        owners = np.asarray(ranks[: data * model], dtype=np.int64).reshape(data, model)
    me = kdist.process_index() if me is None else int(me)
    return Mesh(arr.reshape(data, model), (DATA_AXIS, MODEL_AXIS), owners, me)


def _flat_ranks(mesh: Mesh):
    return None if mesh.ranks is None else [int(r) for r in mesh.ranks.flat]


def reduced_mesh(mesh: Mesh) -> Mesh | None:
    """The next rung of the mesh degradation ladder: the SAME devices with
    the ``model`` axis collapsed into ``data`` — ``(data=4, model=2)`` →
    ``(data=8, model=1)``.  ``None`` when the mesh is already pure
    data-parallel (the next rung is the single-device floor)."""
    if mesh.shape[MODEL_AXIS] <= 1:
        return None
    devices = list(mesh.devices.flat)
    return make_mesh(data=len(devices), model=1, devices=devices, ranks=_flat_ranks(mesh),
                     me=mesh.me)


def mesh_spans_processes(mesh: Mesh) -> bool:
    """Does this mesh hold slots owned by OTHER processes?  Every consumer
    that computes, stages host memory or serves requests must know whether
    all of the mesh is addressable from here.  Always False
    single-process."""
    return mesh.ranks is not None and bool((mesh.ranks != mesh.me).any())


def host_local_mesh(mesh: Mesh | None = None) -> Mesh:
    """The pure-data mesh over THIS process's slots.  ``mesh`` given: its
    slots owned here, in data-major order (the serving anchor for a host in
    a fleet — engines never span hosts), ``ValueError`` where it has none;
    omitted: :func:`default_devices`."""
    if mesh is None:
        local = default_devices()
    else:
        local = [mesh.devices[s] for s in mesh.local_slots()]
        if not local:
            raise ValueError(f"mesh {mesh_desc(mesh)} has no slots on process {mesh.me}")
    return make_mesh(data=len(local), model=1, devices=local, ranks=None)


class SpanningMeshError(RuntimeError):
    """A consumer that computes was handed a mesh, or a layout on one, that
    spans processes: the port runs no program over another process's
    slots."""


def require_local(mesh: Mesh, what: str) -> None:
    """Raise :class:`SpanningMeshError` naming ``mesh`` and ``what`` when
    the mesh spans processes."""
    if mesh is not None and mesh_spans_processes(mesh):
        raise SpanningMeshError(
            f"{what}: mesh {mesh_desc(mesh)} spans processes (process {mesh.me} owns "
            f"{len(mesh.local_slots())} of its {mesh.size} slots) — nothing computes on "
            "another process's slots; use host_local_mesh(mesh), or read this process's "
            "windows through addressable_shards()")


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
            for d, m in enumerate_mesh_shapes(len(key))
        )
    return list(cached)


_current_mesh: list[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Set the ambient mesh the estimators shard their inputs over."""
    _current_mesh.append(mesh)
    try:
        yield mesh
    finally:
        _current_mesh.pop()


def current_mesh() -> Mesh | None:
    return _current_mesh[-1] if _current_mesh else None


def parse_mesh(spec: str | None, device="cuda") -> Mesh | None:
    """Parse a ``--mesh`` flag over the distinct devices of the CLI's
    ``--device`` kind: ``"8"`` -> 8-way data mesh, ``"4x2"`` -> (data=4,
    model=2); None/empty -> no mesh.  ``cuda`` without a card raises, as
    ``utils.platform.resolve_device`` does; the CPU is one device."""
    if not spec:
        return None
    parts = spec.lower().split("x")
    if (
        len(parts) > 2
        or not all(p.strip().isdigit() for p in parts)
        or any(int(p) == 0 for p in parts)
    ):
        raise ValueError(
            f"bad --mesh spec {spec!r}: expected 'DATA' or 'DATAxMODEL' "
            "with positive sizes (e.g. '8' or '4x2')"
        )
    data = int(parts[0])
    model = int(parts[1]) if len(parts) > 1 else 1
    return make_mesh(data=data, model=model, devices=kind_devices(device))


def kind_devices(device="cuda") -> list:
    """The distinct devices of ``device``'s kind: every card, or the one
    CPU.  ``cuda`` without a card raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def add_mesh_flag(p) -> None:
    """The workload CLIs' ``--mesh`` flag."""
    p.add_argument(
        "--mesh", default=None,
        help="device mesh over the --device kind, e.g. '8' (data) or '4x2' (data x model)",
    )


def device_key(device) -> tuple:
    """``(type, index)`` of a device: ``cuda`` and ``cuda:0`` are one card."""
    d = torch.device(device)
    return d.type, d.index or 0


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Do two slots' devices hold the same memory?  ``cuda`` and ``cuda:0``
    are one card; every CPU device index is the one host memory."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    return (a.index or 0) == (b.index or 0)


def on_slot(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` in ``device``'s memory: the tensor itself when it is there."""
    return t if _same_device(t.device, device) else t.to(device)


class LayoutLeafError(RuntimeError):
    """A mesh layout record (``ShardedRows``, ``SpecLayout``) reached a
    PyTorch operator, which takes tensors.  (Not a ``TypeError``: PyTorch
    turns one raised inside a binary operator into ``NotImplemented``.)"""


class _LayoutRecord:
    """Refuses PyTorch operators, typed (``__torch_function__``)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", func)
        raise LayoutLeafError(
            f"{cls.__name__} handed to torch {name}: a mesh layout is not a tensor — "
            "lower it with parallel.mesh.replicate(obj, device) or gather(), or run the "
            "node over sharded rows with parallel.mesh.map_rows")


@dataclasses.dataclass(eq=False)
class ShardedRows(_LayoutRecord):
    """Rows of one array over a mesh: ``shards[d][m]`` is data block ``d``
    (``rows // data`` rows, in order) on slot ``(d, m)``'s device.  Rows at
    index >= ``nvalid`` are pad rows, zero where the record was made.
    Slots that share a device share the tensor.  On a mesh spanning
    processes another process's slots hold None."""

    mesh: Mesh
    shards: list  #: [data][model] -> torch.Tensor
    nvalid: int

    def _block(self) -> torch.Tensor:
        """A data block this process holds."""
        if self.mesh.ranks is None:
            return self.shards[0][0]
        d, m = self.mesh.local_slots()[0]
        return self.shards[d][m]

    @property
    def rows(self) -> int:
        """Rows over all data blocks, pad rows included."""
        if mesh_spans_processes(self.mesh):
            return int(self._block().shape[0]) * len(self.shards)
        return sum(int(row[0].shape[0]) for row in self.shards)

    @property
    def shape(self) -> tuple:
        return (self.rows, *self._block().shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self._block().dtype

    def addressable_shards(self) -> list[tuple]:
        """``(slot, index, tensor)`` for each of this process's slots:
        ``index`` is the slot's window of the whole (a tuple of slices)."""
        per = int(self._block().shape[0])
        rest = (slice(None),) * (len(self.shape) - 1)
        return [((d, m), (slice(d * per, (d + 1) * per), *rest), self.shards[d][m])
                for d, m in self.mesh.local_slots()]

    @property
    def nbytes(self) -> int:
        """Bytes of the whole array, pad rows included (``jax.Array.nbytes``)."""
        return sum(b.numel() * b.element_size() for b in self.data_blocks())

    def data_blocks(self) -> list[torch.Tensor]:
        """One tensor per data index (model slot 0's), in data order."""
        require_local(self.mesh, "ShardedRows.data_blocks")
        return [row[0] for row in self.shards]

    def gather(self, device=None) -> torch.Tensor:
        """The true rows, in data order, on ``device`` (slot (0, 0)'s by
        default)."""
        dev = self.mesh.devices[0, 0] if device is None else device
        return torch.cat([on_slot(b, dev) for b in self.data_blocks()])[: self.nvalid]

    def apply(self, fn) -> "ShardedRows":
        """``fn`` on every slot's rows, inside the scope of the slot's
        device, with ``fn`` replicated to that device once
        (:func:`replicate`).  Row-wise functions only:
        pad rows stay where they were, and ``nvalid`` is kept.  The model
        slots of a data block that share a device share its tensor, so
        they share ``fn``'s result too: it runs once per data block and
        device."""
        require_local(self.mesh, "ShardedRows.apply")
        replicas: dict = {}

        def run(d, m, t):
            dev = self.mesh.devices[d, m]
            key = device_key(dev)
            if key not in replicas:
                replicas[key] = replicate(fn, dev)
            with device_scope(dev):
                return replicas[key](t)

        return ShardedRows(self.mesh, _per_distinct(self.shards, run), self.nvalid)


def _per_distinct(shards: list, fn) -> list:
    """``fn(d, m, t)`` for each slot's tensor ``t``, once per distinct tensor
    of a data block: slots holding the same tensor get the same result."""
    out = []
    for d, row in enumerate(shards):
        done: list = []  # (input, result), by identity
        out_row = []
        for m, t in enumerate(row):
            hit = next((r for src, r in done if src is t), None)
            if hit is None:
                hit = fn(d, m, t)
                done.append((t, hit))
            out_row.append(hit)
        out.append(out_row)
    return out


def replicate(obj, device):
    """``obj`` with every tensor it holds in ``device``'s memory: a tensor,
    a layout record (lowered to the whole tensor: :func:`lower`), a list,
    tuple or dict, or a pipeline node (``core.pipeline.Transformer``: a
    shallow copy with its attributes replicated, a ``torch.device``
    attribute among them; a node that held layout records builds its
    derived state, ``_restore``, from the lowered tensors).  Anything else,
    and anything already there, is returned as it is.  A record on a mesh
    spanning processes raises :class:`SpanningMeshError`."""
    if isinstance(obj, torch.Tensor):
        return on_slot(obj, device)
    if isinstance(obj, (ShardedRows, SpecLayout)):
        return lower(obj, device)
    if isinstance(obj, torch.device):
        return obj if _same_device(obj, device) else torch.device(device)
    if isinstance(obj, (list, tuple)):
        items = [replicate(o, device) for o in obj]
        if all(a is b for a, b in zip(items, obj)):
            return obj
        return type(obj)(items)
    if isinstance(obj, dict):
        out = {k: replicate(v, device) for k, v in obj.items()}
        return obj if all(out[k] is v for k, v in obj.items()) else out
    from ..core.pipeline import Transformer

    if not isinstance(obj, Transformer):
        return obj
    fields = {k: replicate(v, device) for k, v in vars(obj).items()}
    if all(v is getattr(obj, k) for k, v in fields.items()):
        return obj
    out = copy.copy(obj)
    vars(out).update(fields)
    restore = getattr(out, "_restore", None)
    if restore is not None and any(holds_record(v) for v in vars(obj).values()):
        restore()
    return out


def lower(record, device) -> torch.Tensor:
    """A layout record as the whole tensor on ``device``: a ``ShardedRows``'
    true rows joined in data order, a ``SpecLayout``'s window over its whole
    shape read on a slot of that device (slot (0, 0) when none is), so a
    slot holding the whole tensor gives a view of its piece.  Bytes move;
    nothing is computed."""
    if isinstance(record, ShardedRows):
        return record.gather(device)
    slot = next((s for s in np.ndindex(record.mesh.devices.shape)
                 if _same_device(record.mesh.devices[s], device)), (0, 0))
    whole = record.window(tuple(slice(None) for _ in record.shape), slot)
    return on_slot(whole, device)


def holds_record(v) -> bool:
    """Is ``v`` a layout record, or a list or tuple holding one?"""
    if isinstance(v, (list, tuple)):
        return any(holds_record(o) for o in v)
    return isinstance(v, (ShardedRows, SpecLayout))


def padded_shard_rows(x, mesh: Mesh | None = None, nvalid: int | None = None):
    """Pad N up to a multiple of the data-axis size with zero rows, shard,
    return ``(x, nvalid)``.

    ``x`` is a host array, a tensor, or a :class:`ShardedRows` of another
    layout (its true rows are gathered and sharded anew).  Each data block
    of a tensor already in a slot's memory is a view of it, not a copy;
    only the block that takes pad rows is new.  Zero rows contribute
    nothing to raw sums, but an estimator that centres data must be told
    ``nvalid`` (pad rows become ``-mean``): the solvers' ``fit(...,
    nvalid=)`` masks them back to zero.  Without a mesh (none given and
    none ambient) ``x`` comes back as a tensor with its row count.  A mesh
    spanning processes raises :class:`SpanningMeshError`."""
    mesh = mesh or current_mesh()
    require_local(mesh, "padded_shard_rows")
    if isinstance(x, ShardedRows):
        if mesh is None or _same_layout(x.mesh, mesh):
            return x, x.nvalid
        x = x.gather()
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    n = int(x.shape[0]) if nvalid is None else int(nvalid)
    x = x[:n]
    if mesh is None:
        return x, n
    d_sz = mesh.shape[DATA_AXIS]
    per = -(-n // d_sz) if n else 0
    shards = []
    for d in range(d_sz):
        block = x[d * per : (d + 1) * per]
        if block.shape[0] < per:
            pad = x.new_zeros((per - block.shape[0], *x.shape[1:]))
            block = torch.cat([block, pad])
        row: list = []
        for dev in mesh.devices[d]:
            same = next((t for t in row if _same_device(t.device, dev)), None)
            row.append(same if same is not None else on_slot(block, dev))
        shards.append(row)
    return ShardedRows(mesh, shards, n), n


class SpecSharding:
    """A spec lowered onto ``mesh``: ``spec`` holds one entry per dimension,
    the mesh axis that splits it (``DATA_AXIS`` or ``MODEL_AXIS``) or None,
    with at most one axis named (the spec vocabulary names one).  A split
    dimension is cut in order into equal pieces over its axis and the
    tensor is replicated over the other axis."""

    def __init__(self, mesh: Mesh, spec: tuple):
        named = [(dim, ax) for dim, ax in enumerate(spec) if ax is not None]
        if len(named) > 1 or any(ax not in mesh.axis_names for _dim, ax in named):
            raise ValueError(f"a spec layout splits one dimension over one mesh axis, got {spec}")
        self.mesh, self.spec = mesh, tuple(spec)
        #: (dim, axis) of the split, None when every slot holds the whole
        #: tensor (no axis named, or the named axis has size 1).
        self.split = named[0] if named and mesh.shape[named[0][1]] > 1 else None

    def __repr__(self) -> str:
        return f"SpecSharding(mesh {mesh_desc(self.mesh)}, {self.spec})"

    def devices_indices_map(self, shape) -> dict:
        """Slot ``(d, m)`` -> the tuple of slices of a ``shape`` tensor that
        the slot holds (``slice(None)`` for a dimension held whole).  A
        split dimension that its axis does not divide raises
        ``ValueError``."""
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(self.spec):
            raise ValueError(f"{self} places {len(self.spec)}-d tensors, got shape {shape}")
        whole = (slice(None),) * len(shape)
        d_sz, m_sz = self.mesh.devices.shape
        if self.split is None:
            return {(d, m): whole for d in range(d_sz) for m in range(m_sz)}
        dim, axis = self.split
        size = self.mesh.shape[axis]
        if shape[dim] % size:
            raise ValueError(
                f"{self}: dimension {dim} of size {shape[dim]} is not a multiple of the "
                f"{axis} axis ({size}); pad it first")
        per = shape[dim] // size
        out = {}
        for d in range(d_sz):
            for m in range(m_sz):
                at = d if axis == DATA_AXIS else m
                idx = list(whole)
                idx[dim] = slice(at * per, (at + 1) * per)
                out[d, m] = tuple(idx)
        return out

    @property
    def spec_string(self) -> str:
        """The spec this layout was lowered from (``core.autoshard``'s
        vocabulary): ``'replicated'`` when every slot holds the whole
        tensor, else ``'<axis>@dim<N>'``."""
        if self.split is None:
            return "replicated"
        dim, axis = self.split
        return f"{axis}@dim{dim}"

    def _rows(self) -> bool:
        """Is this the rows-over-the-data-axis layout (``data@dim0``)?"""
        return self.spec[:1] == (DATA_AXIS,) and all(ax is None for ax in self.spec[1:])

    def holds(self, record) -> bool:
        """Is ``record`` already laid out this way on this mesh's devices?"""
        if isinstance(record, ShardedRows):
            return (self._rows() and len(record.shape) == len(self.spec)
                    and _same_layout(record.mesh, self.mesh))
        return (isinstance(record, SpecLayout) and record.sharding.spec == self.spec
                and _same_layout(record.mesh, self.mesh))

    def place(self, t: torch.Tensor):
        """``t`` laid out on the mesh.  Rows over the data axis
        (``data@dim0``) give the ``ShardedRows`` of :func:`padded_shard_rows`
        (no pad rows: the axis must divide them); any other spec a
        :class:`SpecLayout`.  A slot on ``t``'s device holds a view of
        ``t``; slots of one device share one tensor.  On a mesh spanning
        processes only this process's slots are filled."""
        index = self.devices_indices_map(t.shape)
        if self._rows() and not mesh_spans_processes(self.mesh):
            return padded_shard_rows(t, self.mesh)[0]
        return self._assemble(tuple(int(n) for n in t.shape), index,
                              lambda idx, dev: on_slot(t[idx], dev))

    def place_staged(self, t: torch.Tensor):
        """:meth:`place` for a tensor in host memory, copied window by
        window: each distinct (device, window) once, one copy at a time,
        so no device ever stages the whole tensor."""
        shape = tuple(int(n) for n in t.shape)
        return self._assemble(shape, self.devices_indices_map(shape),
                              lambda idx, dev: t[idx].to(dev))

    def _assemble(self, shape: tuple, index: dict, piece):
        """The record whose slot ``(d, m)`` holds ``piece(index[d, m],
        device)``, made once per distinct (device, window); another
        process's slot holds None."""
        held: dict = {}
        shards = []
        for d, row in enumerate(self.mesh.devices):
            out_row = []
            for m, dev in enumerate(row):
                if not self.mesh.owns((d, m)):
                    out_row.append(None)
                    continue
                key = (device_key(dev), index[d, m])
                if key not in held:
                    held[key] = piece(index[d, m], dev)
                out_row.append(held[key])
            shards.append(out_row)
        if self._rows():
            return ShardedRows(self.mesh, shards, shape[0])
        return SpecLayout(self, shape, shards)


@dataclasses.dataclass(eq=False)
class SpecLayout(_LayoutRecord):
    """One tensor of global ``shape`` laid out by ``sharding``:
    ``shards[d][m]`` is the piece slot ``(d, m)`` holds, on its device
    (``sharding.devices_indices_map(shape)[d, m]`` of the whole); None for
    another process's slot."""

    sharding: SpecSharding
    shape: tuple
    shards: list  #: [data][model] -> torch.Tensor

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def dtype(self) -> torch.dtype:
        d, m = self.mesh.local_slots()[0] if self.mesh.ranks is not None else (0, 0)
        return self.shards[d][m].dtype

    def index_map(self) -> dict:
        """Slot ``(d, m)`` -> the slices of the whole tensor it holds."""
        return self.sharding.devices_indices_map(self.shape)

    def addressable_shards(self) -> list[tuple]:
        """``(slot, index, tensor)`` for each of this process's slots."""
        own = self.index_map()
        return [(s, own[s], self.shards[s[0]][s[1]]) for s in self.mesh.local_slots()]

    def gather(self) -> torch.Tensor:
        """The whole tensor on slot (0, 0)'s device."""
        return self.window(tuple(slice(None) for _ in self.shape), (0, 0))

    def window(self, index: tuple, slot: tuple) -> torch.Tensor:
        """The ``index`` window (a tuple of slices, one per dimension) of
        the whole tensor on ``slot``'s device: a view of the slot's own
        piece when it holds the window, else the pieces of the slots along
        the split axis (in the slot's own row or column of the mesh) that
        hold it, copied to the slot's device and joined in order."""
        require_local(self.mesh, "SpecLayout.window")
        index = tuple(slice(*s.indices(int(n))) for s, n in zip(index, self.shape))
        own = self.index_map()
        dev = self.mesh.devices[slot]

        def local(at, want):
            got = own[at]
            return tuple(slice(w.start - (g.start or 0), w.stop - (g.start or 0))
                         for w, g in zip(want, got))

        if _covers(own[slot], index, self.shape):
            return on_slot(self.shards[slot[0]][slot[1]][local(slot, index)], dev)
        dim, axis = self.sharding.split
        size = self.mesh.shape[axis]
        parts = []
        for at in range(size):
            src = (at, slot[1]) if axis == DATA_AXIS else (slot[0], at)
            piece = own[src][dim]
            lo, hi = max(piece.start, index[dim].start), min(piece.stop, index[dim].stop)
            if lo >= hi:
                continue
            want = list(index)
            want[dim] = slice(lo, hi)
            parts.append(on_slot(self.shards[src[0]][src[1]][local(src, tuple(want))], dev))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _covers(held: tuple, index: tuple, shape: tuple) -> bool:
    """Does the ``held`` window contain ``index`` (both slices of ``shape``)?"""
    for h, w, n in zip(held, index, shape):
        lo, hi, _ = h.indices(int(n))
        if w.start < lo or w.stop > hi:
            return False
    return True


def slot_nbytes(record) -> np.ndarray:
    """``[data, model]``: the bytes each slot of a ``ShardedRows`` or
    :class:`SpecLayout` holds, as admission charges them (slots sharing a
    device's tensor each counted; another process's slots 0)."""
    return np.array([[0 if t is None else int(t.numel()) * t.element_size() for t in row]
                     for row in record.shards], dtype=np.int64)


def _same_layout(a: Mesh, b: Mesh) -> bool:
    """Do two meshes put each data block on the same devices of the same
    processes?"""
    return a.devices.shape == b.devices.shape and _flat_ranks(a) == _flat_ranks(b) and all(
        _same_device(p, q) for p, q in zip(a.devices.flat, b.devices.flat)
    )


def mask_pad_rows(x, nvalid: int | None = None):
    """Zero the rows at index >= ``nvalid`` (a ``ShardedRows``' own).

    Needed after a featurizer that maps zero pad rows to nonzero outputs
    (``cos(0·W + b)`` in CosineRandomFeatures, a convolution's patch
    normalisation), so moment sums over the padded rows stay exact."""
    if isinstance(x, ShardedRows):
        offsets = np.cumsum([0] + [int(b.shape[0]) for b in x.data_blocks()])
        out = _per_distinct(x.shards, lambda d, m, t: _mask_rows(t, x.nvalid - int(offsets[d])))
        return ShardedRows(x.mesh, out, x.nvalid)
    if nvalid is None or x.shape[0] == nvalid:
        return x
    return _mask_rows(x, nvalid)


def map_rows(fn, x):
    """``fn`` on ``x``; on row-sharded rows slot by slot
    (:meth:`ShardedRows.apply`), the pad rows zeroed again.  Rows on a mesh
    spanning processes raise :class:`SpanningMeshError`."""
    if isinstance(x, ShardedRows):
        return mask_pad_rows(x.apply(fn))
    return fn(x)


def unshard(x):
    """The true rows of ``x`` as one tensor (:meth:`ShardedRows.gather`;
    rows on a mesh spanning processes raise :class:`SpanningMeshError`);
    anything else as it is."""
    return x.gather() if isinstance(x, ShardedRows) else x


def _mask_rows(t: torch.Tensor, keep: int) -> torch.Tensor:
    if keep >= t.shape[0]:
        return t
    mask = (torch.arange(t.shape[0], device=t.device) < keep).to(t.dtype)
    return t * mask.reshape((-1,) + (1,) * (t.ndim - 1))


def pad_shard_inputs(mesh, nvalid: int | None, *arrays):
    """Row-shard ``arrays`` over the data axis with shared zero padding.

    Returns ``(list_of_sharded_arrays, nvalid)`` where ``nvalid`` is the
    true global row count whenever padding was added (callers mask pad
    rows after centering): the shared fit preamble of the mesh-aware
    estimators."""
    first = arrays[0]
    n_true = nvalid if nvalid is not None else (
        first.nvalid if isinstance(first, ShardedRows) else int(first.shape[0])
    )
    out = [padded_shard_rows(a, mesh, nvalid=n_true)[0] for a in arrays]
    if out and out[0].rows != n_true:
        nvalid = n_true
    return out, nvalid
