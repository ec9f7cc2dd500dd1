"""Multi-process bring-up on ``torch.distributed`` (counterpart of
keystone_tpu/parallel/distributed.py), one process per rank, with
membership the serving fleet can shrink.

Two layers, deliberately separate:

* **The process group** (:func:`init_process_group`) for the fit path: a
  ``gloo`` group joined through a TCP store at the coordinator address
  (``tcp://host:port``).  The coordinator port is auto-picked
  (:func:`pick_coordinator`) with bounded retry on ``EADDRINUSE`` (counted
  ``dist_port_retry``), and the join is deadline-guarded: a slow or dead
  peer becomes a typed :class:`~keystone_tpu_torch.core.resilience.DeadlineExceeded`
  (counted ``dist_join_timeout``), never a hang.  Once it is up,
  ``parallel.mesh.make_mesh()`` with no devices builds a data axis that
  spans the processes (each rank's local slots gathered in rank order).
  The group moves bytes, never arithmetic: :func:`deterministic_allreduce`
  gathers each rank's partial and sums the stack on the host in rank order,
  so a reduction is bit-identical to one process summing the same partials.
  ``gloo`` and not NCCL: NCCL refuses two ranks on one card, and nothing
  numerical crosses the communicator, so CPU tensors over ``gloo`` carry
  all of it.
* **Fleet membership** (:class:`GroupState`, :func:`reform_group`) for the
  serving path: serving hosts keep their engines host-local (no
  collectives on the serve hot path) and track world/rank in this module's
  own group record, which :func:`reform_group` reduces in place when the
  front-end declares a peer dead (counted ``dist_reform``).  A ``gloo``
  group is not re-formed after a peer dies: the record keeps membership
  only from then on.

Single-process discipline: with nothing configured (no ``KEYSTONE_DIST_*``
env, no explicit ``world``), every entry point here is inert —
:func:`process_count` answers 1 and :func:`process_index` 0 — and
``torch.distributed`` is never touched.  This module imports no torch;
the functions that need it import it when called.

Env knobs (README ``KEYSTONE_*`` table):

* ``KEYSTONE_DIST_COORD`` — coordinator ``host:port``.
* ``KEYSTONE_DIST_PROCS`` / ``KEYSTONE_DIST_RANK`` — world size and this
  process's rank.
* ``KEYSTONE_DIST_JOIN_TIMEOUT_S`` — join deadline (default 60).
* ``KEYSTONE_DIST_PORT_RETRIES`` — coordinator bind retries on
  ``EADDRINUSE`` (default 4).
* ``KEYSTONE_DIST_DISABLE`` — force :func:`spawn_available` False (hosts
  without spawn/ports).
* ``KEYSTONE_DIST_LOCAL_SLOTS`` / ``KEYSTONE_DIST_DEVICE`` — how many mesh
  slots this process has and on which device (``cpu`` or ``cuda``):
  ``parallel.mesh.default_devices`` is then that device that many times.
  :func:`worker_env` sets both for a spawned worker.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
import sys
import threading
import time

from ..core.resilience import DeadlineExceeded, counters, is_addr_in_use

COORD_ENV = "KEYSTONE_DIST_COORD"
PROCS_ENV = "KEYSTONE_DIST_PROCS"
RANK_ENV = "KEYSTONE_DIST_RANK"
JOIN_TIMEOUT_ENV = "KEYSTONE_DIST_JOIN_TIMEOUT_S"
PORT_RETRIES_ENV = "KEYSTONE_DIST_PORT_RETRIES"
DISABLE_ENV = "KEYSTONE_DIST_DISABLE"
LOCAL_SLOTS_ENV = "KEYSTONE_DIST_LOCAL_SLOTS"
DEVICE_ENV = "KEYSTONE_DIST_DEVICE"

DEFAULT_JOIN_TIMEOUT_S = 60.0
DEFAULT_PORT_RETRIES = 4
#: Intra-op threads of a spawned worker: several workers share the host.
WORKER_THREADS = 2

_logger = logging.getLogger("keystone_tpu_torch.distributed")

_lock = threading.Lock()


@dataclasses.dataclass
class GroupState:
    """The live process-group record.  ``process_group`` says whether a
    real ``torch.distributed`` group backs it (fit path) or the group is
    membership only (serving fleet)."""

    world: int
    rank: int
    coordinator: str
    process_group: bool = False
    epoch: int = 0  #: bumped by every :func:`reform_group`
    lost: tuple = ()  #: original ranks declared dead across reforms

    def record(self) -> dict:
        return {
            "world": self.world,
            "rank": self.rank,
            "coordinator": self.coordinator,
            "process_group": self.process_group,
            "epoch": self.epoch,
            "lost": list(self.lost),
        }


_state: GroupState | None = None
_threads_before_init: frozenset[int] | None = None


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _env_int(name: str, default: int | None) -> int | None:
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


# -- ports and availability ---------------------------------------------------


def pick_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind to 0, read, release).  The
    release-to-bind window is racy by nature; the consumer
    (:func:`init_process_group`) retries ``EADDRINUSE`` rather than
    trusting the pick."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def pick_coordinator(host: str = "127.0.0.1") -> str:
    """Auto-picked ``host:port`` coordinator address for a launcher to
    hand every worker."""
    return f"{host}:{pick_port(host)}"


def spawn_available() -> bool:
    """Can this host run the multi-process path at all: POSIX, a usable
    ``sys.executable``, and the loopback port space open
    (``KEYSTONE_DIST_DISABLE`` forces False)."""
    if os.environ.get(DISABLE_ENV, "").strip() in ("1", "true", "yes"):
        return False
    if os.name != "posix":
        return False
    if not sys.executable or not os.path.exists(sys.executable):
        return False
    try:
        pick_port()
    except OSError:
        return False
    return True


# -- group state --------------------------------------------------------------


def is_initialized() -> bool:
    return _state is not None


def group_state() -> GroupState | None:
    return _state


def process_count() -> int:
    """World size — 1 when no group is configured."""
    return _state.world if _state is not None else 1


def process_index() -> int:
    """This process's rank — 0 when no group is configured."""
    return _state.rank if _state is not None else 0


def _live_group() -> bool:
    """Does a ``torch.distributed`` group of more than one rank back the
    record?"""
    return _state is not None and _state.world > 1 and _state.process_group


def local_slots() -> tuple[str, int] | None:
    """``(device, count)`` from ``KEYSTONE_DIST_DEVICE`` /
    ``KEYSTONE_DIST_LOCAL_SLOTS``, or None when the slot count is unset."""
    n = _env_int(LOCAL_SLOTS_ENV, None)
    if n is None:
        return None
    if n < 1:
        raise ValueError(f"{LOCAL_SLOTS_ENV}={n}: need at least one slot")
    return os.environ.get(DEVICE_ENV, "").strip() or "cuda", n


# -- bring-up -----------------------------------------------------------------


def init_process_group(
    coordinator: str | None = None,
    world: int | None = None,
    rank: int | None = None,
    *,
    join_timeout_s: float | None = None,
    port_retries: int | None = None,
    use_torch: bool = True,
) -> GroupState:
    """Join (or create) the process group.  Arguments default from the
    ``KEYSTONE_DIST_*`` env; with nothing configured this is an inert no-op
    returning a solo :class:`GroupState`, and ``torch.distributed`` is not
    touched.

    ``use_torch=True`` joins a ``gloo`` group (``torch.distributed``)
    under the join deadline: the coordinator (rank 0) retries
    ``EADDRINUSE`` up to ``port_retries`` times (counted
    ``dist_port_retry``), and a join that outlives ``join_timeout_s`` — a
    dead coordinator, a peer that never arrives — raises typed
    :class:`DeadlineExceeded` counted ``dist_join_timeout``.  A failed
    bring-up means the process is replaced, not retried in place: the
    abandoned join may still be blocked in the TCP store.
    ``use_torch=False`` records membership only (the serving-fleet mode)."""
    global _state, _threads_before_init
    with _lock:
        if _state is not None:
            raise RuntimeError(
                f"process group already initialised: {_state.record()} — "
                "shutdown_process_group() first"
            )
        world = world if world is not None else _env_int(PROCS_ENV, None)
        if world is None or world <= 0:
            # Nothing configured: the single-process inert path.
            _state = GroupState(world=1, rank=0, coordinator="", epoch=0)
            return _state
        rank = rank if rank is not None else (_env_int(RANK_ENV, 0) or 0)
        coordinator = coordinator or os.environ.get(COORD_ENV, "").strip()
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} outside world {world}")
        if world > 1 and not coordinator:
            raise ValueError(
                f"world={world} needs a coordinator address "
                f"({COORD_ENV} or coordinator=)"
            )
        if not coordinator:
            coordinator = pick_coordinator()
        if not use_torch:
            _state = GroupState(world=world, rank=rank, coordinator=coordinator)
            _logger.info("fleet group joined: %s", _state.record())
            return _state

        budget = (
            join_timeout_s
            if join_timeout_s is not None
            else _env_float(JOIN_TIMEOUT_ENV, DEFAULT_JOIN_TIMEOUT_S)
        )
        retries = (
            port_retries
            if port_retries is not None
            else (_env_int(PORT_RETRIES_ENV, DEFAULT_PORT_RETRIES) or 0)
        )
        _threads_before_init = frozenset(id(t) for t in threading.enumerate())
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                _join_with_deadline(coordinator, world, rank, budget)
                break
            except DeadlineExceeded:
                counters.record(
                    "dist_join_timeout",
                    f"rank {rank}/{world} join via {coordinator} exceeded {budget:g}s",
                )
                raise
            except Exception as e:
                if is_addr_in_use(e) and rank == 0 and attempt < retries:
                    attempt += 1
                    counters.record(
                        "dist_port_retry",
                        f"coordinator {coordinator} in use (attempt {attempt}/{retries})",
                    )
                    time.sleep(0.05 * attempt)
                    continue
                if _looks_like_timeout(e):
                    counters.record(
                        "dist_join_timeout",
                        f"rank {rank}/{world} join via {coordinator}: {e}",
                    )
                    raise DeadlineExceeded(f"dist_join[{rank}/{world}]", budget) from e
                raise
        _state = GroupState(
            world=world, rank=rank, coordinator=coordinator, process_group=True,
        )
        _logger.info("process group up in %.2fs: %s", time.monotonic() - t0, _state.record())
        return _state


def _join(coordinator: str, world: int, rank: int, timeout_s: float) -> None:
    """The ``gloo`` join itself (one attempt)."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _join_with_deadline(coordinator, world, rank, budget) -> None:
    """Run the join under a REAL deadline.

    ``torch.distributed.init_process_group`` blocks inside the C++ TCP
    store (the coordinator waiting for every rank, a joiner connecting to a
    coordinator that is not there), where no Python signal reaches.  So the
    join runs on a helper thread and THIS thread owns the clock: past the
    budget the caller gets a typed :class:`DeadlineExceeded` and the stuck
    join thread is abandoned (daemon: it dies with the process, which a
    failed bring-up replaces).  torch's own timeout is set past the budget,
    so the typed fault always comes from this clock first."""
    box: dict = {}

    def run():
        try:
            _join(coordinator, world, rank, max(1.0, budget * 2) + 5)
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            box["error"] = e

    t = threading.Thread(target=run, name=f"dist-join-{rank}", daemon=True)
    t.start()
    t.join(budget)
    if t.is_alive():
        raise DeadlineExceeded(f"dist_join[{rank}/{world}]", budget)
    if "error" in box:
        raise box["error"]


def _looks_like_timeout(e: BaseException) -> bool:
    msg = str(e).lower()
    return any(tok in msg for tok in ("timed out", "timeout", "deadline exceeded"))


def shutdown_process_group(join_timeout_s: float = 5.0) -> list[str]:
    """Leave the group (``destroy_process_group``).  Returns the names of
    the Python threads still alive after ``join_timeout_s`` that were not
    there before the join — callers assert ``== []``, so a leak is a test
    failure, counted ``dist_thread_leak``.  Idempotent; inert when no group
    was initialised."""
    global _state, _threads_before_init
    with _lock:
        st, _state = _state, None
        before, _threads_before_init = _threads_before_init, None
    if st is None or not st.process_group:
        return []
    import torch.distributed as dist

    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception as e:
        counters.record("dist_shutdown_error", str(e))
        raise
    leaked: list[str] = []
    end = time.monotonic() + max(0.0, join_timeout_s)
    while True:
        leaked = [
            t.name
            for t in threading.enumerate()
            if t.is_alive()
            and (before is None or id(t) not in before)
            and t is not threading.current_thread()
        ]
        if not leaked or time.monotonic() >= end:
            break
        time.sleep(0.05)
    if leaked:
        counters.record("dist_thread_leak", ",".join(leaked))
    return leaked


def reform_group(survivors) -> GroupState:
    """Re-form the group as the ``survivors`` (original ranks, order fixed
    across hosts so every survivor derives the same new world).  Counted
    ``dist_reform``.  A ``gloo`` group is NOT re-formed in place — its
    members are fixed at the join and a dead peer fails every later
    collective — so the record downgrades to membership only and work
    continues host-local; the caller reshards state via
    ``load_pipeline(mesh=)`` and re-anchors its routers."""
    global _state
    with _lock:
        if _state is None:
            raise RuntimeError("no process group to re-form")
        survivors = sorted(int(s) for s in survivors)
        if _state.rank not in survivors:
            raise ValueError(f"rank {_state.rank} is not among survivors {survivors}")
        if not all(0 <= s < _state.world for s in survivors):
            raise ValueError(f"survivors {survivors} outside world {_state.world}")
        lost = tuple(sorted(set(range(_state.world)) - set(survivors) | set(_state.lost)))
        new = GroupState(
            world=len(survivors),
            rank=survivors.index(_state.rank),
            coordinator=_state.coordinator,
            process_group=False,
            epoch=_state.epoch + 1,
            lost=lost,
        )
        counters.record(
            "dist_reform",
            f"world {_state.world}->{new.world} rank {_state.rank}->{new.rank} "
            f"lost={list(lost)}",
        )
        if _state.process_group:
            _logger.warning(
                "leaving the gloo group behind (peer death) — work is host-local from here"
            )
        _state = new
        return new


# -- deterministic cross-process reduction ------------------------------------


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` without a group)."""
    if not _live_group():
        return [obj]
    import torch.distributed as dist

    out: list = [None] * _state.world
    dist.all_gather_object(out, obj)
    return out


def deterministic_allreduce(partial):
    """Sum per-rank partials in FIXED rank order — the bit-identity
    primitive.  Every rank's partial is gathered (exact byte transport of a
    CPU tensor over ``gloo``, no arithmetic) into a ``(world, ...)`` stack
    and summed by the same ``np.sum(axis=0)`` the single-process reference
    applies to its per-group partials.  Same values, same op, same order:
    bit-identical by construction.  Without a group the partial comes back
    unchanged."""
    import numpy as np

    x = np.ascontiguousarray(np.asarray(partial))
    if not _live_group():
        return x
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(x.copy())
    parts = [torch.empty_like(t) for _ in range(_state.world)]
    dist.all_gather(parts, t)
    return np.stack([p.numpy() for p in parts], axis=0).sum(axis=0)


def barrier(name: str = "keystone") -> None:
    """Cross-process sync point (the ``gloo`` barrier; solo or
    membership-only groups: a no-op).  ``name`` labels the log line."""
    if not _live_group():
        return
    import torch.distributed as dist

    _logger.debug("barrier %s", name)
    dist.barrier()


# -- launcher helpers ---------------------------------------------------------


def worker_env(
    rank: int,
    world: int,
    coordinator: str,
    *,
    local_devices: int = 2,
    device: str = "cpu",
    base: dict | None = None,
) -> dict:
    """Environment for one spawned worker: ``local_devices`` mesh slots on
    ``device`` (``KEYSTONE_DIST_LOCAL_SLOTS`` / ``KEYSTONE_DIST_DEVICE``,
    replacing any inherited values), the ``KEYSTONE_DIST_*`` triple set,
    and the intra-op thread pool capped at :data:`WORKER_THREADS`."""
    env = dict(os.environ if base is None else base)
    env[LOCAL_SLOTS_ENV] = str(int(local_devices))
    env[DEVICE_ENV] = str(device)
    env[COORD_ENV] = coordinator
    env[PROCS_ENV] = str(int(world))
    env[RANK_ENV] = str(int(rank))
    env["OMP_NUM_THREADS"] = str(WORKER_THREADS)
    return env
