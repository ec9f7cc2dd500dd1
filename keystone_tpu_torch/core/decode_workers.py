"""The process decode backend of ``core.ingest`` (counterpart of the
process pool in keystone_tpu/core/ingest.py).

A pool of SPAWNED worker processes decodes tar members in parallel, free of
the interpreter lock: raw member bytes go in over one task queue per
worker, and the decoded pixels come back in ``multiprocessing.shared_memory``
blocks that the chunk assembly stacks straight from, each worker naming its
blocks over a pipe of its own.  (A result queue that the workers share is
guarded by one lock: a worker killed while it holds it leaves every other
worker blocked on its next answer, and the stream stuck.)  Each worker runs the
same ``image_loaders.decode_image`` as the thread pool, so the two backends
give the same pixels.

* A worker that dies is respawned (counted ``decode_worker_respawn``) and
  its pending members resubmitted; a member that keeps killing workers
  becomes a counted ``decode_worker_lost`` skip.
* A hung worker is the consumer's deadline to catch
  (``resilience.deadline``), as a hung decode thread is: :meth:`result`
  keeps timing out and the stream's shutdown terminates the stragglers.
* :meth:`ProcessDecodePool.shutdown` joins every worker and releases every
  shared-memory block, on early exit too.

A spawned worker imports the module of its entry point, so this module
(and what it imports) reaches neither torch nor jax: a worker costs an
interpreter, not a torch import.
"""

from __future__ import annotations

import itertools
import multiprocessing
import multiprocessing.connection
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from multiprocessing import shared_memory

import numpy as np

from . import trace
from .resilience import counters

#: The pool's result waits poll at this period, so a dead worker is noticed.
_POLL_SECONDS = 0.01


def _decode_worker_main(task_q, result_conn) -> None:
    """Entry point of one spawned decode worker.

    Receives ``(task_id, member_bytes)``, decodes with
    ``image_loaders.decode_image`` and publishes the pixels in a shared
    memory block sized to the array; the result ``(task_id, block name,
    shape, dtype, seconds, error)`` carries no array.  ``None`` is the
    shutdown sentinel; an undecodable member answers with a None block
    name, and a host with no decoder for it with the error's message."""
    from ..loaders import image_loaders, native_decode

    native_decode.available()  # build or load once, before the first task
    while True:
        item = task_q.get()
        if item is None:
            break
        tid, data = item
        start = time.perf_counter()
        try:
            img = image_loaders.decode_image(data)
        except image_loaders.HostDecoderUnavailable as e:
            result_conn.send((tid, None, None, None, 0.0, str(e)))
            continue
        seconds = time.perf_counter() - start
        if img is None:
            result_conn.send((tid, None, None, None, seconds, None))
            continue
        shm = shared_memory.SharedMemory(create=True, size=img.nbytes)
        np.ndarray(img.shape, img.dtype, buffer=shm.buf)[:] = img
        # The block stays registered with the resource tracker the parent
        # shares: a worker that exits or is killed around this put can
        # never unlink a block the parent still assembles from, and a
        # block whose name never reached the parent is reclaimed when the
        # parent exits.  The parent's unlink() unregisters it.
        result_conn.send((tid, shm.name, img.shape, img.dtype.str, seconds, None))
        shm.close()


def _unlink_undelivered(item) -> None:
    """Unlink the block of an answer no chunk will take (at shutdown)."""
    if item[1] is not None:
        try:
            s = shared_memory.SharedMemory(name=item[1])
            s.close()
            s.unlink()
        except FileNotFoundError:
            pass


class ShmArray:
    """One worker-decoded image in shared memory, seen from the parent:
    ``arr`` is a zero-copy view; :meth:`release` (once the chunk assembly
    copied the pixels out) closes and unlinks the block."""

    __slots__ = ("_pool", "shm", "arr")

    def __init__(self, pool, shm, shape, dtype):
        self._pool = pool
        self.shm = shm
        self.arr = np.ndarray(shape, dtype, buffer=shm.buf)

    @property
    def shape(self):
        return self.arr.shape

    def release(self) -> None:
        self._pool._release(self.shm)


class _ProcTask:
    """Future-like handle of one member's decode: ``result(timeout)`` as a
    thread-pool future has, so one in-order window holds either kind.  The
    result is ``(ShmArray or None, decode seconds)``."""

    __slots__ = ("_pool", "id", "name", "data", "worker", "img", "seconds", "done",
                 "skip_reason", "resubmits")

    def __init__(self, pool, tid: int, name: str, data: bytes):
        self._pool = pool
        self.id = tid
        self.name = name
        self.data = data  # kept until done: a dead worker's tasks resubmit
        self.worker = None
        self.img = None
        self.seconds = 0.0
        self.done = False
        self.skip_reason: str | None = None
        self.resubmits = 0

    def result(self, timeout: float):
        return self._pool._wait(self, timeout)

    def _finish(self, img, skip_reason: str | None = None) -> None:
        self.img = img
        self.skip_reason = skip_reason
        self.done = True
        self.data = None
        if self.worker is not None:
            self.worker.pending.pop(self.id, None)


class _PoolWorker:
    __slots__ = ("proc", "task_q", "conn", "pending")

    def __init__(self, proc, task_q, conn):
        self.proc = proc
        self.task_q = task_q
        self.conn = conn  # the read end of the worker's own result pipe
        self.pending: dict = {}  # task id -> _ProcTask, in submission order


class ProcessDecodePool:
    """``procs`` spawned decode workers (never forked: the parent runs
    threads), one task queue and one result pipe each.

    Every shared-memory block the parent attached is in ``_live_shm`` until
    the chunk assembly releases it; :meth:`shutdown` releases what is left,
    so no ``/dev/shm`` segment outlives the stream.  ``on_respawn`` is
    called once per respawned worker."""

    MAX_RESUBMITS = 2

    def __init__(self, procs: int, on_respawn=None):
        self._ctx = multiprocessing.get_context("spawn")
        self._workers: list[_PoolWorker] = []
        self._inflight: dict = {}  # task id -> _ProcTask
        self._live_shm: dict = {}  # block name -> SharedMemory
        self._ids = itertools.count()
        self._on_respawn = on_respawn
        self._down = False
        for _ in range(max(1, procs)):
            self._spawn_worker()

    # -- worker lifecycle ------------------------------------------------------

    def _spawn_worker(self) -> _PoolWorker:
        task_q = self._ctx.Queue()
        reader, writer = self._ctx.Pipe(duplex=False)
        proc = self._ctx.Process(
            target=_decode_worker_main, args=(task_q, writer),
            name="keystone-decode-proc", daemon=True,
        )
        proc.start()
        writer.close()  # the worker holds the only write end: its death is EOF
        w = _PoolWorker(proc, task_q, reader)
        self._workers.append(w)
        return w

    def _reap_dead_workers(self) -> None:
        for w in list(self._workers):
            if w.proc.is_alive():
                continue
            self._workers.remove(w)
            # What the worker answered before it died is delivered first.
            self._drain_conn(w.conn)
            w.conn.close()
            lost = list(w.pending.values())
            w.pending.clear()
            w.task_q.cancel_join_thread()
            w.task_q.close()
            counters.record(
                "decode_worker_respawn",
                f"pid {w.proc.pid} exited {w.proc.exitcode} with {len(lost)} task(s) "
                "pending — respawned",
            )
            trace.instant("decode_worker_respawn", pid=w.proc.pid,
                          exitcode=w.proc.exitcode, lost=len(lost))
            if self._on_respawn is not None:
                self._on_respawn()
            self._spawn_worker()
            # Blame the crash on the worker's oldest pending task only: the
            # worker was decoding it when it died, and the others were still
            # queued.  Charging all of them would let one poison member use
            # up healthy members' resubmit budgets, and skip images that
            # the thread backend keeps.
            if lost:
                lost[0].resubmits += 1
            for t in lost:
                if t.resubmits > self.MAX_RESUBMITS:
                    self._inflight.pop(t.id, None)
                    t.worker = None
                    t._finish(None, "decode_worker_lost")
                else:
                    self._dispatch(t)

    # -- task flow -------------------------------------------------------------

    def submit(self, name: str, data: bytes) -> _ProcTask:
        if self._down:
            raise RuntimeError("decode pool is shut down")
        t = _ProcTask(self, next(self._ids), name, data)
        self._inflight[t.id] = t
        self._dispatch(t)
        return t

    def _dispatch(self, task: _ProcTask) -> None:
        w = min(self._workers, key=lambda w: len(w.pending))
        w.pending[task.id] = task
        task.worker = w
        w.task_q.put((task.id, task.data))

    def _handle(self, item) -> None:
        tid, shm_name, shape, dtype, seconds, error = item
        if error is not None:
            from ..loaders.image_loaders import HostDecoderUnavailable

            raise HostDecoderUnavailable(error)
        task = self._inflight.pop(tid, None)
        if shm_name is None:
            if task is not None:
                task.seconds = seconds
                task._finish(None, task.skip_reason or "corrupt_image")
            return
        shm = shared_memory.SharedMemory(name=shm_name)
        if task is None or task.done:
            # A resubmitted task's first worker answered after all: the
            # duplicate block is surplus.
            shm.close()
            shm.unlink()
            return
        # An instant, not an io_span: attaching the block maps it; the
        # pixels move later, when the chunk assembly stacks them.
        trace.instant("ingest.shm_recv", bytes=int(np.prod(shape)) * np.dtype(dtype).itemsize,
                      member=task.name)
        self._live_shm[shm.name] = shm
        task.seconds = seconds
        task._finish(ShmArray(self, shm, shape, np.dtype(dtype)))

    def _drain_conn(self, conn, handle=None) -> bool:
        """Every answer waiting on one worker's pipe, handled; True if any.
        A dead worker's pipe ends (EOF, or a message cut short)."""
        got = False
        try:
            while conn.poll():
                (handle or self._handle)(conn.recv())
                got = True
        except (EOFError, OSError):
            pass
        return got

    def _wait(self, task: _ProcTask, timeout: float):
        end = time.monotonic() + timeout
        while True:
            conns = [w.conn for w in self._workers]
            ready = multiprocessing.connection.wait(conns, timeout=_POLL_SECONDS)
            drained = False
            for conn in ready:
                drained |= self._drain_conn(conn)
            if not task.done and not drained:
                self._reap_dead_workers()
            if task.done:
                return task.img, task.seconds
            if time.monotonic() >= end:
                raise _FutureTimeout()

    def _release(self, shm) -> None:
        self._live_shm.pop(shm.name, None)
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass

    # -- shutdown --------------------------------------------------------------

    def shutdown(self, clean: bool) -> None:
        """Stop every worker (the sentinel, then terminate and kill what is
        left), attach and unlink every undelivered block, and release every
        live one.  Idempotent."""
        if self._down:
            return
        self._down = True
        for w in self._workers:
            try:
                w.task_q.put_nowait(None)
            except (ValueError, OSError):
                pass
        end = time.monotonic() + (5.0 if clean else 1.0)
        for w in self._workers:
            w.proc.join(max(0.0, end - time.monotonic()))
        for w in self._workers:
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(1.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(1.0)
            w.task_q.cancel_join_thread()
            w.task_q.close()
            self._drain_conn(w.conn, handle=_unlink_undelivered)
            w.conn.close()
        for shm in list(self._live_shm.values()):
            self._release(shm)
        self._inflight.clear()

    def joined(self) -> bool:
        return self._down and not any(w.proc.is_alive() for w in self._workers)

    def live_workers(self) -> list:
        """The worker processes alive now (their ``pid`` and ``kill``)."""
        return [w.proc for w in self._workers if w.proc.is_alive()]
