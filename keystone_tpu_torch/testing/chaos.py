"""Deterministic end-to-end chaos harness of the port (counterpart of the
repository's ``tests/chaos.py``; driven by ``tests/test_torch_chaos.py`` and
by ``python -m keystone_tpu_torch.tools.chaos_run``).

A SEED maps to a fault schedule drawn from the injector families of
:mod:`.faults`; the schedule is applied to a real workload pipeline
(MnistRandomFFT or RandomPatchCifar on synthetic data) on a chosen device,
and the outcome is judged against one invariant:

    every run either COMPLETES with predictions equal to the fault-free
    run, or fails with a TYPED, COUNTED, LOGGED error — never a silent
    wrong model, never a bare traceback.

``seed % len(FAMILIES)`` picks the family and ``default_rng(seed)`` draws
its parameters, exactly as the JAX harness draws them, so a seed means the
same schedule in both packages.  The 27 families:

* ``solver_oom`` / ``oom_cascade`` / ``plan_mispredict`` — an injected
  ``torch.OutOfMemoryError`` at the fused BCD tier
  (``solvers.block._fused_bcd_impl``; the cascade also at the stepwise
  tier's block update, ``_bcd_block_solve``): the ladder steps down
  (counted), the placement search's next-ranked plan runs, and the
  predictions equal the fault-free run's.
* ``spec_mispredict`` — the same at the mesh tier
  (``_execute_fused_bcd_mesh``) under a 4x2 mesh of slots of the run's
  device, a searched spec layout forced to the top.
* ``io_transient`` / ``corrupt_members`` — flaky tar opens absorbed by
  ``core.resilience.retry`` (``io_retry``); mangled JPEG members skipped
  and counted (``corrupt_image``).
* ``nan_input`` — NaN-poisoned training data: the finite-model guard fails
  typed (``FloatingPointError``), counted.
* ``preempt_resume`` — a preemption after the first checkpointed BCD block,
  then a ``resume_from=`` restart that lands on the fault-free predictions.
* ``deadline`` / ``stream_hang`` — a hung solve / a hung decode thread
  bounded by ``resilience.deadline``: typed ``DeadlineExceeded`` naming
  the phase; the stream's threads are joined.
* ``stream_corrupt`` / ``jpeg_corrupt_entropy`` / ``native_entropy`` — a
  corrupt member mid-stream (host decode, device decode, the native
  entropy loop and its per-image fallback): counted skips, survivors
  bit-equal to a fault-free stream.
* ``autotune_thrash`` / ``snapshot_corrupt`` / ``decode_worker_kill`` /
  ``profiler_crash`` — oscillating retunes, a damaged snapshot shard, a
  SIGKILLed decode worker, a crashing HBM sampler: each counted, the
  stream bit-equal to a fault-free one.
* ``slow_client`` / ``malformed_request`` / ``serve_burst_oom`` /
  ``wire_disconnect`` / ``slow_loris`` / ``output_drift`` — the serving
  path (``core.serve``, ``core.frontend``, ``core.wire``, ``core.numerics``):
  every answer bit-equal to the offline apply, each fault counted.
* ``mesh_shrink`` / ``host_loss`` / ``obs_capture`` / ``drift_refit`` — a
  lost device slot, a lost serving host (``workloads.multihost`` drills),
  a fleet member lost mid-scrape, and the closed drift → refit → swap
  lifecycle with its fault legs.

Every phase runs on the ``device`` given to :func:`run_schedule`: CPU
tensors take the plain versions of the kernels, CUDA tensors the hand
kernels (RandomPatchCifar's ``conv_rect_pool``, the device decode's
``decode_pixels``).
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import glob
import json
import os
import shutil
import signal
import socket
import tarfile
import tempfile
import threading
import time

import numpy as np
import torch

from . import faults
from ..core import checkpoint as ckpt_mod
from ..core import ingest
from ..core import memory as kmem
from ..core import trace
from ..core.resilience import DeadlineExceeded, counters, deadline
from ..loaders import image_loaders
from ..loaders.cifar import RECORD_BYTES, cifar_loader
from ..loaders.csv_loader import LabeledData
from ..solvers import block as block_mod

#: Exception types that count as a STRUCTURED failure — anything else
#: escaping a chaos run is a bare traceback, i.e. a harness violation.
TYPED_ERRORS = (
    FloatingPointError,
    DeadlineExceeded,
    ckpt_mod.CheckpointError,  # includes CheckpointMismatch
    kmem.LadderSourceLost,
)

FAMILIES = (
    "solver_oom",
    "oom_cascade",
    "io_transient",
    "corrupt_members",
    "nan_input",
    "preempt_resume",
    "deadline",
    "stream_corrupt",
    "stream_hang",
    "autotune_thrash",
    "snapshot_corrupt",
    "decode_worker_kill",
    "slow_client",
    "malformed_request",
    "serve_burst_oom",
    "plan_mispredict",
    "spec_mispredict",
    "wire_disconnect",
    "slow_loris",
    "jpeg_corrupt_entropy",
    "profiler_crash",
    "output_drift",
    "mesh_shrink",
    "host_loss",
    "drift_refit",
    "native_entropy",
    "obs_capture",
)

#: The serving-path families, selected by ``chaos_run --serve``.
SERVE_FAMILIES = (
    "slow_client",
    "malformed_request",
    "serve_burst_oom",
    "wire_disconnect",
    "slow_loris",
    "output_drift",
)

#: The counter each family's schedule must bump — faults are COUNTED, not
#: just survived (the JAX suite's ``tests/test_chaos.py`` bar).
EXPECTED_COUNTER = {
    "solver_oom": "solver_oom_retry",
    "oom_cascade": "solver_oom_retry",
    "io_transient": "io_retry",
    "corrupt_members": "corrupt_image",
    "nan_input": "nonfinite_model",
    "preempt_resume": "chaos_preemption",
    "deadline": "deadline_exceeded",
    "stream_corrupt": "corrupt_image",
    "stream_hang": "deadline_exceeded",
    "autotune_thrash": "chaos_autotune_thrash",
    "snapshot_corrupt": "snapshot_fallback",
    "decode_worker_kill": "decode_worker_respawn",
    "slow_client": "chaos_slow_client",
    "malformed_request": "serve_malformed_request",
    "serve_burst_oom": "serve_burst_oom",
    "plan_mispredict": "autoshard_stepdown",
    "spec_mispredict": "autoshard_stepdown",
    "wire_disconnect": "wire_client_disconnect",
    "slow_loris": "chaos_slow_loris",
    "jpeg_corrupt_entropy": "jpeg_corrupt_entropy",
    "profiler_crash": "profiler_sampler_crash",
    "output_drift": "serve_output_drift",
    "mesh_shrink": "mesh_reanchor",
    "host_loss": "host_reanchor",
    "drift_refit": "lifecycle_refit",
    "native_entropy": "jpeg_corrupt_entropy",
    "obs_capture": "obs_member_lost",
}

#: Seeds of the tier-1 suite (every family once); ``chaos_run --full``
#: runs the full schedule.
TIER1_SEEDS = tuple(range(27))
FULL_SEEDS = tuple(range(54))

_DATA_SEED = 20260803  # fixed: the fault-free baseline is schedule-invariant
_N_TAR_IMAGES = 6
_N_STREAM_IMAGES = 10  # streaming-path tars (corrupt picked mid-stream)

#: The ``KEYSTONE_*`` knobs a chaos run clears: the resilience posture
#: (no HBM budget, numerics and profiler off, no postmortem or capture
#: directory), the placement search on, and the stream's defaults.
_CLEARED_ENV = (
    kmem.HBM_BUDGET_ENV,
    "KEYSTONE_PROFILER",
    "KEYSTONE_HBM_SAMPLE_MS",
    "KEYSTONE_NUMERICS",
    "KEYSTONE_NUMERICS_SAMPLE",
    "KEYSTONE_DRIFT_TOL",
    "KEYSTONE_POSTMORTEM_DIR",
    "KEYSTONE_XPROF_DIR",
    "KEYSTONE_AUTOSHARD",
    "KEYSTONE_AUTOSHARD_SPECS",
    "KEYSTONE_SNAPSHOT_DIR",
    "KEYSTONE_SNAPSHOT_MODE",
    "KEYSTONE_DECODE_BACKEND",
    "KEYSTONE_DEVICE_DECODE",
    "KEYSTONE_AUTOTUNE",
    "KEYSTONE_SERVE_BUCKETS",
)


class SimulatedPreemption(RuntimeError):
    """Injected mid-fit preemption (a machine reclaimed between BCD
    blocks) — expected and consumed by the ``preempt_resume`` schedule,
    never a final outcome."""


class ChaosOracleError(AssertionError):
    """The resilience contract itself broke (wrong skip count, missing
    expected failure, survivors lost) — surfaces as a failed outcome."""


@dataclasses.dataclass
class Fault:
    kind: str
    params: dict

    def record(self) -> dict:
        return {"kind": self.kind, **self.params}


@dataclasses.dataclass
class ChaosResult:
    seed: int
    workload: str
    fault: Fault
    outcome: str  # completed_equal | typed_error | SILENT_WRONG_MODEL |
    #             UNTYPED_ERROR | ORACLE_FAILED
    error_type: str | None = None
    error: str | None = None
    phase: str | None = None
    counters_delta: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    #: Where this schedule's trace landed (``run_schedule(trace_path=)``).
    trace_path: str | None = None

    def ok(self) -> bool:
        return self.outcome in ("completed_equal", "typed_error")

    def record(self) -> dict:
        return {
            "seed": self.seed,
            "workload": self.workload,
            "fault": self.fault.record(),
            "outcome": self.outcome,
            "error_type": self.error_type,
            "error": self.error[:200] if self.error else None,
            "phase": self.phase,
            "counters_delta": dict(self.counters_delta),
            "seconds": round(self.seconds, 3),
            "trace_path": self.trace_path,
        }


def _mid_stream(rng) -> tuple:
    """1-2 strictly mid-stream member indices."""
    k = int(rng.integers(1, 3))
    return tuple(sorted(
        int(i) for i in rng.choice(np.arange(1, _N_STREAM_IMAGES - 1), k, replace=False)))


def make_schedule(seed: int) -> Fault:
    """seed -> fault schedule, deterministically: the family cycles so any
    contiguous seed range covers all of them, the parameters are drawn
    from ``default_rng(seed)`` in the JAX harness's order."""
    rng = np.random.default_rng(seed)
    kind = FAMILIES[seed % len(FAMILIES)]
    if kind in ("solver_oom", "plan_mispredict", "spec_mispredict"):
        return Fault(kind, {"failures": 1})
    if kind == "oom_cascade":
        return Fault(kind, {"failures": 2})
    if kind == "io_transient":
        return Fault(kind, {"io_failures": int(rng.integers(1, 3))})
    if kind == "corrupt_members":
        k = int(rng.integers(1, 4))
        corrupt = tuple(sorted(int(i) for i in rng.choice(_N_TAR_IMAGES, k, replace=False)))
        return Fault(kind, {"corrupt": corrupt})
    if kind == "nan_input":
        return Fault(kind, {"frac": float(rng.uniform(0.002, 0.02))})
    if kind == "preempt_resume":
        return Fault(kind, {"preempt_after_blocks": 1})
    if kind == "stream_corrupt":
        return Fault(kind, {"corrupt": _mid_stream(rng), "batch": 4})
    if kind == "stream_hang":
        return Fault(kind, {"hang_at": int(rng.integers(1, 6)), "seconds": 0.8})
    if kind == "autotune_thrash":
        return Fault(kind, {"batch": int(rng.integers(2, 5)), "period": int(rng.integers(1, 3))})
    if kind == "snapshot_corrupt":
        return Fault(kind, {
            "batch": int(rng.integers(2, 5)),
            "shard": int(rng.integers(0, 4)),
            "corruption": ("truncate", "bitflip")[int(rng.integers(0, 2))],
        })
    if kind == "decode_worker_kill":
        return Fault(kind, {"batch": 4, "procs": 2})
    if kind == "slow_client":
        return Fault(kind, {
            "slow_requests": int(rng.integers(2, 5)),
            "think_seconds": 0.05,
            "fast_requests": int(rng.integers(12, 25)),
        })
    if kind == "malformed_request":
        return Fault(kind, {"bad": int(rng.integers(2, 5)), "good": int(rng.integers(8, 17))})
    if kind == "serve_burst_oom":
        return Fault(kind, {"burst": int(rng.integers(9, 17)), "failures": 1})
    if kind == "wire_disconnect":
        return Fault(kind, {"requests": int(rng.integers(6, 13)), "hold_seconds": 0.25})
    if kind == "slow_loris":
        return Fault(kind, {"requests": int(rng.integers(6, 13)),
                            "lorises": int(rng.integers(1, 3))})
    if kind in ("jpeg_corrupt_entropy", "native_entropy"):
        params = {
            "corrupt": _mid_stream(rng),
            "batch": 4,
            "mode": ("truncate", "marker")[int(rng.integers(0, 2))],
        }
        if kind == "native_entropy":
            # which decode_scan call the injected native failure hits: <= 8,
            # so it lands inside the survivor stream
            params["fail_at"] = int(rng.integers(1, 9))
        return Fault(kind, params)
    if kind == "profiler_crash":
        return Fault(kind, {"batch": 4, "crash_after": int(rng.integers(1, 5))})
    if kind == "output_drift":
        return Fault(kind, {
            "reference": int(rng.integers(48, 81)),
            # clears numerics.DRIFT_MIN_COUNT with margin
            "shifted": int(rng.integers(48, 81)),
            "shift_scale": float(rng.uniform(4.0, 8.0)),
        })
    if kind == "mesh_shrink":
        return Fault(kind, {
            "requests": int(rng.integers(6, 13)),
            # how many of the 4 full-mesh slots survive the loss
            "survivors": int(rng.integers(1, 3)),
            "hold_seconds": 0.25,
        })
    if kind == "host_loss":
        # chaos_run --hosts N overrides the fleet size through the env
        return Fault(kind, {"hosts": 2, "requests": int(rng.integers(14, 25))})
    if kind == "obs_capture":
        return Fault(kind, {"hosts": 2, "requests": int(rng.integers(12, 21))})
    if kind == "drift_refit":
        return Fault(kind, {
            "reference": int(rng.integers(48, 81)),
            "shifted": int(rng.integers(48, 81)),
            "shift_scale": float(rng.uniform(4.0, 8.0)),
            "rows": int(rng.integers(96, 161)),  # refit training rows
            "requests": int(rng.integers(6, 13)),  # in flight across the swap
            "hold_seconds": 0.2,
        })
    return Fault("deadline", {"seconds": 1.0})


# -- workload cases -----------------------------------------------------------


def _mnist_case():
    rng = np.random.default_rng(_DATA_SEED)
    d, k = 64, 5
    centers = rng.normal(size=(k, d))

    def split(n):
        labels = rng.integers(0, k, n)
        data = (centers[labels] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
        return LabeledData(data=data, labels=labels.astype(np.int32))

    return split(160), split(80)


_mnist_data_cache: list = []


def _run_mnist(device: str, train_override=None, mesh=None, **conf_kw):
    from ..workloads.mnist_random_fft import MnistRandomFFTConfig, run

    if not _mnist_data_cache:
        _mnist_data_cache.append(_mnist_case())
    train, test = _mnist_data_cache[0]
    if train_override is not None:
        train = train_override(train)
    conf = MnistRandomFFTConfig(num_ffts=2, block_size=512, lam=1e-2, mnist_image_size=64,
                                num_classes=5, device=device, **conf_kw)
    return run(conf, train, test, mesh=mesh)


def _write_synthetic_cifar(path, n, rng, num_classes=4, base=None):
    """Class-coloured blobs plus noise in CIFAR binary record format."""
    labels = rng.integers(0, num_classes, n).astype(np.uint8)
    if base is None:
        base = rng.uniform(40, 215, (num_classes, 3))
    recs = np.zeros((n, RECORD_BYTES), np.uint8)
    _, xx = np.mgrid[0:32, 0:32]
    for i in range(n):
        img = base[labels[i]][:, None, None] + rng.normal(0, 25, (3, 32, 32))
        img[labels[i] % 3] += 30 * np.sin(xx / (2.0 + labels[i]))
        recs[i, 0] = labels[i]
        recs[i, 1:] = np.clip(img, 0, 255).astype(np.uint8).reshape(-1)
    recs.tofile(path)


_cifar_paths_cache: list = []


def _cifar_paths() -> tuple:
    """The harness's CIFAR files, written once per process into a
    temporary directory removed at exit."""
    if not _cifar_paths_cache:
        d = tempfile.mkdtemp(prefix="chaos_cifar_")
        atexit.register(shutil.rmtree, d, True)
        rng = np.random.default_rng(_DATA_SEED)
        palette = rng.uniform(40, 215, (4, 3))
        tr, te = os.path.join(d, "train.bin"), os.path.join(d, "test.bin")
        _write_synthetic_cifar(tr, 72, rng, base=palette)
        _write_synthetic_cifar(te, 36, rng, base=palette)
        _cifar_paths_cache.append((tr, te))
    return _cifar_paths_cache[0]


def _run_cifar(device: str, train_override=None, mesh=None, **conf_kw):
    from ..workloads.cifar_random_patch import RandomCifarConfig, run

    tr, te = _cifar_paths()
    conf = RandomCifarConfig(num_filters=8, patch_size=6, patch_steps=4, lam=10.0,
                             whitener_size=300, featurize_chunk=36, num_classes=4,
                             device=device, **conf_kw)
    train, test = cifar_loader(tr), cifar_loader(te)
    if train_override is not None:
        train = train_override(train)
    return run(conf, train, test, mesh=mesh)


def _run_workload(workload: str, device: str, train_override=None, mesh=None, **conf_kw):
    if workload == "mnist":
        return _run_mnist(device, train_override=train_override, mesh=mesh, **conf_kw)
    if workload == "cifar":
        return _run_cifar(device, train_override=train_override, mesh=mesh, **conf_kw)
    raise ValueError(f"unknown chaos workload {workload!r}")


def _device(device) -> str:
    """``device`` resolved ("cuda" raises without a card) as a string."""
    from ..utils.platform import resolve_device

    return str(resolve_device(device))


def _slot_device(device: str) -> torch.device:
    """The device a mesh slot names: ``cuda:0`` for "cuda"."""
    dev = torch.device(device)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


_spec_meshes: dict = {}


def _spec_mesh(device: str):
    """The mesh ``spec_mispredict`` runs under: (data 4, model 2) slots of
    ``device`` (the JAX harness counts ``jax.devices()``; the port's
    device has one card, which fills every slot).  Cached: the baseline
    and every faulted run must fit on the same mesh."""
    if device not in _spec_meshes:
        from ..parallel.mesh import make_mesh

        _spec_meshes[device] = make_mesh(4, 2, devices=[_slot_device(device)] * 8)
    return _spec_meshes[device]


_baselines: dict[tuple, dict] = {}


def baseline(workload: str, mesh: bool = False, device="cuda") -> dict:
    """The fault-free run every schedule is judged against, cached per
    workload, mesh and device.  ``mesh=True``: the fault-free mesh run (the
    ``spec_mispredict`` oracle)."""
    device = _device(device)
    key = (workload, bool(mesh), device)
    if key not in _baselines:
        _baselines[key] = _run_workload(
            workload, device, mesh=_spec_mesh(device) if mesh else None)
    return _baselines[key]


def _preds_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))


@contextlib.contextmanager
def _patched(obj, attr, replacement):
    original = getattr(obj, attr)
    setattr(obj, attr, replacement)
    try:
        yield
    finally:
        setattr(obj, attr, original)


@contextlib.contextmanager
def _clean_env():
    """Chaos runs start from the default resilience posture
    (:data:`_CLEARED_ENV` unset); ``profiler_crash`` turns the profiler on
    itself, scoped."""
    saved = {k: os.environ.pop(k, None) for k in _CLEARED_ENV}
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _reopen_postmortems(*kinds: str) -> None:
    """Reopen the per-process postmortem cap of ``kinds``: a process that
    runs the full seed set meets each drill twice, after other families
    may have spent the cap."""
    from ..core import telemetry as ktelemetry

    with ktelemetry._pm_lock:
        for kind in kinds:
            ktelemetry._pm_counts.pop(kind, None)


@contextlib.contextmanager
def _postmortems_to(pm_dir: str, *kinds: str):
    """Postmortem dumps go to ``pm_dir`` inside the block, with the
    per-kind dump cap of ``kinds`` reopened (earlier activity of this
    process may have spent it)."""
    from ..core import telemetry as ktelemetry

    _reopen_postmortems(*kinds)
    saved = os.environ.get(ktelemetry.POSTMORTEM_DIR_ENV)
    os.environ[ktelemetry.POSTMORTEM_DIR_ENV] = pm_dir
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(ktelemetry.POSTMORTEM_DIR_ENV, None)
        else:
            os.environ[ktelemetry.POSTMORTEM_DIR_ENV] = saved


# -- the ingest and decode phases ---------------------------------------------


def _ingest_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """io_transient / corrupt_members: build a seeded JPEG tar (optionally
    with mangled members), decode it under the injected faults, and hold
    the loader to its contract — every survivor decoded in order, every
    corrupt member a counted skip, every failed open a counted retry."""
    rng = np.random.default_rng(seed)
    tar_path = os.path.join(tmpdir, f"chaos_ingest_{seed}.tar")
    corrupt = tuple(fault.params.get("corrupt", ()))
    names = faults.make_image_tar(tar_path, _N_TAR_IMAGES, rng, corrupt=corrupt)
    before_skip = counters.get("corrupt_image")
    before_retry = counters.get("io_retry")
    io_failures = int(fault.params.get("io_failures", 0))
    ctx = (faults.transient_faults(image_loaders.tarfile, "open", io_failures)
           if io_failures else contextlib.nullcontext())
    with ctx:
        decoded = [name for name, _ in image_loaders._iter_tar_images(tar_path, num_threads=1)]
    survivors = [n for i, n in enumerate(names) if i not in corrupt]
    if decoded != survivors:
        raise ChaosOracleError(f"ingest lost data: decoded {decoded} != survivors {survivors}")
    skipped = counters.get("corrupt_image") - before_skip
    if skipped != len(corrupt):
        raise ChaosOracleError(f"{len(corrupt)} corrupt member(s) but {skipped} counted skips "
                               "— a corrupt member was swallowed uncounted")
    if io_failures and counters.get("io_retry") - before_retry < io_failures:
        raise ChaosOracleError(f"{io_failures} injected open failure(s) but fewer io_retry "
                               "counts — a transient fault was absorbed invisibly")


def _probe(x: torch.Tensor) -> torch.Tensor:
    """The streaming phases' featurizer: per-image mean and max, on the
    pixels' device."""
    return torch.stack([x.mean(dim=(1, 2, 3)), x.amax(dim=(1, 2, 3))], dim=1)


def _stream_featurize(tar_path: str, batch: int, device: str, config=None, tuner=None):
    """The streaming-path probe pipeline: ``core.ingest`` stream -> per-chunk
    featurize on the device -> scatter back to stream order
    (``fv_common.scatter_features_streaming``).  Every thread is joined."""
    from ..workloads.fv_common import scatter_features_streaming

    with ingest.stream_batches(tar_path, batch, config=config, tuner=tuner,
                               device=device) as st:
        feats, names = scatter_features_streaming(st, _probe, 2)
    if not st.join(10.0):
        raise ChaosOracleError("streaming ingest left decoder/producer threads alive")
    return feats, names


def _tar_pair(tmpdir: str, tag: str, seed: int, corrupt: tuple, corrupt_fn=None) -> tuple:
    """A seeded stream tar with ``corrupt`` members mangled, and the
    fault-free oracle tar: the same member bytes minus the corrupt ones."""
    rng = np.random.default_rng(seed)
    tar_bad = os.path.join(tmpdir, f"chaos_{tag}_{seed}.tar")
    names = faults.make_image_tar(tar_bad, _N_STREAM_IMAGES, rng, corrupt=corrupt,
                                  corrupt_fn=corrupt_fn)
    survivors = {n for i, n in enumerate(names) if i not in corrupt}
    tar_ok = os.path.join(tmpdir, f"chaos_{tag}_{seed}_ok.tar")
    with tarfile.open(tar_bad) as src, tarfile.open(tar_ok, "w") as dst:
        for m in src:
            if m.name in survivors:
                dst.addfile(m, src.extractfile(m))
    return tar_bad, tar_ok


def _hold_equal(what: str, got: tuple, want: tuple) -> None:
    """Streamed ``(features, names)`` against the oracle's, bit for bit."""
    if got[1] != want[1]:
        raise ChaosOracleError(f"{what} lost/reordered data: {got[1]} != {want[1]}")
    if not np.array_equal(got[0], want[0]):
        raise ChaosOracleError(f"{what}: features differ from the fault-free stream")


def _stream_corrupt_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Corrupt member mid-stream: the streaming path counts the skip and
    its features equal a fault-free stream over the survivors, bit for
    bit."""
    corrupt = tuple(fault.params["corrupt"])
    batch = int(fault.params["batch"])
    tar_bad, tar_ok = _tar_pair(tmpdir, "stream", seed, corrupt)
    before = counters.get("corrupt_image")
    faulted = _stream_featurize(tar_bad, batch, device)
    skipped = counters.get("corrupt_image") - before
    if skipped != len(corrupt):
        raise ChaosOracleError(f"{len(corrupt)} corrupt member(s) but {skipped} counted skips "
                               "on the streaming path")
    _hold_equal("stream under a corrupt member", faulted, _stream_featurize(tar_ok, batch, device))


def _device_decode_cfg():
    # snapshot pinned off: a snapshot pass would read shards and run no
    # entropy decode to corrupt
    return ingest.StreamConfig.from_env(decode_mode="device", snapshot_dir="")


def _jpeg_corrupt_entropy_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Damaged entropy-coded scan mid-batch under device decode
    (``ops.jpeg_device``; ``decode_pixels`` on a card): the member is a
    counted ``jpeg_corrupt_entropy`` skip, the rest of the batch survives,
    and the features equal a fault-free device-decode stream over the
    survivors bit for bit."""
    corrupt = tuple(fault.params["corrupt"])
    batch = int(fault.params["batch"])
    mode = fault.params["mode"]
    tar_bad, tar_ok = _tar_pair(tmpdir, "jpeg", seed, corrupt,
                                lambda data: faults.corrupt_jpeg_entropy(data, mode))
    before = counters.get("jpeg_corrupt_entropy")
    faulted = _stream_featurize(tar_bad, batch, device, config=_device_decode_cfg())
    skipped = counters.get("jpeg_corrupt_entropy") - before
    if skipped != len(corrupt):
        raise ChaosOracleError(f"{len(corrupt)} entropy-corrupt member(s) but {skipped} "
                               "counted jpeg_corrupt_entropy skips")
    _hold_equal("device-decode stream under entropy corruption", faulted,
                _stream_featurize(tar_ok, batch, device, config=_device_decode_cfg()))


def _native_entropy_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """The native entropy loop (``ops.native_entropy``) held to the
    backend-indistinguishability bar, in two legs: (1) corrupt scans
    through the native-preferred device stream are the same counted
    ``jpeg_corrupt_entropy`` skips, survivors bit-equal to a fault-free
    FORCED-PYTHON stream; (2) an unexpected native failure on call
    ``fail_at`` degrades that one image to the Python pass, counted
    ``native_entropy_fallback``, the stream still bit-equal.  Both legs
    inject at ``native_entropy.decode_scan``, which the dispatch resolves
    at call time; on a host where the library cannot build, decode_scan
    answers False and leg 1 runs the Python pass (bit-equal by
    definition)."""
    from ..ops import native_entropy as ne

    corrupt = tuple(fault.params["corrupt"])
    batch = int(fault.params["batch"])
    mode = fault.params["mode"]
    fail_at = int(fault.params["fail_at"])
    tar_bad, tar_ok = _tar_pair(tmpdir, "native", seed, corrupt,
                                lambda data: faults.corrupt_jpeg_entropy(data, mode))
    # KEYSTONE_NATIVE_ENTROPY is managed per leg: "0" pins the Python
    # oracle, unset prefers the native loop.
    saved_env = os.environ.pop(ne.NATIVE_ENTROPY_ENV, None)
    try:
        os.environ[ne.NATIVE_ENTROPY_ENV] = "0"
        clean = _stream_featurize(tar_ok, batch, device, config=_device_decode_cfg())
        del os.environ[ne.NATIVE_ENTROPY_ENV]

        before = counters.get("jpeg_corrupt_entropy")
        faulted = _stream_featurize(tar_bad, batch, device, config=_device_decode_cfg())
        skipped = counters.get("jpeg_corrupt_entropy") - before
        if skipped != len(corrupt):
            raise ChaosOracleError(f"{len(corrupt)} entropy-corrupt member(s) but {skipped} "
                                   "counted jpeg_corrupt_entropy skips through the native "
                                   "backend")
        _hold_equal("native-backend stream against the forced-Python one", faulted, clean)

        calls = [0]
        orig = ne.decode_scan

        def flaky(*args, **kwargs):
            calls[0] += 1
            if calls[0] == fail_at:
                raise RuntimeError("chaos: injected native entropy failure")
            return orig(*args, **kwargs)

        before_fb = counters.get("native_entropy_fallback")
        with _patched(ne, "decode_scan", flaky):
            leg2 = _stream_featurize(tar_ok, batch, device, config=_device_decode_cfg())
        if counters.get("native_entropy_fallback") - before_fb < 1:
            raise ChaosOracleError(
                "injected native entropy failure was not counted native_entropy_fallback "
                f"(decode_scan called {calls[0]} time(s), fail_at {fail_at})")
        _hold_equal("stream across a per-image native->Python degradation", leg2, clean)
    finally:
        if saved_env is None:
            os.environ.pop(ne.NATIVE_ENTROPY_ENV, None)
        else:
            os.environ[ne.NATIVE_ENTROPY_ENV] = saved_env


def _profiler_crash_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """The HBM watermark sampler thread (``core.profiler``) dies mid-run
    from an injected stats failure: the crash is counted
    (``profiler_sampler_crash``), the profiled stream completes, and its
    features equal an unprofiled run's.  The injected ``stats_fn`` stands
    in for the allocator poll on every device."""
    from ..core import profiler as kprof

    rng = np.random.default_rng(seed)
    batch = int(fault.params["batch"])
    crash_after = int(fault.params["crash_after"])
    tar_path = os.path.join(tmpdir, f"chaos_prof_{seed}.tar")
    faults.make_image_tar(tar_path, _N_STREAM_IMAGES, rng)
    base = _stream_featurize(tar_path, batch, device)  # the profiler off
    calls = {"n": 0}

    def crashing_stats():
        calls["n"] += 1
        if calls["n"] > crash_after:
            raise RuntimeError("injected HBM sampler crash")
        return 123 * 2**20  # a plausible bytes-in-use figure until then

    before = counters.get("profiler_sampler_crash")
    kprof.reset_state()
    try:
        with kprof.profiled(True, interval_ms=1.0, stats_fn=crashing_stats):
            profiled = _stream_featurize(tar_path, batch, device)
            # The thread polls every 1 ms: wait (bounded) for the crash.
            s = kprof.sampler()
            end = time.monotonic() + 5.0
            while s is not None and not s.crashed and time.monotonic() < end:
                time.sleep(0.01)
    finally:
        kprof.reset_state()
    crashed = counters.get("profiler_sampler_crash") - before
    if crashed != 1:
        raise ChaosOracleError(f"sampler crash injected but {crashed} counted "
                               "profiler_sampler_crash")
    _hold_equal("profiled stream under a sampler crash", profiled, base)


def _stream_hang_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Injected decoder-thread hang: the consumer's ``resilience.deadline``
    turns it into a typed ``DeadlineExceeded`` — never a deadlocked ring.
    The stream is closed and its threads joined (the hung decode ends its
    sleep) before the error propagates.  Always raises."""
    rng = np.random.default_rng(seed)
    tar_path = os.path.join(tmpdir, f"chaos_hang_{seed}.tar")
    faults.make_image_tar(tar_path, _N_STREAM_IMAGES, rng)
    budget = float(fault.params["seconds"])
    hang_at = int(fault.params["hang_at"])
    calls = {"n": 0}
    real = image_loaders.decode_image

    def hanging(data):
        calls["n"] += 1
        if calls["n"] == hang_at:
            time.sleep(4.0 * budget)  # outlives the watchdog budget
        return real(data)

    # The patch is live BEFORE the stream constructs: its producer submits
    # decodes at once, and a late patch could race past the hang_at'th.
    st = None
    try:
        with _patched(image_loaders, "decode_image", hanging):
            st = ingest.stream_batches(tar_path, 4, num_threads=2, device=device)
            with deadline(budget, phase="ingest"):
                for batch in st:
                    batch.dev()
    finally:
        if st is not None:
            st.close()
            if not st.join(10.0 * budget):
                raise ChaosOracleError("the hung stream left decoder/producer threads alive "
                                       "after its deadline")
    raise ChaosOracleError("hung decoder thread did not trip the ingest deadline — the "
                           "stream completed (or deadlocked silently)")


class _ThrashTuner:
    """Adversarial autotuner: flip EVERY ingest knob between its extremes
    every ``period`` chunks — the worst retune schedule a closed-loop
    controller could emit.  Knob motion may change speed, never results."""

    def __init__(self, period: int):
        self._period = max(1, period)
        self._chunks = 0
        self._cfg = None
        self.retunes = 0

    def attach(self, stream) -> None:
        self._cfg = stream.config

    def on_chunk(self, stream) -> None:
        self._chunks += 1
        if self._chunks % self._period:
            return
        cfg = self._cfg
        wide = cfg.decode_threads == 1
        cfg.decode_threads = cfg.max_decode_threads if wide else 1
        cfg.decode_ahead = 8 if wide else 0
        cfg.ring_capacity = 8 if wide else 1
        self.retunes += 1


def _autotune_thrash_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Oscillating mid-stream retunes: features bit-equal to a static-knob
    stream over the same tar, every retune observed, every thread joined."""
    rng = np.random.default_rng(seed)
    tar_path = os.path.join(tmpdir, f"chaos_thrash_{seed}.tar")
    faults.make_image_tar(tar_path, _N_STREAM_IMAGES, rng)
    batch = int(fault.params["batch"])
    static = _stream_featurize(tar_path, batch, device)
    tuner = _ThrashTuner(int(fault.params["period"]))
    cfg = ingest.StreamConfig(decode_threads=1, decode_ahead=0, ring_capacity=1,
                              max_decode_threads=4)
    thrash = _stream_featurize(tar_path, batch, device, config=cfg, tuner=tuner)
    if tuner.retunes < 1:
        raise ChaosOracleError("thrash tuner never retuned — the oscillation schedule did not "
                               "exercise mid-stream reconfiguration")
    _hold_equal("stream under knob thrash", thrash, static)
    counters.record("chaos_autotune_thrash",
                    f"seed {seed}: {tuner.retunes} oscillating retune(s), output bit-equal")


def _snapshot_corrupt_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Corrupt snapshot shard (``core.snapshot``): a cold pass materialises
    the decoded chunks, one shard is truncated or bit-flipped, and the
    warm pass falls back to live decode, counted ``snapshot_fallback``,
    with features bit-equal to the fault-free pass."""
    from ..core import snapshot as ksnap

    rng = np.random.default_rng(seed)
    tar_path = os.path.join(tmpdir, f"chaos_snap_{seed}.tar")
    faults.make_image_tar(tar_path, _N_STREAM_IMAGES, rng)
    snap_root = os.path.join(tmpdir, f"chaos_snap_{seed}_cache")
    batch = int(fault.params["batch"])

    def cfg():
        # the mode pinned: an ambient featurized mode commits no decoded
        # snapshot, and there would be nothing to corrupt
        return ingest.StreamConfig.from_env(snapshot_dir=snap_root, snapshot_mode="decoded")

    clean = _stream_featurize(tar_path, batch, device, config=cfg())
    committed = [s for s in ksnap.list_snapshots(snap_root) if s.get("valid")]
    if not committed:
        raise ChaosOracleError("cold snapshot pass committed no snapshot — the corruption "
                               "schedule has nothing to corrupt")
    shards = sorted(glob.glob(os.path.join(snap_root, committed[0]["dir"], "chunk_*.npz")))
    if not shards:
        raise ChaosOracleError("committed snapshot holds no shards")
    target = shards[int(fault.params["shard"]) % len(shards)]
    with open(target, "rb") as fh:
        data = bytearray(fh.read())
    if fault.params["corruption"] == "truncate":
        data = data[: max(1, len(data) // 2)]
    else:
        data[len(data) // 3] ^= 0xFF
    with open(target, "wb") as fh:
        fh.write(bytes(data))
    before = counters.get("snapshot_fallback")
    faulted = _stream_featurize(tar_path, batch, device, config=cfg())
    if counters.get("snapshot_fallback") - before < 1:
        raise ChaosOracleError("corrupt snapshot shard produced no counted snapshot_fallback")
    _hold_equal("stream over a corrupt snapshot shard", faulted, clean)


def _decode_worker_kill_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """SIGKILL a process-backend decode worker mid-stream: the pool respawns
    it (counted ``decode_worker_respawn``), resubmits its pending members,
    and the stream ends bit-equal to the thread-path oracle."""
    from ..workloads.fv_common import _scatter_parts

    rng = np.random.default_rng(seed)
    tar_path = os.path.join(tmpdir, f"chaos_kill_{seed}.tar")
    faults.make_image_tar(tar_path, _N_STREAM_IMAGES + 6, rng)
    batch = int(fault.params["batch"])
    clean = _stream_featurize(tar_path, batch, device)
    cfg = ingest.StreamConfig(decode_threads=2, decode_ahead=2, ring_capacity=1,
                              decode_backend="process", decode_procs=int(fault.params["procs"]))
    before = counters.get("decode_worker_respawn")
    parts, name_pairs, n = [], [], 0
    killed = False
    st = ingest.stream_batches(tar_path, batch, config=cfg, device=device)
    try:
        for b in st:
            if not killed:
                if st._proc_pool is None:
                    raise ChaosOracleError("process backend configured but no decode pool "
                                           "spun up — the kill schedule has no target")
                live = st._proc_pool.live_workers()
                if live:
                    os.kill(live[0].pid, signal.SIGKILL)
                    killed = True
            parts.append((b.indices, _probe(b.dev()).cpu().numpy()))
            name_pairs.extend(zip(b.indices.tolist(), b.names))
            n += len(b)
    finally:
        st.close()
    if not st.join(20.0):
        raise ChaosOracleError("worker-kill stream left decode threads/processes alive")
    if not killed:
        raise ChaosOracleError("no live decode worker to kill — the schedule never exercised "
                               "the crash path")
    if counters.get("decode_worker_respawn") - before < 1:
        raise ChaosOracleError("killed decode worker was never respawned-and-counted")
    _hold_equal("stream under a worker kill", _scatter_parts(parts, name_pairs, n), clean)
    counters.record("chaos_decode_worker_kill",
                    f"seed {seed}: worker killed, respawned, stream bit-equal")


# -- the serving phases -------------------------------------------------------


def _serve_weights(device: str, n: int = 2) -> list:
    """``n`` schedule-invariant f32[16] weight vectors on ``device``, drawn
    from the data seed in the JAX harness's order."""
    wrng = np.random.default_rng(_DATA_SEED)
    return [torch.from_numpy(wrng.normal(size=(16,)).astype(np.float32)).to(device)
            for _ in range(n)]


def _serve_engine(device: str, buckets=(1, 2, 4), mesh=None, label: str = "chaos"):
    """A tiny deterministic warm endpoint: ``max(x * w, b)``, fusion
    invariant (an exactly rounded multiply and a max), so the eager chain,
    every bucket and every device slot give the same bits and the
    phases' offline-oracle checks test the batcher, not rounding."""
    from ..core import serve as kserve
    from ..tools.serve_bench import MulMax

    w, b = _serve_weights(device)
    cfg = kserve.ServeConfig(buckets=tuple(buckets), max_wait_ms=2.0)
    return kserve.ServingEngine(MulMax(w, b), np.zeros(16, np.float32), config=cfg,
                                label=label, mesh=mesh, device=device)


def _serve_requests(rng, n: int) -> np.ndarray:
    return rng.normal(size=(n, 16)).astype(np.float32)


def _slow_client_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """One trickling client and one hammering client on the same endpoint:
    the deadline/idle flush answers the fast client without waiting for
    buckets the slow one never fills — every answer bit-equal."""
    from ..core import serve as kserve

    rng = np.random.default_rng(seed)
    engine = _serve_engine(device)
    n_slow = int(fault.params["slow_requests"])
    n_fast = int(fault.params["fast_requests"])
    think = float(fault.params["think_seconds"])
    slow_reqs = _serve_requests(rng, n_slow)
    fast_reqs = _serve_requests(rng, n_fast)
    slow_ans = [None] * n_slow
    fast_ans = [None] * n_fast
    errors: list = []
    with kserve.Server(engine) as server:

        def slow():
            try:
                for i, r in enumerate(slow_reqs):
                    slow_ans[i] = server.submit(r).result(30.0)
                    time.sleep(think)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        def fast():
            try:
                futs = [server.submit(r) for r in fast_reqs]
                for i, f in enumerate(futs):
                    fast_ans[i] = f.result(30.0)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        ts = [threading.Thread(target=slow), threading.Thread(target=fast)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
        stats = server.stats
    if errors:
        raise errors[0]
    if not np.array_equal(np.stack(slow_ans), engine.offline(slow_reqs)):
        raise ChaosOracleError("slow client's answers differ from the offline apply")
    if not np.array_equal(np.stack(fast_ans), engine.offline(fast_reqs)):
        raise ChaosOracleError("fast client's answers differ from the offline apply — a slow "
                               "batchmate changed RESULTS, not just latency")
    if stats.answered != n_slow + n_fast:
        raise ChaosOracleError(f"{stats.answered} answered != {n_slow + n_fast} submitted")
    if stats.flush_deadline + stats.flush_idle < 1:
        raise ChaosOracleError("no deadline/idle flush fired — the slow client was only "
                               "answered because the fast client happened to fill buckets")
    counters.record("chaos_slow_client", f"seed {seed}: {n_slow} trickled + {n_fast} hammered "
                    "requests answered bit-equal")


def _malformed_request_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Malformed payloads interleaved with good requests: each dies typed at
    submit (counted ``serve_malformed_request``), no batchmate poisoned."""
    from ..core import serve as kserve

    rng = np.random.default_rng(seed)
    engine = _serve_engine(device)
    n_bad = int(fault.params["bad"])
    n_good = int(fault.params["good"])
    good = _serve_requests(rng, n_good)
    bad_payloads = []
    for i in range(n_bad):
        if i % 3 == 0:  # wrong shape
            bad_payloads.append(np.zeros(7, np.float32))
        elif i % 3 == 1:  # NaN-poisoned
            r = _serve_requests(rng, 1)[0]
            r[int(rng.integers(0, 16))] = np.nan
            bad_payloads.append(r)
        else:  # uncastable dtype
            bad_payloads.append(np.array(["x"] * 16, dtype=object))
    before = counters.get("serve_malformed_request")
    rejected = 0
    with kserve.Server(engine) as server:
        futs = []
        for j in range(n_good + n_bad):
            if j % 2 == 0 and j // 2 < n_bad:
                try:
                    server.submit(bad_payloads[j // 2])
                except kserve.MalformedRequest:
                    rejected += 1
                else:
                    raise ChaosOracleError("malformed request was ACCEPTED into the queue")
            if j < n_good:
                futs.append(server.submit(good[j]))
        answers = np.stack([f.result(30.0) for f in futs])
    if rejected != n_bad:
        raise ChaosOracleError(f"{n_bad} malformed payloads but {rejected} typed rejections")
    if counters.get("serve_malformed_request") - before != n_bad:
        raise ChaosOracleError("malformed rejections were not all counted "
                               "(serve_malformed_request delta != injected)")
    if not np.array_equal(answers, engine.offline(good)):
        raise ChaosOracleError("good requests' answers differ from the offline apply — a "
                               "malformed batchmate poisoned the batch")


def _serve_burst_oom_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Out of memory on the largest bucket under a burst: the engine
    retires the bucket (counted ``serve_burst_oom``), re-answers the same
    requests through smaller buckets, and stays bit-equal."""
    from ..core import serve as kserve

    rng = np.random.default_rng(seed)
    engine = _serve_engine(device)
    burst = int(fault.params["burst"])
    failures = int(fault.params["failures"])
    top = engine.buckets()[-1]
    real_execute = engine._execute
    state = {"n": 0}

    def failing_execute(bucket, dev_batch):
        if bucket == top and state["n"] < failures:
            state["n"] += 1
            raise faults.resource_exhausted_error()
        return real_execute(bucket, dev_batch)

    requests = _serve_requests(rng, burst)
    before = counters.get("serve_burst_oom")
    engine._execute = failing_execute
    try:
        with kserve.Server(engine) as server:
            futs = [server.submit(r) for r in requests]
            answers = np.stack([f.result(30.0) for f in futs])
    finally:
        engine._execute = real_execute
    if state["n"] < failures:
        raise ChaosOracleError("the burst never dispatched the largest bucket — the OOM "
                               "schedule did not exercise the degradation path")
    if counters.get("serve_burst_oom") - before < 1:
        raise ChaosOracleError("bucket OOM was not counted under serve_burst_oom")
    if top in engine.buckets():
        raise ChaosOracleError(f"bucket {top} survived its out-of-memory error — it must be "
                               "retired, not retried in place")
    if not np.array_equal(answers, engine.offline(requests)):
        raise ChaosOracleError("answers under burst OOM differ from the offline apply")


def _wire_disconnect_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """A wire client vanishes mid-batch: the disconnect is counted
    (``wire_client_disconnect``), its requests still ride their
    micro-batches to completion, and a second client on the same endpoint
    gets every answer bit-equal."""
    from ..core import frontend as kfrontend
    from ..core import wire as kwire

    rng = np.random.default_rng(seed)
    engine = _serve_engine(device)
    n = int(fault.params["requests"])
    hold = float(fault.params["hold_seconds"])
    reqs_a = _serve_requests(rng, n)
    reqs_b = _serve_requests(rng, n)
    real_execute = engine._execute

    def slow_execute(bucket, dev_batch):
        # the disconnect lands while requests are in flight
        time.sleep(hold)
        return real_execute(bucket, dev_batch)

    before = counters.get("wire_client_disconnect")
    router = kfrontend.ShapeRouter(label=f"chaos_wire_{seed}")
    server_ref = None
    try:
        key = router.add_engine(engine)
        server_ref = router.server_for(key)
        engine._execute = slow_execute
        with kwire.WireServer(router, port=0, label="chaos") as ws:
            victim = kwire.WireClient(port=ws.port)
            for r in reqs_a:
                victim.submit(r)
            victim.close()  # mid-batch: the first micro-batch is still held
            with kwire.WireClient(port=ws.port) as survivor:
                answers = np.stack(survivor.predict_many(list(reqs_b), window=8, timeout=60.0))
        engine._execute = real_execute
        if not server_ref.drain(30.0):
            raise ChaosOracleError("serve futures did not drain after the disconnect")
    finally:
        engine._execute = real_execute
        router.close()
    if counters.get("wire_client_disconnect") - before < 1:
        raise ChaosOracleError("a client vanished with requests in flight but no "
                               "wire_client_disconnect was counted")
    if not np.array_equal(answers, engine.offline(reqs_b)):
        raise ChaosOracleError("the surviving client's answers differ from the offline apply")
    st = server_ref.stats
    if st.answered != 2 * n or st.failed != 0:
        raise ChaosOracleError(f"batch completion broke under the disconnect: answered "
                               f"{st.answered} / failed {st.failed}, expected {2 * n} / 0")


def _slow_loris_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """Slow-loris clients trickle partial frames and stall: each parks only
    its own connection's reader — the accept loop keeps accepting and
    concurrent honest clients are answered bit-equal and in time."""
    from ..core import frontend as kfrontend
    from ..core import wire as kwire

    rng = np.random.default_rng(seed)
    engine = _serve_engine(device)
    n = int(fault.params["requests"])
    lorises = int(fault.params["lorises"])
    reqs = [_serve_requests(rng, n), _serve_requests(rng, n)]
    answers: dict = {}
    errors: list = []
    router = kfrontend.ShapeRouter(label=f"chaos_loris_{seed}")
    try:
        router.add_engine(engine)
        with kwire.WireServer(router, port=0, label="chaos") as ws:
            stuck = []
            for i in range(lorises):
                s = socket.create_connection(("127.0.0.1", ws.port), 5.0)
                if i % 2 == 0:
                    s.sendall(b"\x00\x00")  # half a length prefix
                else:  # a declared 64-byte payload with one byte delivered
                    s.sendall(kwire._LEN.pack(64) + b"\x01")
                stuck.append(s)
            time.sleep(0.1)  # the loris frames reach the readers first

            def good_client(cid):
                try:
                    with kwire.WireClient(port=ws.port) as c:
                        answers[cid] = np.stack(
                            c.predict_many(list(reqs[cid]), window=8, timeout=30.0))
                except BaseException as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)

            t0 = time.monotonic()
            ts = [threading.Thread(target=good_client, args=(c,)) for c in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60.0)
            elapsed = time.monotonic() - t0
            # the accept loop still accepts while the lorises hold their
            # sockets open mid-frame
            with kwire.WireClient(port=ws.port) as probe:
                probe.ping()
            for s in stuck:
                s.close()
    finally:
        router.close()
    if errors:
        raise errors[0]
    if elapsed > 30.0:
        raise ChaosOracleError(f"honest clients took {elapsed:.1f}s behind {lorises} "
                               "slow-loris connection(s)")
    for cid in range(2):
        if not np.array_equal(answers[cid], engine.offline(reqs[cid])):
            raise ChaosOracleError(f"client {cid}'s answers differ from the offline apply "
                                   "under slow-loris load")
    counters.record("chaos_slow_loris", f"seed {seed}: {lorises} stalled partial-frame "
                    f"connection(s), 2x{n} honest requests answered bit-equal in "
                    f"{elapsed:.2f}s")


def _output_drift_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> None:
    """A shifted request mix against a served classifier whose output-drift
    monitor (``core.numerics``) is armed with a fit-time baseline: the
    divergence is counted (``serve_output_drift``) with a postmortem
    dumped, and every answer equals an unmonitored engine's."""
    from ..core import numerics as knum
    from ..core import serve as kserve
    from ..core.pipeline import FunctionTransformer

    rng = np.random.default_rng(seed)
    n_ref = int(fault.params["reference"])
    n_shift = int(fault.params["shifted"])
    scale = float(fault.params["shift_scale"])
    # Fusion-invariant classifier head (a multiply and a max, then argmax)
    # with schedule-invariant weights.
    w, b = _serve_weights(device)
    pipe = FunctionTransformer(lambda x: torch.argmax(torch.maximum(x * w, b), dim=-1),
                               name="chaos_drift_head")
    cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    engine = kserve.ServingEngine(pipe, np.zeros(16, np.float32), config=cfg,
                                  label="chaos_drift", device=device)
    ref = _serve_requests(rng, n_ref)
    baseline_rec = knum.OutputSketch.for_outputs(engine.offline(ref)).record()
    # Push the feature of the largest weight: the shifted mix's argmax
    # collapses onto that class and leaves the baseline.
    shift = np.zeros(16, np.float32)
    shift[int(np.argmax(w.cpu().numpy()))] = scale
    shifted = _serve_requests(rng, n_shift) + shift

    def serve_all():
        with kserve.Server(engine) as server:
            return np.stack([f.result(30.0) for f in [server.submit(r) for r in shifted]])

    unmonitored = serve_all()
    pm_dir = os.path.join(tmpdir, f"chaos_drift_{seed}_pm")
    before = counters.get("serve_output_drift")
    try:
        with _postmortems_to(pm_dir, "serve_output_drift"), knum.monitored(True):
            engine.arm_drift_baseline(baseline_rec)
            monitored = serve_all()
            drift_rec = engine.drift.record()
    finally:
        knum.reset_state()
    if counters.get("serve_output_drift") - before < 1:
        raise ChaosOracleError(f"shifted request mix (divergence {drift_rec['divergence']}, tol "
                               f"{drift_rec['tol']}) produced no counted serve_output_drift")
    if not glob.glob(os.path.join(pm_dir, "postmortem_serve_output_drift_*.json")):
        raise ChaosOracleError("serve_output_drift was counted but no postmortem was dumped")
    if not np.array_equal(monitored, unmonitored):
        raise ChaosOracleError("monitored engine's answers differ from the unmonitored "
                               "engine's — the observatory changed RESULTS")
    if not np.array_equal(monitored, engine.offline(shifted)):
        raise ChaosOracleError("served answers under drift detection differ from the offline "
                               "apply")


def _slots(data: int, device: str):
    from ..parallel.mesh import make_mesh

    return make_mesh(data, 1, devices=[_slot_device(device)] * data)


def _mesh_shrink_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> dict:
    """Device loss mid-serve, both halves.  Leg 1: a router anchored on 4
    slots of ``device`` has requests in flight when the mesh shrinks to the
    schedule's survivors; ``ShapeRouter.reanchor`` hot-swaps every engine,
    every answer equal to the offline apply, counted ``mesh_reanchor``.
    Leg 2: state saved sharded under the full mesh refuses a plain load
    with a ``CheckpointMismatch`` naming ``mesh=``, then loads onto the
    survivors (counted ``ckpt_reshard``) with the fault-free answers.
    Returns the re-anchor's record with the requests ``in_flight`` at the
    loss and the router's mesh after it (``router_mesh``)."""
    from ..core import autoshard
    from ..core import frontend as kfrontend
    from ..core import serve as kserve
    from ..core.checkpoint import CheckpointMismatch, load_pipeline, save_pipeline
    from ..ops.stats import StandardScalerModel
    from ..parallel.mesh import replicate, use_mesh
    from ..tools.serve_bench import MulMax

    rng = np.random.default_rng(seed)
    n = int(fault.params["requests"])
    hold = float(fault.params["hold_seconds"])
    full, surviving = _slots(4, device), _slots(int(fault.params["survivors"]), device)

    # -- leg 1: live re-anchor with requests in flight --------------------
    wrng = np.random.default_rng(_DATA_SEED)
    w, b = (torch.from_numpy(wrng.normal(size=(16,)).astype(np.float32)).to(device)
            for _ in range(2))

    def build(shape, dtype, mesh):
        cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
        return kserve.ServingEngine(MulMax(w, b), np.zeros(shape, dtype), config=cfg,
                                    label=f"chaos_shrink_{seed}", mesh=mesh, device=device)

    reqs = _serve_requests(rng, 2 * n)
    factory = kfrontend.MeshEngineFactory(build, mesh=full)
    router = kfrontend.ShapeRouter(
        factory, label=f"chaos_shrink_{seed}",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0))
    before = counters.get("mesh_reanchor")
    try:
        engine = factory((16,), np.float32)
        router.add_engine(engine)
        offline = engine.offline(reqs)
        real_execute = engine._execute

        def slow_execute(bucket, dev_batch):
            time.sleep(hold)  # the loss lands while requests are in flight
            return real_execute(bucket, dev_batch)

        engine._execute = slow_execute
        try:
            futs = [router.submit(r) for r in reqs[:n]]
            in_flight = sum(not f.done() for f in futs)
            rec = router.reanchor(surviving, why=f"chaos seed {seed}: device loss")
        finally:
            engine._execute = real_execute
        futs += [router.submit(r) for r in reqs[n:]]
        answers = np.stack([np.asarray(f.result(60.0)) for f in futs])
        router_mesh = router.record()["mesh"]
    finally:
        router.close()
    if rec["failed"]:
        raise ChaosOracleError(f"re-anchor left shapes on the dead mesh: {rec['failed']}")
    if counters.get("mesh_reanchor") - before < 1:
        raise ChaosOracleError("engines re-anchored onto the surviving mesh but no "
                               "mesh_reanchor was counted")
    if not np.array_equal(answers, offline):
        raise ChaosOracleError("answers across the re-anchor differ from the offline apply")

    # -- leg 2: checkpoint on the full mesh, resume on the survivors ------
    mean = torch.from_numpy(wrng.normal(size=(16,)).astype(np.float32)).to(device)
    std = torch.from_numpy(np.abs(wrng.normal(size=(16,)).astype(np.float32)) + 1.0).to(device)
    scaler = StandardScalerModel(autoshard.spec_sharding("data@dim0", full, 1).place(mean), std)
    test_rows = torch.from_numpy(_serve_requests(rng, n)).to(device)
    fault_free = StandardScalerModel(mean, std)(test_rows)
    with use_mesh(full):
        stem = save_pipeline(os.path.join(tmpdir, f"chaos_shrink_{seed}_ckpt"), scaler)
    try:
        load_pipeline(stem, device=device)
    except CheckpointMismatch as e:
        if "mesh=" not in str(e):
            raise ChaosOracleError(f"the topology refusal does not name the mesh= reshard "
                                   f"path: {e}") from e
    else:
        raise ChaosOracleError("a checkpoint holding full-mesh-sharded arrays loaded silently "
                               "onto a different topology")
    before_rs = counters.get("ckpt_reshard")
    resumed = load_pipeline(stem, mesh=surviving)
    if counters.get("ckpt_reshard") - before_rs < 1:
        raise ChaosOracleError("the checkpoint resumed on the surviving mesh but no "
                               "ckpt_reshard was counted")
    if not torch.equal(replicate(resumed, _slot_device(device))(test_rows), fault_free):
        raise ChaosOracleError("predictions resumed on the surviving mesh differ from the "
                               "fault-free full-mesh run")
    return {**rec, "in_flight": in_flight, "router_mesh": router_mesh}


def _chaos_hosts(fault: Fault) -> int:
    return int(os.environ.get("KEYSTONE_CHAOS_HOSTS", fault.params["hosts"]))


def _host_loss_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> dict:
    """A serving host dies mid-flight: the multi-host drill (real
    subprocess hosts where spawn is available, in-process wire servers
    otherwise) held to :func:`_judge_host_loss`.  Returns the drill's
    record."""
    from ..workloads.multihost import run_host_loss_drill

    _reopen_postmortems("host_reanchor", "fleet_host_lost", "mesh_reanchor")
    before = counters.snapshot()
    rec = run_host_loss_drill(tmpdir, hosts=_chaos_hosts(fault),
                              requests=int(fault.params["requests"]), seed=seed,
                              device=device, timeout_s=180.0)
    _judge_host_loss(rec, before)
    return rec


def _judge_host_loss(rec: dict, before: dict) -> None:
    """The host-loss bar: every request answered bit-equal to the offline
    oracle, none dropped, no client error; every survivor re-formed the
    group (``dist_reform``) and re-anchored (``host_reanchor``); the
    front-end counted the loss (``fleet_host_lost``) and the controller the
    re-anchor since the counters' ``before`` snapshot; a ``host_reanchor``
    postmortem dumped; with subprocess members, a request in flight on the
    host when it was SIGKILLed."""
    if rec["mode"] == "subprocess" and rec["in_flight_at_kill"] < 1:
        raise ChaosOracleError("no request was in flight on the host when it was killed — "
                               "the in-flight failover went unexercised")
    if rec["dropped_requests"] != 0:
        raise ChaosOracleError(f"host loss dropped {rec['dropped_requests']} request(s) "
                               f"({rec['answered']}/{rec['requests']} answered; errors: "
                               f"{rec['errors']})")
    if rec["mismatches"] != 0:
        raise ChaosOracleError(f"{rec['mismatches']} answer(s) differ from the offline oracle "
                               "after the host loss — silent wrong answers")
    if rec["errors"]:
        raise ChaosOracleError(f"fleet clients saw errors across the loss: {rec['errors']}")
    for r, sc in rec["survivor_counters"].items():
        if sc.get("dist_reform", 0) < 1:
            raise ChaosOracleError(f"survivor {r} never re-formed the group: {sc}")
        if sc.get("host_reanchor", 0) < 1:
            raise ChaosOracleError(f"survivor {r} never re-anchored its engines: {sc}")
    if counters.get("fleet_host_lost") - before.get("fleet_host_lost", 0) < 1:
        raise ChaosOracleError("the front-end never counted the host loss (fleet_host_lost)")
    if counters.get("host_reanchor") - before.get("host_reanchor", 0) < 1:
        raise ChaosOracleError("the re-anchor was never counted controller-side "
                               "(host_reanchor)")
    if not [p for p in rec["postmortems"] if "host_reanchor" in p]:
        raise ChaosOracleError(f"no host_reanchor postmortem dumped (got {rec['postmortems']})")


def _obs_capture_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> dict:
    """A fleet member is killed mid-scrape: the fleet-observability drill
    (subprocess members where spawn is available) held to
    :func:`_judge_obs_capture`.  Returns the drill's record."""
    from ..workloads.multihost import run_obs_capture_drill

    _reopen_postmortems("obs_member_lost", "fleet_host_lost")
    before = counters.snapshot()
    rec = run_obs_capture_drill(tmpdir, hosts=_chaos_hosts(fault),
                                requests=int(fault.params["requests"]), seed=seed,
                                timeout_s=180.0, device=device)
    _judge_obs_capture(rec, before)
    return rec


def _judge_obs_capture(rec: dict, before: dict) -> None:
    """The collector's bar: counters equal the sum of the members', p99
    from the pooled windows, the loss counted ``obs_member_lost`` (since
    the counters' ``before`` snapshot, postmortem-linked) with the view
    monotone, ONE clock-aligned incident bundle with every survivor's
    flight ring, and every request answered bit-equal to the offline
    oracle."""
    if rec["dropped_requests"] != 0:
        raise ChaosOracleError(f"obs drill dropped {rec['dropped_requests']} request(s) "
                               f"({rec['answered']}/{rec['requests']} answered; errors: "
                               f"{rec['errors']})")
    if rec["mismatches"] != 0:
        raise ChaosOracleError(f"{rec['mismatches']} answer(s) differ from the offline oracle "
                               "with the collector attached")
    if not rec.get("counter_sum_ok"):
        raise ChaosOracleError(f"fleet counters != sum of per-member snapshots: "
                               f"{rec.get('counter_sum_mismatch')}")
    if not rec.get("p99_match"):
        raise ChaosOracleError(f"fleet p99 {rec.get('p99_fleet')} does not come from the pooled "
                               f"windows (pick oracle {rec.get('p99_oracle_pick')}, numpy "
                               f"oracle {rec.get('p99_oracle_np')}, pool n="
                               f"{rec.get('p99_pool_n')})")
    if not rec.get("monotone_ok"):
        raise ChaosOracleError(f"fleet counters stepped BACKWARDS across the member loss: "
                               f"{rec.get('monotone_violations')}")
    if counters.get("obs_member_lost") - before.get("obs_member_lost", 0) < 1:
        raise ChaosOracleError("the collector never counted the member loss (obs_member_lost)")
    incident = rec.get("incident") or {}
    if incident.get("error"):
        raise ChaosOracleError(f"incident capture wrote {incident['error']} for one member "
                               "loss — expected exactly one bundle")
    if incident.get("schema") != "keystone.incident/1":
        raise ChaosOracleError(f"incident bundle is not schema-tagged: {incident}")
    if not incident.get("survivor_rings_ok"):
        raise ChaosOracleError(f"the incident bundle is missing a surviving member's flight "
                               f"ring: {incident}")
    if not incident.get("events_monotone"):
        raise ChaosOracleError("incident bundle events are not on one monotone clock-aligned "
                               "timeline")
    if not [p for p in rec["postmortems"] if "obs_member_lost" in p]:
        raise ChaosOracleError(f"no obs_member_lost postmortem dumped (got {rec['postmortems']})")


def _stepdown_oracle(res: dict, stepdown_delta: int, *, require_specs: bool = False,
                     require_mesh: bool = False) -> None:
    """The plan/spec-mispredict oracle: the searched placement record proves
    the top-ranked plan died and the fit chose the NEXT-ranked one, with
    the step-down counted.  ``require_mesh``/``require_specs`` also pin
    that the killed plan was a mesh plan / a searched spec layout."""
    placement = res.get("placement")
    if placement is None:
        raise ChaosOracleError("no searched placement in results — the mispredict families "
                               "require the placement search to be active")
    ranking, chosen = placement["ranking"], placement["chosen"]
    top = ranking[0] if ranking else None
    top_rec = next((c for c in placement["candidates"] if c["name"] == top), {})
    if require_mesh and not top_rec.get("mesh"):
        raise ChaosOracleError(f"top-ranked plan {top!r} is not a mesh plan — the schedule did "
                               "not exercise a sharded layout")
    if require_specs and not top_rec.get("specs"):
        raise ChaosOracleError(f"top-ranked plan {top!r} carries no spec assignment — the "
                               "schedule killed the default layout, not a searched spec layout")
    if len(ranking) < 2 or chosen != ranking[1]:
        raise ChaosOracleError(f"top-ranked plan {top!r} died but the fit chose {chosen!r}, "
                               f"not the next-ranked "
                               f"{ranking[1] if len(ranking) > 1 else None!r}")
    if stepdown_delta < 1:
        raise ChaosOracleError("the top-ranked plan died out of memory but no "
                               f"autoshard_stepdown was counted (top candidate: {top_rec})")


def _drift_refit_phase(fault: Fault, tmpdir: str, seed: int, device: str) -> dict:
    """The closed lifecycle loop and its fault legs, on one deployment:
    (0) a shifted request mix trips the armed drift monitor and the
    controller sees the trip; (A) a refit that runs out of memory fetching
    fresh features degrades typed and counted (``refit_failed``) to the
    incumbent; (B) a candidate fit on garbage labels is rejected by the
    holdout gate (``refit_rejected``); (C) a mid-swap kill degrades typed
    and counted; (D) the clean cycle lands with requests in flight
    (``lifecycle_refit``, a postmortem, drift re-armed, zero dropped,
    pre-swap answers the incumbent's, post-swap answers an offline
    refit's); (E) a trip inside the fresh cooldown is a counted
    suppression (``refit_suppressed``).  Returns the landed cycle's record
    with the number of ``requests_in_flight`` across its swap."""
    from ..core import frontend as kfrontend
    from ..core import numerics as knum
    from ..core import serve as kserve
    from ..core.lifecycle import LifecycleConfig, LifecycleController
    from ..ops.stats import StandardScalerModel
    from ..solvers.block import BlockLeastSquaresEstimator

    rng = np.random.default_rng(seed)
    n_ref = int(fault.params["reference"])
    n_shift = int(fault.params["shifted"])
    scale = float(fault.params["shift_scale"])
    n_rows = int(fault.params["rows"])
    n_req = int(fault.params["requests"])
    hold = float(fault.params["hold_seconds"])

    # Two worlds, one deployment: before the drift the truth is
    # (x - mean0) @ T1, after it (x - mean0) @ T2, so the incumbent is
    # wrong on the new mix and a refit on fresh data fixes it.
    wrng = np.random.default_rng(_DATA_SEED)
    mean0 = wrng.normal(size=(16,)).astype(np.float32)
    t1 = wrng.normal(size=(16, 4)).astype(np.float32)
    t2 = wrng.normal(size=(16, 4)).astype(np.float32)
    featurizer = StandardScalerModel(torch.from_numpy(mean0).to(device), None)
    shift = np.zeros(16, np.float32)
    shift[int(np.argmax(np.abs(t1).sum(axis=1)))] = scale

    def estimator():
        return BlockLeastSquaresEstimator(block_size=16, num_iter=1, lam=0.0)

    def fit_model(feats, labels):
        return estimator().fit(torch.from_numpy(feats).to(device),
                               torch.from_numpy(labels).to(device))

    xa = _serve_requests(rng, n_rows)
    feats_a = xa - mean0
    pipe_inc = featurizer.then(fit_model(feats_a, feats_a @ t1))
    cfg = kserve.ServeConfig(buckets=(1, 2, 4), max_wait_ms=2.0)
    engine_inc = kserve.ServingEngine(pipe_inc, np.zeros(16, np.float32), config=cfg,
                                      label=f"chaos_refit_inc_{seed}", device=device)
    ref = _serve_requests(rng, n_ref)
    baseline_rec = knum.OutputSketch.for_outputs(engine_inc.offline(ref)).record()

    xb = _serve_requests(rng, n_rows) + shift
    feats_b = xb - mean0
    labels_b = feats_b @ t2
    # big enough that the noise-fit candidate's holdout error dwarfs even a
    # badly wrong incumbent's
    labels_noise = rng.normal(size=labels_b.shape).astype(np.float32) * 50.0
    hx = _serve_requests(rng, 64) + shift
    hy = (hx - mean0) @ t2
    shifted = _serve_requests(rng, n_shift) + shift
    reqs_mid = _serve_requests(rng, n_req) + shift
    reqs_post = _serve_requests(rng, n_req) + shift

    # The offline refit oracle on the same fresh data.
    pipe_offline = featurizer.then(fit_model(feats_b, labels_b))
    offline_refit = pipe_offline(torch.from_numpy(reqs_post).to(device)).cpu().numpy()

    mode = {"fetch": "good"}

    def fetch(digest):
        if mode["fetch"] == "oom":
            raise faults.resource_exhausted_error()
        if mode["fetch"] == "noise":
            return feats_b, labels_noise
        return feats_b, labels_b

    def quality(predict, x, y):
        return -float(np.mean((np.asarray(predict(x)) - y) ** 2))

    pm_dir = os.path.join(tmpdir, f"chaos_refit_{seed}_pm")
    kinds = ("serve_output_drift", "refit_failed", "refit_rejected", "lifecycle_refit",
             "drift_rearmed", "refit_suppressed")
    before = {k: counters.get(k) for k in kinds}

    def delta(kind):
        return counters.get(kind) - before[kind]

    def answers(futs) -> np.ndarray:
        return np.stack([np.asarray(f.result(30.0)) for f in futs])

    router = kfrontend.ShapeRouter(
        label=f"chaos_refit_{seed}",
        config=kfrontend.RouterConfig(warm_threshold=1, retire_after_s=300.0))
    ctl = None
    try:
        with _postmortems_to(pm_dir, "serve_output_drift", "lifecycle_refit"):
            router.add_engine(engine_inc)
            ctl = LifecycleController(
                router, workdir=os.path.join(tmpdir, f"chaos_refit_{seed}_wd"),
                featurizer=featurizer, fetch=fetch, estimator=estimator,
                assemble=lambda model: featurizer.then(model), holdout=lambda: (hx, hy),
                quality=quality, example=np.zeros(16, np.float32),
                label=f"chaos_refit_{seed}", serve_config=cfg,
                config=LifecycleConfig(cooldown_s=0.0, poll_interval_s=0.05), device=device)
            with knum.monitored(True):
                engine_inc.arm_drift_baseline(baseline_rec)
                # -- leg 0: the shifted mix trips the armed monitor ----------------------------
                mon = answers([router.submit(r) for r in shifted])
                if not np.array_equal(mon, engine_inc.offline(shifted)):
                    raise ChaosOracleError("served answers under drift detection differ from the "
                                           "incumbent's offline apply")
                if delta("serve_output_drift") < 1:
                    raise ChaosOracleError("shifted request mix produced no counted "
                                           "serve_output_drift — the monitor missed the shift")
                reason = ctl.check_signals()
                if reason != "serve_output_drift":
                    raise ChaosOracleError(f"the lifecycle watcher did not see the drift trip "
                                           f"(check_signals -> {reason!r})")

                def incumbent_still_serving(leg):
                    table = router.engines()
                    if table.get((16,)) != engine_inc.label:
                        raise ChaosOracleError(f"{leg}: the failed cycle touched the routing "
                                               f"table ({table}) — a half-swapped model serves")
                    probe = _serve_requests(rng, 3) + shift
                    if not np.array_equal(answers([router.submit(r) for r in probe]),
                                          engine_inc.offline(probe)):
                        raise ChaosOracleError(f"{leg}: post-fault answers differ from the "
                                               "incumbent's offline apply")

                # -- leg A: refit OOM degrades typed + counted ---------------------------------
                mode["fetch"] = "oom"
                rec = ctl.run_refit(reason=reason)
                if rec["outcome"] != "refit_failed" or delta("refit_failed") < 1:
                    raise ChaosOracleError(f"injected refit OOM was not a counted typed "
                                           f"degradation: {rec}")
                incumbent_still_serving("refit OOM")

                # -- leg B: a WORSE candidate is rejected, never swapped -----------------------
                mode["fetch"] = "noise"
                rec = ctl.run_refit(reason="operator")
                if rec["outcome"] != "rejected" or delta("refit_rejected") < 1:
                    raise ChaosOracleError(f"a candidate refit worse than the incumbent was not "
                                           f"rejected+counted: {rec}")
                incumbent_still_serving("validation rejection")

                # -- leg C: a mid-swap kill degrades typed + counted ---------------------------
                mode["fetch"] = "good"
                real_replace = router.replace_engine
                failed_before = delta("refit_failed")

                def killed_replace(engine, **kw):
                    raise kserve.ServingUnavailable("injected mid-swap kill")

                router.replace_engine = killed_replace
                try:
                    rec = ctl.run_refit(reason="operator")
                finally:
                    router.replace_engine = real_replace
                if (rec["outcome"] != "refit_failed" or rec.get("phase") != "swap"
                        or delta("refit_failed") <= failed_before):
                    raise ChaosOracleError(f"a mid-swap kill was not a counted typed degradation "
                                           f"to the incumbent: {rec}")
                incumbent_still_serving("mid-swap kill")

                # -- leg D: the clean cycle lands, requests in flight --------------------------
                ctl.config.cooldown_s = 300.0  # leg E exercises the storm guard
                inflight_mid = []
                real_execute = engine_inc._execute

                def slow_execute(bucket, dev_batch):
                    # the swap straddles live requests (drain-after-unroute
                    # answers them on the OLD engine)
                    time.sleep(hold)
                    return real_execute(bucket, dev_batch)

                def replace_with_traffic(engine, **kw):
                    inflight_mid.extend(router.submit(r) for r in reqs_mid)
                    return real_replace(engine, **kw)

                engine_inc._execute = slow_execute
                router.replace_engine = replace_with_traffic
                try:
                    landed = ctl.run_refit(reason=reason)
                finally:
                    engine_inc._execute = real_execute
                    router.replace_engine = real_replace
                if landed["outcome"] != "swapped" or delta("lifecycle_refit") < 1:
                    raise ChaosOracleError(f"the clean drift->refit->swap cycle did not land "
                                           f"counted: {landed}")
                if delta("drift_rearmed") < 1:
                    raise ChaosOracleError("the swap landed but the drift monitor was not "
                                           "re-armed on the candidate's baseline")
                dropped, mid_answers = 0, []
                for f in inflight_mid:
                    try:
                        mid_answers.append(np.asarray(f.result(60.0)))
                    except Exception:  # noqa: BLE001 — counted as a drop
                        dropped += 1
                if dropped:
                    raise ChaosOracleError(f"{dropped} request(s) in flight across the hot-swap "
                                           "were dropped — the swap opened a service gap")
                if not np.array_equal(np.stack(mid_answers), engine_inc.offline(reqs_mid)):
                    raise ChaosOracleError("in-flight answers across the swap differ from the "
                                           "incumbent's offline apply")
                if router.server_for((16,)).engine is engine_inc:
                    raise ChaosOracleError("the swap left the incumbent routed")
                if not np.array_equal(answers([router.submit(r) for r in reqs_post]),
                                      offline_refit):
                    raise ChaosOracleError("post-swap answers differ from the offline refit "
                                           "— the lifecycle served a model that is not the "
                                           "refit")
                if not glob.glob(os.path.join(pm_dir, "postmortem_lifecycle_refit_*.json")):
                    raise ChaosOracleError("lifecycle_refit was counted but no postmortem was "
                                           "dumped — the swap left no evidence")

                # -- leg E: the cooldown storm guard -------------------------------------------
                rec = ctl.run_refit(reason="operator")
                if rec["outcome"] != "suppressed" or delta("refit_suppressed") < 1:
                    raise ChaosOracleError(f"a trip inside the cooldown was not a counted "
                                           f"suppression: {rec}")
        return {**landed, "requests_in_flight": len(inflight_mid)}
    finally:
        if ctl is not None:
            ctl.close()
        router.close()
        knum.reset_state()


#: family -> its phase, run before the fault-free workload (stream_hang's
#: phase always raises).
_PHASES = {
    "io_transient": _ingest_phase,
    "corrupt_members": _ingest_phase,
    "stream_corrupt": _stream_corrupt_phase,
    "stream_hang": _stream_hang_phase,
    "jpeg_corrupt_entropy": _jpeg_corrupt_entropy_phase,
    "native_entropy": _native_entropy_phase,
    "profiler_crash": _profiler_crash_phase,
    "autotune_thrash": _autotune_thrash_phase,
    "snapshot_corrupt": _snapshot_corrupt_phase,
    "decode_worker_kill": _decode_worker_kill_phase,
    "slow_client": _slow_client_phase,
    "malformed_request": _malformed_request_phase,
    "serve_burst_oom": _serve_burst_oom_phase,
    "wire_disconnect": _wire_disconnect_phase,
    "slow_loris": _slow_loris_phase,
    "output_drift": _output_drift_phase,
    "mesh_shrink": _mesh_shrink_phase,
    "host_loss": _host_loss_phase,
    "obs_capture": _obs_capture_phase,
    "drift_refit": _drift_refit_phase,
}


def _run_faulted(fault: Fault, workload: str, tmpdir: str, seed: int, device: str):
    """Apply one schedule to the workload on ``device``; returns the
    results dict (or raises).  Every patch is restored on exit."""
    phase = _PHASES.get(fault.kind)
    if phase is not None:
        phase(fault, tmpdir, seed, device)
        return _run_workload(workload, device)

    if fault.kind == "solver_oom":
        with faults.oom_faults(block_mod, "_fused_bcd_impl", failures=fault.params["failures"]):
            return _run_workload(workload, device)

    if fault.kind == "oom_cascade":
        # Fused dies, then the stepwise tier's first block update: the
        # ladder walks fused -> stepwise -> host_staged.
        with faults.oom_faults(block_mod, "_fused_bcd_impl", failures=1):
            with faults.oom_faults(block_mod, "_bcd_block_solve", failures=1):
                return _run_workload(workload, device)

    if fault.kind == "plan_mispredict":
        # The search's top-ranked plan (fused, on these shapes) dies out of
        # memory at its dispatch: the fit walks to the NEXT searched plan.
        before = counters.get("autoshard_stepdown")
        with faults.oom_faults(block_mod, "_fused_bcd_impl", failures=fault.params["failures"]):
            res = _run_workload(workload, device)
        _stepdown_oracle(res, counters.get("autoshard_stepdown") - before)
        return res

    if fault.kind == "spec_mispredict":
        # A spec candidate on the fault-free mesh baseline's head mesh is
        # forced to the top (conf.solve_plan -> fit(plan=[name])) and dies
        # at the mesh tier: the fit steps down to the default layout,
        # counted, judged against the fault-free MESH baseline.
        base_pl = baseline(workload, mesh=True, device=device).get("placement")
        forced = None
        if base_pl and base_pl.get("ranking"):
            head = next((c for c in base_pl["candidates"]
                         if c["name"] == base_pl["ranking"][0]), {})
            forced = next(([c["name"]] for c in base_pl["candidates"]
                           if c.get("specs") and not c["pruned"]
                           and c["mesh"] == head.get("mesh")), None)
        before = counters.get("autoshard_stepdown")
        with faults.oom_faults(block_mod, "_execute_fused_bcd_mesh",
                               failures=fault.params["failures"]):
            res = _run_workload(workload, device, mesh=_spec_mesh(device), solve_plan=forced)
        _stepdown_oracle(res, counters.get("autoshard_stepdown") - before,
                         require_specs=forced is not None, require_mesh=True)
        return res

    if fault.kind == "nan_input":
        frac = fault.params["frac"]
        rng = np.random.default_rng(seed)

        def poison(train):
            if hasattr(train, "data"):  # LabeledData
                return dataclasses.replace(train, data=faults.inject_nan(train.data, rng, frac))
            return dataclasses.replace(  # LabeledImageBatch
                train, images=faults.inject_nan(train.images, rng, frac))

        return _run_workload(workload, device, train_override=poison)

    if fault.kind == "preempt_resume":
        ckpt_path = os.path.join(tmpdir, f"chaos_bcd_{workload}_{seed}")
        writer = block_mod.bcd_checkpoint_writer(ckpt_path)
        after = int(fault.params["preempt_after_blocks"])
        calls = {"n": 0}

        def preempting_cb(state):
            writer(state)
            calls["n"] += 1
            if calls["n"] >= after:
                raise SimulatedPreemption(f"injected preemption after block {state['block']} "
                                          f"of epoch {state['epoch']}")

        try:
            _run_workload(workload, device, solve_checkpoint=preempting_cb)
        except SimulatedPreemption:
            pass
        else:
            raise ChaosOracleError("preemption callback never fired — the checkpointing "
                                   "stepwise path was not taken")
        counters.record("chaos_preemption", f"{workload} seed {seed}: resuming from {ckpt_path}")
        return _run_workload(workload, device, solve_checkpoint=ckpt_path,
                             solve_resume=ckpt_path)

    if fault.kind == "deadline":
        real = block_mod._fused_bcd_impl

        def hanging_impl(*a, **kw):
            time.sleep(600.0)  # interrupted by the deadline watchdog
            return real(*a, **kw)

        with _patched(block_mod, "_fused_bcd_impl", hanging_impl):
            with deadline(float(fault.params["seconds"]), phase="solve"):
                return _run_workload(workload, device)

    raise ValueError(f"unknown fault family {fault.kind!r}")


def expected_outcome(fault: Fault) -> str:
    """What a HEALTHY system does under this schedule."""
    if fault.kind in ("nan_input", "deadline", "stream_hang"):
        return "typed_error"
    return "completed_equal"


def run_schedule(seed: int, workload: str = "mnist", tmpdir: str | None = None,
                 trace_path: str | None = None, device="cuda") -> ChaosResult:
    """Run ONE seeded fault schedule end to end on ``device`` and judge the
    outcome.  ``trace_path``: write this schedule's Chrome trace there —
    every counted fault lands in it as a ``fault`` instant (``kind``
    attribute) and every failed span carries its error type, for
    :func:`verify_trace`."""
    device = _device(device)
    fault = make_schedule(seed)
    own_tmp = tmpdir is None
    if own_tmp:
        tmpdir = tempfile.mkdtemp(prefix="chaos_")
    t0 = time.monotonic()
    result = ChaosResult(seed=seed, workload=workload, fault=fault, outcome="")
    with _clean_env():
        # spec_mispredict runs under a mesh: it is judged against the
        # fault-free MESH baseline.
        base = baseline(workload, mesh=fault.kind == "spec_mispredict", device=device)
        if trace_path is not None:
            # this trace holds exactly this schedule's events
            trace.reset()
            trace.enable(trace_path)
        before = counters.snapshot()
        try:
            result.outcome = _judge_schedule(result, fault, workload, tmpdir, seed, base, device)
        finally:
            after = counters.snapshot()
            result.counters_delta = {k: after[k] - before.get(k, 0) for k in after
                                     if after[k] != before.get(k, 0)}
            if trace_path is not None:
                trace.flush(trace_path)
                trace.disable()
                result.trace_path = trace_path
    result.seconds = time.monotonic() - t0
    if own_tmp:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return result


def _judge_schedule(result, fault, workload, tmpdir, seed, base, device) -> str:
    """Run one faulted schedule and return the judged outcome (filling
    ``result``'s error fields)."""
    try:
        res = _run_faulted(fault, workload, tmpdir, seed, device)
    except TYPED_ERRORS as e:
        result.error_type = type(e).__name__
        result.error = str(e)
        result.phase = getattr(e, "phase", None)
        return "typed_error"
    except ChaosOracleError as e:
        result.error_type = type(e).__name__
        result.error = str(e)
        return "ORACLE_FAILED"
    except Exception as e:  # noqa: BLE001 — the contract violation case
        result.error_type = type(e).__name__
        result.error = str(e)
        return "UNTYPED_ERROR"
    got = res.get("test_predictions")
    want = base.get("test_predictions")
    if got is None or want is None:
        # a missing prediction vector never scores as equal
        result.error = ("no test_predictions to compare "
                        f"(faulted: {got is not None}, baseline: {want is not None})")
        return "ORACLE_FAILED"
    if _preds_equal(got, want):
        return "completed_equal"
    result.error = "run completed but predictions differ from the fault-free baseline"
    return "SILENT_WRONG_MODEL"


def verify_trace(trace_path: str, result: ChaosResult) -> list[str]:
    """Hold one schedule's trace to the never-silent bar; returns the
    violations (empty = clean): every fault kind counted during the
    schedule appears as a ``fault`` instant with that ``kind``, and a
    typed-error outcome shows as a span that failed with that error type
    or as a counted fault event."""
    with open(trace_path) as f:
        if trace_path.endswith(".jsonl"):
            events = [json.loads(line) for line in f if line.strip()]
        else:
            doc = json.load(f)
            events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    fault_kinds = {ev.get("args", {}).get("kind") for ev in events
                   if ev.get("ph") == "i" and ev.get("name") == "fault"}
    span_errors = {ev.get("args", {}).get("error") for ev in events
                   if ev.get("ph") == "X" and ev.get("args", {}).get("error")}
    missing = [f"counted fault {kind!r} has no trace event"
               for kind in sorted(result.counters_delta) if kind not in fault_kinds]
    if (result.outcome == "typed_error" and result.error_type not in span_errors
            and not fault_kinds):
        missing.append(f"typed error {result.error_type} appears in no span and no fault "
                       "event — a silent typed failure")
    return missing


def run_suite(seeds, workload: str = "mnist", trace_dir: str | None = None,
              device="cuda") -> list[ChaosResult]:
    """:func:`run_schedule` for each seed on ``device``, one trace per
    schedule under ``trace_dir`` (``chaos_seed<N>.json``)."""
    tmpdir = tempfile.mkdtemp(prefix="chaos_suite_")
    try:
        return [
            run_schedule(s, workload=workload, tmpdir=tmpdir, device=device,
                         trace_path=(os.path.join(trace_dir, f"chaos_seed{s}.json")
                                     if trace_dir is not None else None))
            for s in seeds
        ]
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
