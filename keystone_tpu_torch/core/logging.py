"""Logging trait analog (counterpart of keystone_tpu/core/logging.py).

Python stdlib logging with the same convenience surface, plus a wall-clock
stage timer (the reference's ``"Pipeline took N s"`` lines) that is also a
``trace.span`` (cat ``stage``) in the ``KEYSTONE_TRACE`` timeline and a
``torch.profiler.record_function`` range, so stages show up in a PyTorch
profiler trace.

The stage timer does not synchronize: CUDA work is asynchronous, so a stage
whose time must include its device work ends in a synchronize inside the
``with`` block.

As a library we never touch the root logger; workload entry points call
:func:`configure_logging` to get console output (level from the
``KEYSTONE_LOG_LEVEL`` env knob unless passed explicitly).  Torch is
imported only inside :func:`stage_timer`.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

from . import trace

_ROOT = logging.getLogger("keystone_tpu_torch")
_ROOT.addHandler(logging.NullHandler())

#: env var: log level name ("DEBUG", "INFO", ...) or numeric level for
#: :func:`configure_logging` when the caller does not pass one.
LOG_LEVEL_ENV = "KEYSTONE_LOG_LEVEL"


def _env_level(default: int = logging.INFO) -> int:
    raw = os.environ.get(LOG_LEVEL_ENV, "").strip()
    if not raw:
        return default
    if raw.lstrip("-").isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    if isinstance(level, int):
        return level
    raise ValueError(
        f"{LOG_LEVEL_ENV}={raw!r} is neither a level name "
        "(DEBUG/INFO/WARNING/ERROR/CRITICAL) nor a number"
    )


def configure_logging(level: int | None = None) -> None:
    """Attach a console handler to the keystone_tpu_torch logger tree.
    Called by workload CLIs (never on import).  ``level`` defaults to the
    ``KEYSTONE_LOG_LEVEL`` env knob, then INFO."""
    if level is None:
        level = _env_level()
    if any(not isinstance(h, logging.NullHandler) for h in _ROOT.handlers):
        _ROOT.setLevel(level)
        return
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    _ROOT.addHandler(handler)
    _ROOT.setLevel(level)


class Logging:
    """Mixin giving ``log_info`` etc. on a per-class logger under the
    keystone_tpu_torch hierarchy."""

    @property
    def logger(self) -> logging.Logger:
        return logging.getLogger(f"keystone_tpu_torch.{type(self).__name__}")

    def log_debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def log_info(self, msg, *args):
        self.logger.info(msg, *args)

    def log_warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def log_error(self, msg, *args):
        self.logger.error(msg, *args)


@contextlib.contextmanager
def stage_timer(name: str, logger: logging.Logger | None = None):
    """Time a pipeline stage: the ``"<name> took N s"`` log line, a
    ``trace.span`` (cat ``stage``) in the ``KEYSTONE_TRACE`` timeline, and
    a ``torch.profiler.record_function`` range for the PyTorch profiler."""
    from torch.profiler import record_function

    logger = logger or _ROOT
    t0 = time.perf_counter()
    with trace.span(name, cat="stage"):
        with record_function(name):
            yield
    logger.info("%s took %.3f s", name, time.perf_counter() - t0)
