"""The serving tier's typed failures and its integer knob parser, with no
torch: ``core.wire``'s client half imports them, and a wire client process
(``tools/serve_client.py``) must not create a CUDA context.  ``core.serve``
and ``core.frontend`` re-export every name, so they are importable from
there as in the JAX package."""

from __future__ import annotations

import os


class ServeError(RuntimeError):
    """Base of the serving subsystem's typed failures."""


class MalformedRequest(ServeError, ValueError):
    """A request that cannot enter a batch: wrong shape, uncastable dtype,
    or non-finite payload.  Raised at ``submit`` (counted
    ``serve_malformed_request``) before it can poison its batchmates."""


class ServingUnavailable(ServeError):
    """The endpoint cannot answer: every batch bucket OOMed away, or the
    server was closed with requests still pending."""


class NoRouteForShape(ServeError):
    """No live engine serves the request's shape and the router has no
    engine factory to warm one — a permanently unroutable request."""


class RetryLater(ServeError):
    """Typed backpressure: the request was NOT accepted (unserved shape
    still below the warm threshold, an engine mid-warm, or admission out
    of headroom); retry after ``retry_after_s``.  The wire tier maps this
    onto a RETRY_AFTER frame."""

    def __init__(self, message: str, retry_after_s: float = 0.05):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def _env_pos_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None
    if val < 1:
        raise ValueError(f"{name}={raw!r} must be >= 1")
    return val
