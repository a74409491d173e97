"""Shared future plumbing for the serving layers (the port's copy of
``repro.serve.futures``).

``TopoFuture`` (stateless batch serving) and ``StreamFuture`` (stateful
sessions) resolve through the same thread-safe event/value/error mechanics;
this base class keeps that behavior in one place so fixes cannot silently
diverge between the two.

TopoWatch additions: every future carries the request id and optional
absolute deadline minted by ``submit()`` (see
:mod:`repro_torch.obs.context`), and callers can ``cancel()`` a pending
future — the drain skips cancelled work instead of executing it for
nobody.  Without cancellation, a caller whose ``result(timeout=...)``
raised would leave the request queued and it would still burn a kernel
slot on the next drain (the queued-forever leak).
"""
from __future__ import annotations

import threading
import time
from typing import Optional


class FutureCancelled(RuntimeError):
    """Raised by ``result()`` on a future the caller cancelled."""


class ServeFuture:
    """Thread-safe one-shot future resolved by a later ``drain()``.

    ``result()`` blocks until a drain — possibly on another thread — fulfils
    it; async callers can ``await asyncio.to_thread(fut.result)`` or poll
    ``done()``.

    Resolution is first-writer-wins under ``_state_lock``: once resolved,
    failed, or cancelled, later transitions are no-ops — so a drain racing
    a ``cancel()`` can never overwrite the caller-visible outcome.
    """

    __slots__ = ("_event", "_value", "_error", "_cancelled", "_state_lock",
                 "submitted_at", "resolved_at", "request_id", "deadline")

    def __init__(self, request_id: Optional[str] = None,
                 deadline: Optional[float] = None):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._state_lock = threading.Lock()
        self.submitted_at = time.perf_counter()
        self.resolved_at: Optional[float] = None
        #: request id minted by submit() (``obs.context``); None for
        #: futures created outside a serving frontend.
        self.request_id = request_id
        #: absolute ``time.monotonic()`` deadline, or None.  Drains sweep
        #: expired futures and fail them with ``DeadlineExceeded``.
        self.deadline = deadline

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def cancel(self) -> bool:
        """Cancel a pending request; True if this call won the race.

        The future resolves immediately (``result()`` raises
        :class:`FutureCancelled`) and the next drain discards the queued
        work instead of executing it.  Cancelling an already-resolved
        future is a no-op returning False.
        """
        with self._state_lock:
            if self._event.is_set():
                return False
            self._cancelled = True
            self._error = FutureCancelled(
                f"request {self.request_id or '?'} cancelled by caller")
            self.resolved_at = time.perf_counter()
            self._event.set()
            return True

    def expired(self, now: Optional[float] = None) -> bool:
        """True when a deadline is set and already past."""
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"{type(self).__name__} not resolved within timeout "
                "(is a drain loop running?)")
        if self._error is not None:
            raise self._error
        return self._value

    def latency_s(self) -> float:
        """submit->resolve wall time; valid once done()."""
        if self.resolved_at is None:
            raise RuntimeError("future not resolved yet")
        return self.resolved_at - self.submitted_at

    def _resolve(self, value) -> bool:
        with self._state_lock:
            if self._event.is_set():
                return False
            self._value = value
            self.resolved_at = time.perf_counter()
            self._event.set()
            return True

    def _fail(self, err: BaseException) -> bool:
        with self._state_lock:
            if self._event.is_set():
                return False
            self._error = err
            self.resolved_at = time.perf_counter()
            self._event.set()
            return True
