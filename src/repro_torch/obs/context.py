"""TopoWatch request context: per-request ids + deadlines via contextvars
(the port's copy of ``repro.obs.context``).

Every serve frontend's ``submit()`` mints a :class:`RequestContext` (or
adopts the ambient one installed by :func:`request_context`) and stamps
its ``request_id``/``deadline`` onto the returned future; ``span()``
picks the ambient context up automatically so every trace event of a
request carries its ``rid``.  Deadlines are *absolute* ``time.monotonic``
instants — the drain-side sweep compares against one clock regardless of
which thread executes the batch.

The context is asyncio-safe and thread-inheriting-free by construction
(``contextvars``): a drain thread never sees the submitter's context
unless it opts in, so batch-side spans attribute to the batch, not to
whichever request happened to submit last.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import time
from typing import Iterator, Optional


class DeadlineExceeded(TimeoutError):
    """A request's deadline passed before a drain could execute it.

    Raised *through the future* (``fut.result()``) by the drain-side
    deadline sweep — the request is dropped from its queue, never
    executed, and counted in ``serve.deadline_exceeded`` per bucket.
    """


@dataclasses.dataclass(frozen=True)
class RequestContext:
    """One request's identity + time budget.

    ``deadline`` is an absolute ``time.monotonic()`` instant (None = no
    deadline).  ``attrs`` are free-form key/value pairs propagated into
    spans opened under this context.
    """

    request_id: str
    deadline: Optional[float] = None
    attrs: tuple[tuple[str, str], ...] = ()

    def remaining_s(self) -> Optional[float]:
        """Seconds until the deadline (negative once expired); None when
        the request has no deadline."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline


_CTX: contextvars.ContextVar[Optional[RequestContext]] = \
    contextvars.ContextVar("repro_torch_obs_request_context", default=None)

_RID_COUNTER = itertools.count()
_RID_PREFIX = f"{os.getpid() & 0xFFFF:04x}"


def new_request_id(prefix: str = "r") -> str:
    """Process-unique request id (``r-<pid16>-<seq>``); cheap enough to
    mint on every submit."""
    return f"{prefix}-{_RID_PREFIX}-{next(_RID_COUNTER)}"


def deadline_in(timeout_s: Optional[float]) -> Optional[float]:
    """Relative timeout -> absolute monotonic deadline (None passes through)."""
    if timeout_s is None:
        return None
    return time.monotonic() + float(timeout_s)


def current() -> Optional[RequestContext]:
    """The ambient request context of this thread/task, or None."""
    return _CTX.get()


def current_request_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx.request_id if ctx is not None else None


@contextlib.contextmanager
def request_context(request_id: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    **attrs) -> Iterator[RequestContext]:
    """Install an ambient request context for the enclosed block.

    ``submit()`` calls made inside the block adopt this id/deadline
    instead of minting fresh ones, and every ``obs.span`` opened inside
    carries ``rid=<request_id>`` — so one client call threads a single
    identity through submit, drain spans, and the resolved future.

    Nesting: an inner ``request_context()`` without an explicit
    ``deadline_s`` inherits the outer deadline (a sub-operation can never
    outlive its parent's budget); an explicit inner deadline is clamped
    to the outer one.
    """
    outer = _CTX.get()
    if request_id is None:
        request_id = new_request_id()
    deadline = deadline_in(deadline_s)
    if outer is not None and outer.deadline is not None:
        deadline = (outer.deadline if deadline is None
                    else min(deadline, outer.deadline))
    ctx = RequestContext(
        request_id=request_id, deadline=deadline,
        attrs=tuple(sorted((str(k), str(v)) for k, v in attrs.items())))
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def resolve_submit(request_id: Optional[str],
                   deadline_s: Optional[float]
                   ) -> tuple[str, Optional[float]]:
    """The (request_id, absolute deadline) a ``submit()`` should stamp.

    Explicit arguments win; otherwise the ambient :func:`request_context`
    supplies both; otherwise a fresh id with no deadline is minted.  An
    explicit relative ``deadline_s`` is still clamped to an ambient
    deadline when one exists.
    """
    ctx = _CTX.get()
    if request_id is None:
        request_id = ctx.request_id if ctx is not None else new_request_id()
    deadline = deadline_in(deadline_s)
    if ctx is not None and ctx.deadline is not None:
        deadline = (ctx.deadline if deadline is None
                    else min(deadline, ctx.deadline))
    return request_id, deadline
