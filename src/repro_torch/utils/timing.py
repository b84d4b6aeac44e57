"""Wall-clock helpers and the program's tracer.

``now``/``Timer`` read the monotonic clock (real time for the live path;
the simulator keeps its own clock).

The tracer records spans at the layer boundaries of the job: the train
step, the checkpoint plane and the restore.  It is off unless ``enable()``
is called; while off, ``span()`` returns one shared object that records
nothing.  While on, a span records its name, its start and end on
``time.perf_counter()``, its thread, its parent (the innermost span open
on the same thread when it opened) and its attributes.  A span given no
``step`` or ``kind`` takes its parent's, so every span of one train step
carries that step's number, and every span of one checkpoint trigger the
trigger's step and kind.  Counts (bytes on the link, allocator retries)
are attributes of the span at whose boundary they are taken;
``span(..., retries_of=device)`` adds ``alloc_retries``, the allocations
the CUDA caching allocator retried over the span (each retry frees its
cached blocks, which synchronises the device).

On the thread that called ``enable()`` (the one that runs the trainer's
loop) a span also enters ``torch.profiler.record_function("repro_torch."
+ name)``: a running profiler then puts it on its own timeline, the clock
its device activity is on.  Spans of other threads (the checkpoint
plane's transfer threads) stay in memory only.  Finished spans are kept
in a bounded buffer, the newest ``capacity`` of them, which counts the
ones it dropped (the job runs for as long as it is given).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Optional

PROFILER_PREFIX = "repro_torch."
CAPACITY = 1 << 16
INHERITED = ("step", "kind")


def now() -> float:
    return time.monotonic()


class Timer:
    """Context-manager timer: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self) -> "Timer":
        self._t0 = time.monotonic()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.monotonic() - self._t0


class _Off:
    """What ``span``/``pending`` return while tracing is off: one shared
    object that records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        pass

    def done(self) -> None:
        pass


OFF = _Off()


class Span:
    """One span: ``id``, ``name``, ``start``/``end`` (s on
    ``time.perf_counter``), ``thread`` (the name of the thread it ended
    on), ``parent`` (the id of its parent span, or None) and ``attrs``."""

    __slots__ = ("id", "name", "start", "end", "thread", "parent", "attrs",
                 "_tracer", "_generation", "_fn", "_left", "_lock",
                 "_device", "_retries")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 parent: Optional["Span"], retries_of=None):
        self.id = next(tracer._ids)
        self.name, self.attrs, self._tracer = name, attrs, tracer
        self._generation = tracer._generation
        self.parent = None if parent is None else parent.id
        if parent is not None:
            for key in INHERITED:
                if key not in attrs and key in parent.attrs:
                    attrs[key] = parent.attrs[key]
        self.start = self.end = None
        self.thread = None
        self._fn = None
        self._device, self._retries = retries_of, None

    def set(self, **attrs) -> None:
        """Add attributes (counts known only once the work is done)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tracer = self._tracer
        if threading.get_ident() == tracer._profiled:
            import torch
            self._fn = torch.profiler.record_function(PROFILER_PREFIX
                                                      + self.name)
            self._fn.__enter__()
        if self._device is not None:
            self._retries = alloc_retries(self._device)
        tracer._stack().append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        self._tracer._stack().remove(self)
        if self._retries is not None:
            self.attrs["alloc_retries"] = (alloc_retries(self._device)
                                           - self._retries)
        if self._fn is not None:
            self._fn.__exit__(None, None, None)
            self._fn = None
        self.thread = threading.current_thread().name
        self._tracer._keep(self)

    def done(self) -> None:
        """One of a pending span's parts has finished; the last ends it
        (``Tracer.pending``)."""
        with self._lock:
            self._left -= 1
            last = self._left == 0
        if last:
            self.end = time.perf_counter()
            self.thread = threading.current_thread().name
            self._tracer._keep(self)

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "start": self.start,
                "end": self.end, "thread": self.thread,
                "parent": self.parent, "attrs": dict(self.attrs)}


class Tracer:
    """Spans of one process (``TRACER`` below is the program's)."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = False
        self.capacity = capacity
        self.dropped = 0
        self._done: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._generation = 0
        self._profiled: Optional[int] = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:
            if span._generation != self._generation:
                return            # opened before the last reset()
            if len(self._done) == self.capacity:
                self.dropped += 1
            self._done.append(span)

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def span(self, name: str, retries_of=None, **attrs):
        """A context manager that records ``name`` over its body (and the
        allocator's retries on the CUDA device ``retries_of``)."""
        if not self.enabled:
            return OFF
        return Span(self, name, attrs, self.current(), retries_of)

    def pending(self, name: str, parts: int):
        """A span from now until ``parts`` calls of its ``done()`` have
        come, from any threads (work queued here and finished elsewhere);
        its parent is the span open here.  One span, not one per part."""
        if not self.enabled or parts <= 0:
            return OFF
        span = Span(self, name, {}, self.current())
        span._left, span._lock = parts, threading.Lock()
        span.start = time.perf_counter()
        return span

    def enable(self) -> None:
        """Record spans from now on; the calling thread's spans also go to
        the profiler."""
        self._profiled = threading.get_ident()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Forget every finished span and the count of dropped ones."""
        with self._lock:
            self._done.clear()
            self.dropped = 0
            self._generation += 1

    def spans(self) -> list:
        """The finished spans, in the order they ended."""
        with self._lock:
            return list(self._done)


TRACER = Tracer()


def alloc_retries(device) -> Optional[int]:
    """How many allocations the CUDA caching allocator has retried on
    ``device`` after freeing its cached blocks (a retry synchronises the
    device first); None off CUDA.  A count for span attributes."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device).get("num_alloc_retries", 0)


def span(name: str, retries_of=None, **attrs):
    return TRACER.span(name, retries_of, **attrs)


def pending(name: str, parts: int):
    return TRACER.pending(name, parts)


def enabled() -> bool:
    return TRACER.enabled


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def spans() -> list:
    return TRACER.spans()


def dropped() -> int:
    return TRACER.dropped
