"""Spans and markers on the torch profiler's clock.

A span is a `torch.profiler.record_function` range named "tuun." + its
name, so it lies on the clock of the device trace that the same session
records.  It is entered only while a profiler session runs (`traced()`):
with no session a span that times no phase is one shared no-op context,
and nothing turns spans on but a session.  A span given a `phases` dict
also adds its wall seconds (perf_counter) to it under `key` (the name's
last dotted part by default): the tracker's `op_log` phases are timed
this way, so the log and the trace share one timing.

`torch.autograd.profiler._is_profiler_enabled` is set for the whole
process by any session; `torch.autograd._profiler_enabled()` reads True
only on a thread the session records (the thread that started a
default session; none at all under a session that records every
thread).  `traced()` asks both, so every thread enters its spans under
any session; a default session keeps only its own thread's, one that
records every thread keeps the workers' too.

A marker is a span of no length: `mark("scan.prefix_sum_rows_f32:256x1024")`;
`@spanned(name)` runs a whole function inside a span.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Dict, Optional

from torch.autograd import _profiler_enabled
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

PREFIX = "tuun."

_OFF = contextlib.nullcontext()


def traced() -> bool:
    """Whether a profiler session runs, on this thread or any."""
    return _profiler_enabled() or \
        getattr(_profiler, "_is_profiler_enabled", False)


class _Span:
    __slots__ = ("name", "phases", "key", "args", "_rf", "_t0")

    def __init__(self, name, phases, key, args):
        self.name = name
        self.phases = phases
        self.key = key
        self.args = args

    def __enter__(self) -> "_Span":
        if traced():
            self._rf = record_function(
                PREFIX + self.name,
                None if self.args is None else str(self.args))
            self._rf.__enter__()
        else:
            self._rf = None
        if self.phases is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.phases is not None:
            key = self.key or self.name.rpartition(".")[2]
            self.phases[key] = self.phases.get(key, 0.0) + \
                time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, phases: Optional[Dict[str, float]] = None,
         key: Optional[str] = None, args: Any = None):
    """`with span("tracker.sync"):` records "tuun.tracker.sync" under a
    session; `phases` (a dict) gains the span's seconds under `key`;
    `args` (any value, str() taken only under a session) is kept as the
    record_function's argument where the installed torch keeps it."""
    if phases is None and not traced():
        return _OFF
    return _Span(name, phases, key, args)


def mark(name: str) -> None:
    """A zero-length span "tuun." + name, while a session runs."""
    if traced():
        with record_function(PREFIX + name):
            pass


def spanned(name: str):
    """Decorates a function to run inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not traced():
                return fn(*args, **kwargs)
            with _Span(name, None, None, None):
                return fn(*args, **kwargs)
        return inner
    return wrap
