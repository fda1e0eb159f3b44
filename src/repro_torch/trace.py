"""Spans and counters inside the port, on the profiler's clock.

Tracing is on while ``torch.profiler`` records, or between ``enable()``
and ``disable()``.  Off, ``span``, ``spanned`` and ``count`` cost one
check (a module flag and the profiler's own flag): no ``record_function``,
no clock read, nothing kept.

On, a span records its name, an id, its parent's id, its thread, host
start and end (``time.perf_counter_ns``) and optional attributes; while
the profiler records it also opens a ``torch.profiler.record_function``
range of the same name, so the profiled run has every span as a
``user_annotation`` event on the clock of the device's events.  The parent is the innermost span open on the same
thread; a thread with none open takes the most recently opened span still
open on any thread, so the autograd engine's device thread, which runs
the backward while the calling thread waits inside its span, nests under
that span.  A span made with ``device=True`` also records a CUDA event at
each end on the current stream; its device milliseconds are resolved when
the spans are read, after a synchronize, and placed on the host clock
through one anchor (a CUDA event and ``perf_counter_ns`` taken together,
by ``enable()`` or by the first device span).  A counter is a named
integer added to only while tracing is on.

Spans are kept in memory until ``clear()``, at most ``MAX_SPANS`` of
them (later ones are counted in ``dropped()`` and not kept, so a long
``--trace`` run stays bounded): ``spans()`` returns the closed ones (each span's self time, its duration less the part its children
cover, computed there), ``counters()`` the totals, and
``export_chrome(path)`` writes both as one Chrome trace, the host spans a
track per thread and the device spans one track.

The spans and counters placed in the program, each with what reads it
(a benchmark metric, ``bench/metrics/<name>.py``, or the operator's
``--trace PATH`` file of ``launch.train`` and ``launch.serve``):

- ``checkout.flush``, ``checkout.dispatch``, ``checkout.deliver``
  (``serve.checkout.BatchedCheckoutServer``): ``checkout_idle_pct.prefill``;
- ``serve.prefill`` (``serve.serve_step``'s prefill step, attributes
  ``b``, ``s``): ``forward_idle_pct.prefill``, ``weight_cast_gb.prefill``;
- ``model.block``, ``model.head`` (``models.transformer.forward``), the
  blocks again inside remat's recompute: the ``--trace`` file;
- the counter ``model.weight_cast_bytes`` (``sharding.cast_weight``, the
  one cast of a parameter at use, ``gather_weight``'s too):
  ``weight_cast_gb.prefill`` and ``weight_cast_gb.train``;
- ``train.step`` (device, attribute ``step``; ``train.train_step``'s
  step): ``attn_backward_pct.train``, ``weight_cast_gb.train``;
- ``train.forward``, ``train.backward``, ``train.optimizer``,
  ``train.reduce``, ``train.compress``: the ``--trace`` file;
- ``attn.backward`` (device; ``kernels.ops``'s flash backward, attributes
  ``path``, "kernel" or "plain", and the call's ``b``, ``sq``, ``sk``,
  ``h``, ``hkv``, ``dqk``, ``dv`` and ``causal``): ``attn_backward_pct.train``
  and ``flash_backward_roofline.train``;
- ``data.batch`` (``data.VersionedDataset.batches``), ``serve.fill``,
  ``serve.decode`` (``launch.serve``): the ``--trace`` file.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler


class Span:
    """One span, and the context that records it.  ``device_ms`` and
    ``device_start_ns`` (on the host clock) for a device span once read,
    else None; ``self_ns`` once read."""

    __slots__ = ("name", "id", "parent", "thread", "start_ns", "end_ns",
                 "attrs", "device_ms", "device_start_ns", "self_ns",
                 "_events", "_range", "_stack")

    def __init__(self, name: str, attrs: dict, device: bool = False):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.thread = self._range = None
        self.start_ns = self.end_ns = 0
        self.device_ms = self.device_start_ns = self.self_ns = None
        self._events = () if device and torch.cuda.is_initialized() else None

    def __enter__(self) -> "Span":
        t = _local()
        self._stack = st = t.stack
        self.thread = t.tid
        with _S.lock:
            self.id = next(_S.ids)
            if st:
                self.parent = st[-1].id
            elif _S.open:
                self.parent = next(reversed(_S.open.values())).id
            _S.open[self.id] = self
        st.append(self)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        if self._events is not None:
            if _S.anchor is None:
                _anchor()
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._stack.pop()
        self._stack = None
        with _S.lock:
            del _S.open[self.id]
            if len(_S.closed) < MAX_SPANS:
                _S.closed.append(self)
            else:
                _S.dropped += 1


class _Thread:
    """A thread's open spans and its counts (summed on read)."""

    def __init__(self):
        self.tid = threading.get_native_id()
        self.thread = threading.current_thread()
        self.stack: list = []
        self.counts: dict = {}


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.enabled = False
        self.ids = itertools.count(1)
        self.open: dict = {}            # id -> Span, in the order opened
        self.closed: list = []
        self.dropped = 0                # closed spans past MAX_SPANS
        self.threads: list = []         # each live thread's _Thread
        self.retired: dict = {}         # the counts of threads that ended
        self.anchor = None              # (CUDA event, perf_counter_ns)
        self.local = threading.local()


MAX_SPANS = 1 << 20
_S = _State()
_OFF = contextlib.nullcontext()


def _local() -> _Thread:
    t = getattr(_S.local, "t", None)
    if t is None:
        t = _S.local.t = _Thread()
        with _S.lock:
            live = []
            for o in _S.threads:
                if o.thread.is_alive():
                    live.append(o)
                else:
                    _add(_S.retired, o.counts)
            _S.threads = live + [t]
    return t


def _add(into: dict, counts: dict) -> None:
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


def on() -> bool:
    """Whether spans and counts are recorded now."""
    return _S.enabled or _profiler._is_profiler_enabled


def enable() -> None:
    """Record spans and counts until ``disable()``, with or without the
    profiler; anchors the device clock where CUDA is in use."""
    with _S.lock:
        _S.enabled = True
    if torch.cuda.is_initialized():
        _anchor()


def disable() -> None:
    with _S.lock:
        _S.enabled = False


def clear() -> None:
    """Drops every closed span, every count and the anchor."""
    with _S.lock:
        _S.closed = []
        _S.dropped = 0
        _S.anchor = None
        _S.retired = {}
        for t in _S.threads:
            t.counts.clear()


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while tracing is on."""
    if _S.enabled or _profiler._is_profiler_enabled:
        c = _local().counts
        c[name] = c.get(name, 0) + int(n)


def counters() -> dict:
    with _S.lock:
        parts = [_S.retired.copy()] + [t.counts.copy() for t in _S.threads]
    out: dict = {}
    for part in parts:
        _add(out, part)
    return out


def dropped() -> int:
    """The closed spans not kept because ``MAX_SPANS`` were."""
    return _S.dropped


def _anchor() -> None:
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    host = time.perf_counter_ns()
    with _S.lock:
        if _S.anchor is None:
            _S.anchor = (ev, host)


def span(name: str, device: bool = False, **attrs):
    """A context for one span named ``name`` (a no-op while tracing is
    off); ``device=True`` also times it on the card."""
    if not (_S.enabled or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, attrs, device)


def spanned(name: str):
    """Decorates a function so that each call is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_S.enabled or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def _self_times(spans: list) -> None:
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    for s in spans:
        covered, reach = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            lo, hi = max(a, reach), min(b, s.end_ns)
            if hi > lo:
                covered += hi - lo
                reach = hi
        s.self_ns = s.end_ns - s.start_ns - covered


def spans() -> list:
    """The closed spans in order of their start, device times resolved
    (one synchronize where any is pending) and self times computed."""
    with _S.lock:
        out = list(_S.closed)
        anchor = _S.anchor
    pending = [s for s in out if s._events is not None]
    if pending:
        torch.cuda.synchronize()
        ev0, host0 = anchor
        for s in pending:
            start, end = s._events
            s.device_ms = start.elapsed_time(end)
            s.device_start_ns = host0 + round(ev0.elapsed_time(start) * 1e6)
            s._events = None
    _self_times(out)
    return sorted(out, key=lambda s: (s.start_ns, s.id))


def export_chrome(path: str) -> None:
    """Writes the spans and the counters as one Chrome trace (µs on the
    host clock): each host span on its thread's track, each device span
    again on the track of tid 0, the counters' totals at the last end,
    and ``dropped()`` as ``otherData.dropped_spans``."""
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "device (CUDA events)"}}]
    last = 0
    for s in spans():
        args = {"id": s.id, "parent": s.parent,
                "self_ms": s.self_ns * 1e-6, **s.attrs}
        events.append({"name": s.name, "ph": "X", "cat": "span", "pid": pid,
                       "tid": s.thread, "ts": s.start_ns * 1e-3,
                       "dur": (s.end_ns - s.start_ns) * 1e-3, "args": args})
        last = max(last, s.end_ns)
        if s.device_ms is not None:
            events.append({"name": s.name, "ph": "X", "cat": "device span",
                           "pid": pid, "tid": 0,
                           "ts": s.device_start_ns * 1e-3,
                           "dur": s.device_ms * 1e3, "args": args})
    for name, value in counters().items():
        events.append({"name": name, "ph": "C", "pid": pid,
                       "ts": last * 1e-3, "args": {"value": value}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"dropped_spans": dropped()}}, f)
