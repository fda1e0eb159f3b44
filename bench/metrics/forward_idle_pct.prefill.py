"""The share of the traced window (``window_s``, the denominator of
``device_idle_pct.prefill``) in which the card was idle while the host
was inside a ``serve.prefill`` span of the program: the union of those
spans (``user_annotation`` events of the profiler's trace, on the clock
of the device's events) less its overlap with the device's busy union.
Idle there is the host falling behind its own launches.  No checkout
span overlaps a prefill span, so this share and
``checkout_idle_pct.prefill`` are disjoint, and ``device_idle_pct.prefill``
less their sum is the benchmark's own loop: the queue, the prompt stack,
the argmax's copy.  None without a trace or without such spans."""
from bench.devtrace import _union


def read(run):
    t = run.get("trace")
    if t is None or t.window_s <= 0:
        return None
    spans = _union((s, e) for s, e, name, cat in t.host
                   if cat == "user_annotation" and name == "serve.prefill")
    if not spans:
        return None
    idle_us = (sum(e - s for s, e in _union(spans + t.busy))
               - sum(e - s for s, e in t.busy))
    return 100.0 * idle_us * 1e-6 / t.window_s
