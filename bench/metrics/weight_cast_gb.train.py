"""The float32 weights read by casts to the compute dtype a training
step (the forward, remat's recompute, the norms' backward): the
program's ``model.weight_cast_bytes`` counter over the traced slice
(counted while the profiler records; ``repro_torch.trace``) over the
number of its ``train.step`` spans there, in 1e9 bytes. None where the
program has no such counter or spans. The store is the process's own and
is never cleared here, so the reading assumes, as ``bench/run.py`` does,
one traced slice a process: the only time the profiler records."""


def read(run):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    n = sum(s.name == "train.step" for s in trace.spans())
    cast = trace.counters().get("model.weight_cast_bytes")
    if not n or cast is None:
        return None
    return cast / n * 1e-9
