"""The attention backward's share of a training step on the card: the
device milliseconds of the program's ``attn.backward`` spans (CUDA
events around the flash backward, ``kernels.ops``) over those of its
``train.step`` spans, both summed over the traced slice (the spans are
recorded while the profiler records; ``repro_torch.trace``). None where
the program has no such spans. The store is the process's own and is
never cleared here, so the reading assumes, as ``bench/run.py`` does,
one traced slice a process: the only time the profiler records."""


def read(run):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    ms = {"attn.backward": 0.0, "train.step": 0.0}
    for s in trace.spans():
        if s.name in ms and s.device_ms is not None:
            ms[s.name] += s.device_ms
    if ms["attn.backward"] <= 0 or ms["train.step"] <= 0:
        return None
    return 100.0 * ms["attn.backward"] / ms["train.step"]
