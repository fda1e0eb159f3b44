"""The end-to-end metrics' arithmetic: a rate is all the work over all
the window's time, a percentile (the knee's sweep) is over every
request, and a stall in the window moves each."""
import numpy as np
import pytest

from bench import manifest, stats


def served(service, gap=0.1):
    """Requests arriving every ``gap`` seconds at a first come, first
    served server that takes ``service[i]`` for request i."""
    free, out = 0.0, []
    for i, dt in enumerate(service):
        start = max(free, i * gap)
        free = start + dt
        out.append({"ttft_s": free - i * gap})
    return {"requests": out}


def p95_ms(run):
    return stats.percentile([1e3 * r["ttft_s"] for r in run["requests"]],
                            95)


def batches(times, late=()):
    """Back-to-back prefill batches of 4 prompts of 256 tokens taking
    ``times``, then batches served after the window taking ``late``."""
    out = [{"b": 4, "len": 256, "in_window": True}] * len(times)
    out += [{"b": 4, "len": 256, "in_window": False}] * len(late)
    return {"batches": out, "window_s": float(sum(times))}


def steps(times):
    """Back-to-back steps of 1024 tokens taking ``times``."""
    return {"steps": [{"tokens": 1024}] * len(times),
            "window_s": float(sum(times))}


def test_percentile_is_numpy_linear():
    xs = np.random.default_rng(0).random(37)
    for q in (50, 90, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_rate_is_all_work_over_all_time():
    run = steps([0.1] * 9 + [0.2])
    assert manifest.reader("train_tok_s")(run) == pytest.approx(
        10 * 1024 / 1.1)


def test_p95_is_over_every_request():
    run = served([0.05] * 76 + [1.0] + [0.05] * 3)
    # 80 requests; the stalled one and the three queued behind it wait
    # 1.0, 0.95, 0.9 and 0.85 s: the 95th percentile lies 0.05 of the
    # way from order statistic 75 (0.05 s) to 76 (0.85 s)
    assert p95_ms(run) == pytest.approx(90.0)


def test_a_stall_moves_rate_and_tail():
    rate, prefill = manifest.reader("train_tok_s"), \
        manifest.reader("prefill_tok_s")
    assert rate(steps([0.1] * 37 + [0.5] * 3)) < rate(steps([0.1] * 40))
    assert prefill(batches([0.1] * 37 + [0.5] * 3)) < \
        prefill(batches([0.1] * 40))
    assert p95_ms(served([0.05] * 37 + [0.5] * 3)) > \
        p95_ms(served([0.05] * 40))


def test_train_rate():
    run = {"steps": [{"tokens": 100}] * 5, "window_s": 2.0}
    assert manifest.reader("train_tok_s")(run) == 250.0


def test_prefill_rate_counts_the_window_alone():
    """The batches served after the window, from the queue left at its
    close, add neither tokens nor time."""
    run = batches([0.1] * 9 + [0.2], late=[0.1] * 5)
    assert manifest.reader("prefill_tok_s")(run) == pytest.approx(
        10 * 4 * 256 / 1.1)
    assert manifest.reader("prefill_tok_s")({"batches": []}) is None
