"""The port on the card: the CUDA ``checkout_wave`` against its plain torch
version, and the wave engine and server on a CUDA store against the numpy
gather.  This file imports neither jax nor the JAX package, so it runs on
a machine with a GPU and no jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs the card and skips without one."""
import numpy as np
import pytest
import torch

import repro_torch.kernels.checkout_batched as cb
from repro_torch.core import generate, store_from_arrays
from repro_torch.core.checkout import checkout_wave, peek_superblock
from repro_torch.serve import BatchedCheckoutServer, RetryPolicy

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _hand_plans(r):
    """A run tile, a row tile, a tail-promoted tile, a run ending at r and
    a run whose stale hi forces row gathers."""
    starts = np.concatenate([
        np.arange(0, 8), [3, 17, 5, r - 1, 2, 2, 30, 1],
        [20, 21, 22, 23, 23, 23, 23, 23], np.arange(r - 8, r),
        [10, 11, 12, 13, 13, 13, 13, 13]]).astype(np.int32)
    return (starts, np.array([1, 0, 1, 1, 1], np.int32),
            np.array([16, r, 32, r, 15], np.int32))


@pytest.mark.parametrize("dtype,d", [(torch.int32, 128),
                                     (torch.float16, 256),
                                     (torch.float32, 512)])
def test_cuda_checkout_wave_matches_plain(cuda_device, dtype, d):
    data = torch.arange(40 * d).reshape(40, d).to(dtype).to(cuda_device)
    s, m, h = (torch.from_numpy(a).to(cuda_device) for a in _hand_plans(40))
    before = cb.LAUNCHES
    got = cb.checkout_wave(data, s, m, h)
    assert cb.LAUNCHES == before + 1
    want = cb.checkout_wave_plain(data, s, m, h)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[32:40], data[s[32:40].long()])   # stale hi


def test_cuda_checkout_wave_rejects_misaligned_rows(cuda_device):
    data = torch.zeros((16, 6), dtype=torch.int16, device=cuda_device)
    s, m, h = (torch.zeros(n, dtype=torch.int32, device=cuda_device)
               for n in (8, 1, 1))
    with pytest.raises(ValueError):          # 12-byte rows
        cb.checkout_wave(data, s, m, h)


def _store(device, seed=0):
    w = generate("SCI", n_versions=60, inserts=80, n_branches=6,
                 n_attrs=20, seed=seed)
    rng = np.random.default_rng(seed)
    assignment = rng.permutation(np.arange(w.n_versions) % 5)
    return store_from_arrays(w.graph.indptr, w.graph.indices,
                             w.graph.n_records, w.data, assignment,
                             device=device), w


def test_cuda_wave_engine_matches_numpy(cuda_device):
    store, w = _store(cuda_device)
    vids = [0, 7, 7, 31, 59, 12]
    res = checkout_wave(store, vids, device_out=True)
    part = res.parts[0]
    assert part.packed.is_cuda and part.event is not None
    mats = res.materialize()
    assert res.ready()
    for m, v in zip(mats, vids):
        np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    for engine_mats in (store.checkout_many(vids, engine="perpart"),
                        store.checkout_many(vids, use_kernel=False)):
        for m, v in zip(engine_mats, vids):
            np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])


def test_cuda_server_stream_matches_numpy(cuda_device):
    store, w = _store(cuda_device, seed=1)
    srv = BatchedCheckoutServer(store)
    srv.warmup()
    rng = np.random.default_rng(1)
    before = cb.LAUNCHES
    for _ in range(4):
        vids = rng.choice(w.n_versions, 12).tolist()
        for m, v in zip(srv.serve(vids), vids):
            np.testing.assert_array_equal(m, w.data[w.graph.rlist(v)])
    srv.close()
    assert cb.LAUNCHES - before == 4
    assert peek_superblock(store).uploads == 1
    assert srv.stats.degraded_waves == 0
    assert int(store._inflight_waves) == 0


def test_cuda_ladder_raises_instead_of_serving_on_the_cpu(cuda_device,
                                                          monkeypatch):
    """With a RetryPolicy, a kernel that fails to launch on every attempt
    makes the wave fail and re-queue: the ladder has no host rung on the
    card, so nothing is served by the CPU's numpy gather."""
    store, w = _store(cuda_device, seed=2)
    srv = BatchedCheckoutServer(
        store, retry=RetryPolicy(attempts=2, sleep=lambda s: None))
    srv.warmup()
    vids = [0, 7, 31, 59]
    tickets = srv.submit_many(vids)
    with monkeypatch.context() as m:
        m.setattr(cb, "_kernel_fn", lambda: (lambda *args: 700))
        with pytest.raises(RuntimeError, match="cudaError 700"):
            srv.flush()
    st = srv.stats
    assert (st.retries, st.requeues, st.degraded_waves, st.waves) == \
        (4, 1, 0, 0)
    assert int(store._inflight_waves) == 0
    srv.flush()                               # the re-queued wave, on the card
    for t, v in zip(tickets, vids):
        np.testing.assert_array_equal(srv.result(t), w.data[w.graph.rlist(v)])
    srv.close()
    assert srv.stats.degraded_waves == 0
