"""The port's paged KV cache (``repro_torch.serve.kvcache``) on the CPU
against the JAX package's (``repro.serve.kvcache``): the reference's four
tests run on both packages with every state leaf compared after each
operation; a hypothesis property over random append/fork/release
sequences compares every leaf exactly (the pools, page tables, lengths,
refcounts and the watermark); the port updates the state's tensors in
place and returns them; where the reference's scatter would fall outside
its arrays and drop the write (the pool or a request's
``max_pages_per_seq`` exhausted) the port raises ``PlanError`` and changes
nothing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.serve import kvcache as R  # noqa: E402
from repro_torch.kernels.build import PlanError  # noqa: E402
from repro_torch.serve import kvcache as T  # noqa: E402

SHAPE = dict(n_layers=2, n_kv=2, head_dim=8, page=4, n_pages=32,
             max_pages_per_seq=8)
RCFG, TCFG = R.PagedConfig(**SHAPE), T.PagedConfig(**SHAPE)
LEAVES = ("k", "v", "table", "length", "refcnt", "watermark")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    yield
    jax.clear_caches()


def _tok(i, cfg=TCFG):
    k = np.full((cfg.n_layers, cfg.n_kv, cfg.head_dim), float(i), np.float32)
    return k, -k


class Pair:
    """One operation sequence through both packages, every state leaf
    compared after each operation."""

    def __init__(self, batch, rcfg=RCFG, tcfg=TCFG):
        self.rcfg, self.tcfg = rcfg, tcfg
        self.r = R.init_pool(rcfg, batch=batch, dtype=jnp.float32)
        self.t = T.init_pool(tcfg, batch=batch, dtype=torch.float32,
                             device="cpu")
        self.append_r = jax.jit(R.append, static_argnums=0)

    def append(self, i, req):
        k, v = _tok(i, self.tcfg)
        got = T.append(self.tcfg, self.t, (torch.from_numpy(k),
                                           torch.from_numpy(v)), req)
        assert got is self.t                         # updated in place
        self.r = self.append_r(self.rcfg, self.r,
                               (jnp.asarray(k), jnp.asarray(v)),
                               jnp.int32(req))
        self.same()

    def fork(self, src, dst):
        T.fork(self.tcfg, self.t, src, dst)
        self.r = R.fork(self.rcfg, self.r, jnp.int32(src), jnp.int32(dst))
        self.same()

    def release(self, req):
        T.release(self.tcfg, self.t, req)
        self.r = R.release(self.rcfg, self.r, jnp.int32(req))
        self.same()

    def same(self):
        for name in LEAVES:
            want = np.asarray(self.r[name])
            got = self.t[name].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert T.pool_stats(self.t) == R.pool_stats(self.r)

    def gather(self, req, layer):
        got = T.gather_kv(self.tcfg, self.t, req, layer)
        want = R.gather_kv(self.rcfg, self.r, jnp.int32(req), layer)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return got


# --------------------------------------------- the reference's four tests --
def test_append_gather_roundtrip():
    pair = Pair(batch=2)
    for i in range(10):
        pair.append(i, 0)
    k, v, mask = pair.gather(0, 1)
    assert int(mask.sum()) == 10
    np.testing.assert_allclose(k[:10, 0, 0].numpy(), np.arange(10.0))
    np.testing.assert_allclose(v[:10, 0, 0].numpy(), -np.arange(10.0))
    assert int(pair.gather(1, 0)[2].sum()) == 0      # request 1 untouched


def test_fork_is_zero_copy_then_cow():
    pair = Pair(batch=2)
    for i in range(6):   # 1.5 pages
        pair.append(i, 0)
    used_before = T.pool_stats(pair.t)["pages_in_use"]
    pair.fork(0, 1)
    assert T.pool_stats(pair.t)["pages_in_use"] == used_before
    assert T.pool_stats(pair.t)["shared_pages"] == 2
    # divergent appends: COW must copy the shared tail page
    pair.append(100, 0)
    pair.append(200, 1)
    k0, _, m0 = pair.gather(0, 0)
    k1, _, m1 = pair.gather(1, 0)
    assert int(m0.sum()) == int(m1.sum()) == 7
    assert float(k0[6, 0, 0]) == 100.0 and float(k1[6, 0, 0]) == 200.0
    assert torch.equal(k0[:6], k1[:6])                 # shared prefix
    # request 0's append copied the shared tail; request 1's then found it
    # no longer shared and wrote in place
    assert T.pool_stats(pair.t) == {"pages_in_use": 3, "watermark": 3,
                                    "shared_pages": 1}


def test_release_recycles_pages():
    pair = Pair(batch=1)
    for i in range(8):
        pair.append(i, 0)
    assert T.pool_stats(pair.t)["pages_in_use"] == 2
    pair.release(0)
    assert T.pool_stats(pair.t)["pages_in_use"] == 0
    for i in range(8):
        pair.append(50 + i, 0)
    assert T.pool_stats(pair.t)["watermark"] <= 4
    assert pair.t["table"][0, :2].tolist() == [0, 1]   # the freed pages


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 12), st.lists(st.integers(0, 99), min_size=1,
                                    max_size=8))
def test_fork_immutable_property(prefix_len, sibling_tokens):
    """After fork, the source's gathered history never changes no matter
    what the fork appends (the paper's record immutability)."""
    pair = Pair(batch=2)
    for i in range(prefix_len):
        pair.append(i, 0)
    snap = pair.gather(0, 0)[0][:prefix_len].clone()
    pair.fork(0, 1)
    for t in sibling_tokens:
        pair.append(1000 + t, 1)
    assert torch.equal(pair.gather(0, 0)[0][:prefix_len], snap)


# ------------------------------------------------ random operation streams --
# 3 requests of up to 3 pages over a pool of 7: streams run into both
# limits as often as they end inside them
SMALL = dict(n_layers=1, n_kv=1, head_dim=4, page=2, n_pages=7,
             max_pages_per_seq=3)
OPS = st.lists(st.tuples(st.sampled_from(["append"] * 6 + ["fork",
                                                           "release"]),
                         st.integers(0, 2), st.integers(0, 2)),
               min_size=20, max_size=60)


def _refused(cfg, state: dict, req: int) -> bool:
    """Whether an append to ``req`` would land outside the reference's
    arrays: its next page is past ``max_pages_per_seq``, or it needs a page
    (a new one, or a copy of a shared tail) and none is free."""
    length = int(state["length"][req])
    if length // cfg.page >= cfg.max_pages_per_seq:
        return True
    if length % cfg.page:
        page = int(state["table"][req, length // cfg.page])
        if int(state["refcnt"][page]) <= 1:
            return False
    refcnt = state["refcnt"]
    wm = int(state["watermark"])
    return wm >= cfg.n_pages and not bool((refcnt[:wm] == 0).any())


@settings(max_examples=60, deadline=None)
@given(OPS)
def test_random_streams_match_the_reference_leaf_for_leaf(ops):
    """Appends, forks (onto any slot, itself included) and releases in any
    order: every state leaf equal to the reference's after every
    operation, until an append the reference would drop, which the port
    refuses with ``PlanError``, leaving every leaf as it was."""
    cfg = T.PagedConfig(**SMALL)
    pair = Pair(batch=3, rcfg=R.PagedConfig(**SMALL), tcfg=cfg)
    for n, (op, a, b) in enumerate(ops):
        if op == "append":
            if _refused(cfg, pair.t, a):
                with pytest.raises(PlanError):
                    T.append(cfg, pair.t, tuple(map(torch.from_numpy,
                                                    _tok(n, cfg))), a)
                pair.same()          # still the state before the refusal
                return
            pair.append(n, a)
        elif op == "fork":
            pair.fork(a, b)
        else:
            pair.release(a)
    for req in range(3):
        pair.gather(req, 0)


# ----------------------------------------------------------- refusals --
def test_an_exhausted_pool_raises_and_changes_nothing():
    """Two pages in all: a third page is refused where the reference's
    scatter would drop the write (its watermark runs past the pool)."""
    shape = dict(SHAPE, n_pages=2)
    pair = Pair(batch=2, rcfg=R.PagedConfig(**shape),
                tcfg=T.PagedConfig(**shape))
    for i in range(4):
        pair.append(i, 0)
    for i in range(4):
        pair.append(10 + i, 1)
    before = {k: v.clone() for k, v in pair.t.items()}
    with pytest.raises(PlanError, match="all 2 pages in use"):
        T.append(pair.tcfg, pair.t, tuple(map(torch.from_numpy, _tok(9))), 0)
    for name, leaf in before.items():
        assert torch.equal(pair.t[name], leaf), name
    dropped = R.append(pair.rcfg, pair.r, tuple(map(jnp.asarray, _tok(9))),
                       jnp.int32(0))
    assert int(dropped["watermark"]) == 3 > pair.rcfg.n_pages
    # a release frees its pages, and the refused request then fits
    pair.release(1)
    pair.append(9, 0)


def test_a_full_request_raises_and_changes_nothing():
    """A request that holds ``max_pages_per_seq`` full pages gets no more
    tokens (the reference would drop them, its table index out of range)."""
    shape = dict(SHAPE, max_pages_per_seq=2)
    pair = Pair(batch=1, rcfg=R.PagedConfig(**shape),
                tcfg=T.PagedConfig(**shape))
    for i in range(8):
        pair.append(i, 0)
    before = {k: v.clone() for k, v in pair.t.items()}
    with pytest.raises(PlanError, match="all of its 2 pages"):
        T.append(pair.tcfg, pair.t, tuple(map(torch.from_numpy, _tok(8))), 0)
    for name, leaf in before.items():
        assert torch.equal(pair.t[name], leaf), name


def test_bf16_pool_rounds_as_the_reference_does():
    rcfg = R.PagedConfig(**SHAPE)
    r = R.init_pool(rcfg, batch=1)
    t = T.init_pool(TCFG, batch=1, device="cpu")
    assert t["k"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    for _ in range(5):
        k = rng.standard_normal((2, 2, 8)).astype(np.float32)
        r = R.append(rcfg, r, (jnp.asarray(k), jnp.asarray(2 * k)),
                     jnp.int32(0))
        T.append(TCFG, t, (torch.from_numpy(k), torch.from_numpy(2 * k)), 0)
    for name in ("k", "v"):
        np.testing.assert_array_equal(t[name].float().numpy(),
                                      np.asarray(r[name], np.float32))


def test_init_pool_goes_to_the_card_unless_the_caller_names_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_pool(TCFG, batch=1)
