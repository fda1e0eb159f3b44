"""The port's bitmap analytics held against the JAX package:
``build_bitmap``, ``membership_scan`` and ``version_aggregate`` — the plain
torch versions against the Pallas kernels in interpret mode and the
oracles, and the ``ops`` wrappers against the reference's, with the JAX
padding rules — on the same numpy inputs, ``device="cpu"``.

Tolerances: masks, counts and sums of small integers (below 2^24, so every
partial sum is exact in float32) are compared exactly.  Float sums agree
within rtol 1e-5: the plain version and the Pallas kernel add the same
float32 terms in another order."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as rops
import repro_torch.kernels.ops as ops
import repro_torch.kernels.version_agg as va
import repro_torch.kernels.vlist_membership as vm
from repro.core import generate
from repro.core import query as rquery
from repro.kernels import ref as rref
from repro_torch.core import query as tquery
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import PlanError

rvm = importlib.import_module("repro.kernels.vlist_membership")
rva = importlib.import_module("repro.kernels.version_agg")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_traces():
    """The reference kernels' Pallas traces are cached process-wide; drop
    them when this module ends, so that a later test file in the same
    process that counts fresh traces of a kernel starts cold."""
    yield
    jax.clear_caches()


def _rlists(r, n_versions, seed):
    """Random versions over R records, with an empty version, a full last
    version and (where there is one) version 31 — bit 31 of word 0 — on
    every 5th record."""
    rng = np.random.default_rng(seed)
    rls = [np.sort(rng.choice(r, int(rng.integers(1, r)), replace=False))
           for _ in range(n_versions)]
    rls[min(2, n_versions - 1)] = np.zeros(0, np.int64)
    if n_versions > 31:
        rls[31] = np.arange(0, r, 5)
    rls[-1] = np.arange(r)
    return rls


# (R, n_versions, block_r): R not a multiple of BR, R below BR, n_versions
# not a multiple of 32, vids in the last word
SHAPES = [(256, 33, 64), (1000, 70, 256), (513, 100, 128), (5, 40, 1024),
          (777, 32, 128), (300, 1, 1024)]


@pytest.mark.parametrize("r,n_versions,block_r", SHAPES)
def test_build_bitmap_matches_reference(r, n_versions, block_r):
    rls = _rlists(r, n_versions, r)
    got = ops.build_bitmap(rls, r)
    want = rops.build_bitmap(rls, r)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def _vids(n_versions):
    return sorted({0, min(2, n_versions - 1), min(31, n_versions - 1),
                   n_versions - 1, max(0, n_versions - 33)})


def _in_layout(bm, layout):
    """The numpy bitmap as an int32 CPU tensor, row-major or as its
    ``word_major`` view."""
    words = torch.from_numpy(bm.view(np.int32))
    return words if layout == "row_major" else vm.word_major(words)


@pytest.mark.parametrize("layout", ["row_major", "word_major"])
@pytest.mark.parametrize("r,n_versions,block_r", SHAPES)
def test_membership_scan_matches_reference(r, n_versions, block_r, layout):
    """Both layouts the kernel reads give the reference's masks and counts
    bit for bit: the ``ops`` wrapper against the reference's, the plain
    version against the Pallas kernel in interpret mode, the oracles."""
    rls = _rlists(r, n_versions, r + 1)
    bm = ops.build_bitmap(rls, r)
    words = _in_layout(bm, layout)
    br = min(block_r, max(8, r))
    padded = np.pad(bm, ((0, (-r) % br), (0, 0)))
    for vid in _vids(n_versions):
        mask, cnt = ops.membership_scan(words, vid, block_r=block_r,
                                        device="cpu")
        rmask, rcnt = rops.membership_scan(bm, vid=vid, block_r=block_r)
        assert mask.dtype == cnt.dtype == torch.int32
        np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
        # kernel level: the plain version on the unpadded bitmap against
        # the Pallas kernel in interpret mode on the padded one
        kmask, kcnt = rvm.membership_scan(jnp.asarray(padded), vid=vid,
                                          block_r=br, interpret=True)
        pmask, pcnt = vm.membership_scan_plain(words, vid, block_r=br)
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(kmask)[:r])
        np.testing.assert_array_equal(pcnt.numpy(), np.asarray(kcnt))
        omask, ocnt = tref.membership_scan_ref(torch.from_numpy(padded),
                                               vid, br)
        rmask, rcnt = rref.membership_scan_ref(jnp.asarray(padded), vid, br)
        np.testing.assert_array_equal(omask.numpy(), np.asarray(rmask))
        np.testing.assert_array_equal(ocnt.numpy(), np.asarray(rcnt))
        expect = np.zeros(r, np.int32)
        expect[rls[vid]] = 1
        np.testing.assert_array_equal(mask.numpy(), expect)
        assert int(cnt.sum()) == len(rls[vid])


@pytest.mark.parametrize("r,n_versions,block_r", SHAPES)
def test_word_major_is_a_strided_copy(r, n_versions, block_r):
    """``word_major`` is equal to the row-major tensor, has strides (1, Rp)
    with Rp a multiple of 4 at least R, owns fresh storage, and is the
    layout ``layout`` calls word-major; ``ops.word_major`` is the same
    function."""
    bm = ops.build_bitmap(_rlists(r, n_versions, r + 3), r)
    words = torch.from_numpy(bm.view(np.int32))
    wm = ops.word_major(words)
    assert ops.word_major is vm.word_major
    assert wm.dtype == torch.int32 and torch.equal(wm, words)
    rp = wm.stride(1)
    assert wm.stride(0) == 1 and rp % 4 == 0 and r <= rp < r + 4
    assert wm.untyped_storage().data_ptr() != \
        words.untyped_storage().data_ptr()
    assert vm.layout(wm) == (1, rp) and vm.layout(words) == (bm.shape[1], 1)
    # a uint32 tensor goes through as_words, and a word-major view is
    # copied again into a fresh one
    again = vm.word_major(torch.from_numpy(bm))
    assert torch.equal(vm.word_major(wm), words) and torch.equal(again, wm)


def test_bitmap_layouts_the_kernels_refuse():
    """A bitmap tensor in neither layout (every other word of a wider
    bitmap, a transposed view with gaps between rows) raises PlanError
    naming ``word_major`` in ``membership_scan`` and its counted launch
    (before any CUDA call); ``version_aggregate`` refuses the word-major
    view on both devices, as its launch does."""
    bm = ops.build_bitmap(_rlists(50, 70, 0), 50)        # W = 3
    words = torch.from_numpy(bm.view(np.int32))
    wide = torch.from_numpy(ops.build_bitmap(_rlists(50, 192, 1), 50)
                            .view(np.int32))
    odd = (wide[:, ::2],                                 # strides (6, 2)
           torch.as_strided(words.clone(), (25, 3), (1, 20)),   # overlap
           wide[::2, :3])                                # fine: row-major
    for bad in odd[:2]:
        with pytest.raises(PlanError, match="word_major"):
            vm.membership_scan(bad, 1)
        with pytest.raises(PlanError, match="word_major"):
            vm._launch(bad, 1, 1024)
    assert vm.layout(odd[2]) == (12, 1)
    mask, _ = vm.membership_scan(odd[2], 33)
    assert torch.equal(mask, vm.membership_scan_plain(odd[2], 33)[0])
    wm = vm.word_major(words)
    values = torch.ones(50)
    with pytest.raises(PlanError, match="word_major view"):
        va.version_aggregate(wm, values)
    with pytest.raises(PlanError, match="word_major view"):
        ops.version_aggregate(wm, np.ones(50), device="cpu")
    with pytest.raises(PlanError, match="word_major view"):
        va._launch(wm, values, 1024)
    with pytest.raises(PlanError, match="non-contiguous"):
        va.version_aggregate(wide[:, ::2], values)


@pytest.mark.parametrize("r,n_versions,block_r", SHAPES)
def test_version_aggregate_matches_reference(r, n_versions, block_r):
    rls = _rlists(r, n_versions, r + 2)
    bm = ops.build_bitmap(rls, r)
    rng = np.random.default_rng(r)
    ones = np.ones(r, np.float32)
    ints = rng.integers(0, 1000, r).astype(np.float32)
    floats = rng.random(r).astype(np.float32)
    br = min(block_r, max(8, r))
    padded = np.pad(bm, ((0, (-r) % br), (0, 0)))
    for values, exact in ((ones, True), (ints, True), (floats, False)):
        got = ops.version_aggregate(bm, values, block_r=block_r,
                                    device="cpu").numpy()
        want = np.asarray(rops.version_aggregate(bm, values,
                                                 block_r=block_r))
        kern = np.asarray(rva.version_aggregate(
            jnp.asarray(padded), jnp.asarray(np.pad(values, (0, (-r) % br))),
            block_r=br, interpret=True))
        oracle = tref.version_aggregate_ref(torch.from_numpy(bm),
                                            torch.from_numpy(values)).numpy()
        roracle = np.asarray(rref.version_aggregate_ref(jnp.asarray(bm),
                                                        jnp.asarray(values)))
        assert got.dtype == np.float32 and got.shape == want.shape == \
            (32 * bm.shape[1],)
        for other in (want, kern, oracle, roracle):
            if exact:
                np.testing.assert_array_equal(got, other)
            else:
                np.testing.assert_allclose(got, other, rtol=1e-5, atol=1e-6)
        if exact:
            sums = [values[rl].sum() for rl in rls]
            np.testing.assert_array_equal(got[:n_versions], sums)
            assert not got[n_versions:].any()


def test_analytics_match_the_query_layer():
    """The bitmap route and the numpy CSR route of ``per_version_aggregate``
    (in the port and in the reference) give the same counts and sums of a
    SCI workload's integer columns."""
    w = generate("SCI", n_versions=40, inserts=60, n_branches=5, n_attrs=12,
                 seed=0)
    bm = ops.build_bitmap(w.graph.rlists(), w.n_records)
    n = w.n_versions

    def big(d):
        return d[:, 2] > 500

    counts = ops.version_aggregate(bm, big(w.data).astype(np.float32),
                                   device="cpu").numpy()[:n]
    sums = ops.version_aggregate(bm, w.data[:, 3].astype(np.float32),
                                 device="cpu").numpy()[:n]
    sizes = ops.version_aggregate(bm, np.ones(w.n_records),
                                  device="cpu").numpy()[:n]
    for q in (tquery, rquery):
        np.testing.assert_array_equal(
            counts, q.per_version_aggregate(w.graph, w.data, 2, "count",
                                            predicate=big))
        np.testing.assert_array_equal(
            sums, q.per_version_aggregate(w.graph, w.data, 3, "sum"))
    np.testing.assert_array_equal(sizes, w.graph.version_sizes())


def test_empty_bitmap_where_the_reference_raises():
    """No records: the reference's wrappers divide by a zero block
    (ZeroDivisionError); the port returns an empty mask and counts and
    all-zero sums (ROADMAP §C)."""
    empty = np.zeros((0, 2), np.uint32)
    with pytest.raises(ZeroDivisionError):
        rops.membership_scan(empty, vid=3)
    with pytest.raises(ZeroDivisionError):
        rops.version_aggregate(empty, np.zeros(0, np.float32))
    mask, cnt = ops.membership_scan(empty, 63, device="cpu")
    assert mask.shape == cnt.shape == (0,)
    out = ops.version_aggregate(empty, np.zeros(0), device="cpu")
    assert out.shape == (64,) and not out.any()


def test_bad_vids_and_operands_raise_plan_error():
    """A vid outside the bitmap's 32·W bits is refused on the host: the
    reference answers it from a clamped word (ROADMAP §C), and a CUDA
    kernel would read past the row."""
    bm = ops.build_bitmap(_rlists(50, 40, 0), 50)      # W = 2
    for vid in (-1, 64, 1000):
        mask, _ = rops.membership_scan(bm, vid=vid)
        assert np.asarray(mask).shape == (50,)
        with pytest.raises(PlanError, match="outside"):
            ops.membership_scan(bm, vid, device="cpu")
    words = ops.as_bitmap(bm, "cpu")
    with pytest.raises(PlanError, match="values"):
        va.version_aggregate(words, torch.ones(49))
    with pytest.raises(PlanError, match="uint32"):
        ops.membership_scan(bm.astype(np.int64), 0, device="cpu")
    with pytest.raises(PlanError, match="uint32 or int32"):
        vm.membership_scan(words.to(torch.int64), 0)
    # a uint32 tensor is viewed, not copied
    u32 = torch.from_numpy(bm)
    assert vm.as_words(u32).data_ptr() == u32.data_ptr()


def test_bitmap_analytics_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bm = ops.build_bitmap(_rlists(50, 40, 0), 50)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.membership_scan(bm, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.version_aggregate(bm, np.ones(50))


def test_bitmap_constants_match_reference():
    assert vm.DEFAULT_BR == rvm.DEFAULT_BR and va.DEFAULT_BR == rva.DEFAULT_BR


def _bf16_exact(x):
    """Every entry of float32 ``x`` is exactly a bf16 (low 16 bits clear)."""
    return bool(((x.view(torch.int32) & 0xFFFF) == 0).all())


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_bf16x3_is_exact(sign):
    """The CUDA kernel's value split (``split_bf16x3``): hi + mid + lo ==
    v bit for bit over seeded float32 across the exponent range down to
    2^-102 and at FLT_MAX, each part exactly a bf16."""
    rng = np.random.default_rng(7)
    mant = rng.integers(0, 1 << 23, 20000)
    exps = rng.integers(-102, 128, 20000)
    v = np.ldexp(1.0 + mant / float(1 << 23), exps).astype(np.float32)
    v = np.concatenate([v, [np.finfo(np.float32).max, 2.0 ** -102,
                            np.float32(1 + 2 ** -23), 1.0]]).astype(np.float32)
    v = torch.from_numpy(sign * v)
    hi, mid, lo = va.split_bf16x3(v)
    for part in (hi, mid, lo):
        assert part.dtype == torch.float32 and _bf16_exact(part)
        assert torch.equal(part.to(torch.bfloat16).to(torch.float32), part)
    assert torch.equal((hi + mid) + lo, v)
    exact = hi.double() + mid.double() + lo.double()
    assert torch.equal(exact, v.double())
    assert torch.isfinite(hi).all()            # no overflow at FLT_MAX
    # each part carries the sign of v (or is zero)
    assert ((hi * sign >= 0) & (mid * sign >= 0) & (lo * sign >= 0)).all()


def test_split_bf16x3_integers_and_non_finite():
    """Integers below 2^24 split into integers; inf and NaN split as
    (v, 0, 0), a NaN as the canonical bf16 NaN."""
    rng = np.random.default_rng(8)
    ints = np.concatenate([rng.integers(-(1 << 24) + 1, 1 << 24, 5000),
                           [0, 1, 255, 256, 65535, (1 << 24) - 1]])
    v = torch.from_numpy(ints.astype(np.float32))
    parts = va.split_bf16x3(v)
    for part in parts:
        assert torch.equal(part, part.round())
    assert torch.equal((parts[0] + parts[1]) + parts[2], v)
    payload = np.array([0x7F800001, 0xFFC00000], np.uint32).view(np.float32)
    odd = torch.from_numpy(np.concatenate([
        np.array([np.inf, -np.inf, np.nan], np.float32), payload]))
    hi, mid, lo = va.split_bf16x3(odd)
    assert not mid.any() and not lo.any()
    assert hi[:2].tolist() == [np.inf, -np.inf]
    assert torch.isnan(hi[2:]).all() and _bf16_exact(hi)
