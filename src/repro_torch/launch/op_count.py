"""Op-level FLOP, byte and live-memory counts of a PyTorch program: the
port's counterpart of ``src/repro/launch/hlo_count.py``.

The reference lowers a step to HLO and walks its text.  The port runs its
own step, usually on ``meta`` tensors (shape and dtype, no storage: nothing
is computed), under a ``TorchDispatchMode`` that sees every aten op:

  * FLOPs  — ``torch.utils.flop_counter``'s registry (``mm``, ``bmm``,
             ``addmm``, ``baddbmm`` and the einsums that lower to them, the
             convolutions, and their backward ops), keyed by the dtype of
             the op's first tensor operand; inside ``kernel_dtype(dt)`` (a
             model kernel's wrapper running its plain version) by ``dt``,
             the dtype the hand-written kernel runs its products in.
  * bytes  — each op's tensor operands read once (the distinct elements a
             broadcast operand spans) plus its results written once.
             Views and aliases cost nothing (``_FREE`` and every op whose
             schema is a view); an in-place op writes its target once;
             ``copy_``/``fill_``/``zero_`` do not read their target;
             a copy from the host is no device op and costs nothing.
             Nothing is fused: each op is charged on its own, as eager
             PyTorch runs it (the reference counts fused HLO).
  * casts  — ``_to_copy`` to a new dtype is charged like any op (eager
             PyTorch runs it) and also kept apart as ``cast_bytes``; the
             reference's width model makes converts free.
  * attn   — the bytes of ops inside ``attn_core`` (the counterpart of
             the reference's ``jax.named_scope("attn_core")``), which the
             roofline's flash path replaces by the kernels' I/O.
  * memory — each new storage's bytes from its first op until it is
             freed (``weakref.finalize`` on the storage): ``argument_bytes``
             (the storages reachable from the arguments), the peak of the
             rest (``temp_bytes``), ``output_bytes`` (the result's storages
             that are not the arguments') and ``peak_estimate_bytes``; the
             counterpart of ``compiled.memory_analysis()``.

  * collectives — every ``torch.distributed`` call (``c10d.*``: the
             layers' and the train step's own) and every DTensor
             redistribution (``_c10d_functional.*``), under the
             reference's five kinds by its rule (``hlo_analysis.py:60-86``):
             the bytes of the result (an all-gather the gathered tensor,
             an all-reduce the tensor, a reduce-scatter or all-to-all what
             lands), counted apart from the HBM bytes (``coll_bytes``,
             ``coll_counts``) and by process group (``coll_groups``).
             ``wait_tensor`` and ``_wrap_tensor_autograd`` are none; a
             c10d op of none of the five kinds raises, so none is dropped.
             "collective-permute" has no spelling in the port: it stays 0.
  * DTensors — an op on DTensor operands, and a DTensor argument, is
             charged at this rank's local shards (a ``TorchDispatchMode``
             sees the op at the global shape): the count is one rank's.

Eager PyTorch unrolls every layer and microbatch loop, so the reference's
while-loop trip counts (``_trip_count``) have no counterpart: each op is
counted each time it runs.  On a one-rank step there are no collectives;
on a production mesh the step runs on ``launch.mesh.counting_group``'s
ranks, whose collectives move nothing, and the count is rank 0's.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# the running count, which the scopes below read; None when none runs
_COUNTER: Optional["_Counter"] = None

# ops that move no bytes: views, aliases and allocations
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
         "t", "slice", "select", "unsqueeze", "squeeze", "as_strided",
         "detach", "alias", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided"}
# results that are an operand's storage: views and aliases
_ALIASES = {"_unsafe_view", "detach", "alias", "lift_fresh"}
# in-place ops that write their target without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_"}

# the reference's collective kinds (``hlo_analysis._COLLECTIVES``)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd")
# c10d ops (their result is their first argument) and functional ops
# (their result is returned), by the kind each is
_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
}
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


class _AttnCore:
    """``with attn_core:`` marks the ops inside as the attention chain
    (the reference's ``jax.named_scope("attn_core")``).  Two attribute
    reads when no count runs."""

    __slots__ = ()

    def __enter__(self):
        if _COUNTER is not None:
            _COUNTER.attn_depth += 1

    def __exit__(self, *exc):
        if _COUNTER is not None:
            _COUNTER.attn_depth -= 1
        return False


attn_core = _AttnCore()


class kernel_dtype:
    """``with kernel_dtype(dt):`` keys the FLOPs inside by ``dt``: a model
    kernel's wrapper runs its plain version (float32 inside) where the
    hand-written kernel runs its products in its operands' dtype."""

    __slots__ = ("dtype", "kept")

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def __enter__(self):
        if _COUNTER is not None:
            self.kept, _COUNTER.flop_dtype = _COUNTER.flop_dtype, self.dtype

    def __exit__(self, *exc):
        if _COUNTER is not None:
            _COUNTER.flop_dtype = self.kept
        return False


def replay(fn: Callable, *args):
    """``fn(*args)`` for a pure function of its operands whose results are
    fresh tensors (or None).  Under a count on ``meta``, a call on
    operands of the same shapes as an earlier one is replayed: its counts,
    its peak over the live memory it entered with and its results'
    storages, with no op run (the plain kernels and the backward passes
    loop over batch rows, key blocks and chunks).  Outside a count it is
    ``fn(*args)``."""
    if _COUNTER is None:
        return fn(*args)
    return _COUNTER.replayed(fn, args)


def plain_kernel(fn: Callable, dtype: torch.dtype, *args):
    """``replay(fn, *args)`` for a model kernel's plain version as its
    wrapper runs it on the CPU or on ``meta``, its products keyed by
    ``dtype`` under a count (``kernel_dtype``)."""
    if _COUNTER is None:
        return fn(*args)
    with kernel_dtype(dtype):
        return _COUNTER.replayed(fn, args)


@dataclasses.dataclass
class OpCost:
    """What ``analyze`` counted: FLOPs (in all and by dtype name), bytes,
    the bytes inside ``attn_core`` and of casts, the memory terms (the
    result's storages that are the arguments' are ``alias_bytes``, the
    others ``output_bytes``), the ops seen, and the collectives' result
    bytes and calls by kind and by process group."""
    flops: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    attn_bytes: float = 0.0
    cast_bytes: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0
    peak_estimate_bytes: int = 0
    n_ops: int = 0
    coll_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVE_KINDS, 0))
    # process group name -> kind -> [calls, result bytes]
    coll_groups: dict = dataclasses.field(default_factory=dict)


def _tensors(tree, out: list) -> list:
    """The tensors in ``tree`` (nested lists, tuples (a NamedTuple's
    fields too) and dicts, and a module's parameters and buffers), in
    order, appended to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(_local(tree))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    elif isinstance(tree, torch.nn.Module):
        out.extend(_local(t) for t in tree.parameters())
        out.extend(_local(t) for t in tree.buffers())
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (no op: its ``_local_tensor``), a plain
    tensor itself."""
    return t._local_tensor if _is_dtensor(t) else t


def _locals(tree):
    """``tree`` with every DTensor replaced by its local shard."""
    if isinstance(tree, torch.Tensor):
        return _local(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_locals(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _locals(x) for k, x in tree.items()}
    return tree


def _group_name(func, args) -> str:
    """The process group a collective runs on: a c10d op's
    ``ProcessGroup`` argument, a functional op's group name (its last
    string argument)."""
    if func.namespace == "c10d":
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    return torch.distributed.ProcessGroup.unbox(a).group_name
                except RuntimeError:        # a ReduceOp, not the group
                    continue
        return "?"
    names = [a for a in args if isinstance(a, str)]
    return names[-1] if names else "?"


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` spans (a broadcast dim of
    stride 0 counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _OpInfo:
    """What the count needs of one aten overload, looked up once."""

    __slots__ = ("name", "free", "alias", "mutable", "write_only", "flop",
                 "composite", "fresh")

    def __init__(self, func):
        self.name = func.overloadpacket.__name__
        view = bool(getattr(func, "is_view", False))
        self.free = self.name in _FREE or view
        self.alias = self.name in _ALIASES or view
        schema = func._schema
        self.mutable = schema.is_mutable
        self.write_only = self.mutable and self.name in _WRITE_ONLY
        self.flop = flop_registry.get(func.overloadpacket)
        self.composite = (func is not torch.ops.prim.device.default
                          and torch._C._dispatch_has_kernel_for_dispatch_key(
                              func.name(), "CompositeImplicitAutograd"))
        # every result a fresh tensor: its metadata is a function of the
        # operands' alone, so a meta run can be replayed from a memo
        self.fresh = (not self.mutable and bool(schema.returns)
                      and all(r.alias_info is None
                              and str(r.type) == "Tensor"
                              for r in schema.returns))


_PLAIN = {int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format}


def _key(x):
    """A hashable key of an op's argument for the meta memo (None where
    there is none: a tensor off ``meta``, an unhashable value)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype) if (
            x.is_meta and not _is_dtensor(x)) else None
    t = type(x)
    if t is tuple or t is list:
        parts = []
        for e in x:
            k = _key(e)
            if k is None:
                return None
            parts.append(k)
        return tuple(parts)
    if t not in _PLAIN:
        try:
            hash(x)
        except TypeError:
            return None
    return (t, x)


# aten overload -> _OpInfo, and the meta memo: (overload, operand keys) ->
# (one result or a tuple, the results' specs, bytes, flops, the first
# operand's dtype, cast); both hold for every count.  _REPLAY holds
# ``plain_kernel``'s recorded calls
_INFO: dict = {}
_MEMO: dict = {}
_REPLAY: dict = {}
_TOTALS = ("n_ops", "flops", "bytes", "attn_bytes", "cast_bytes")


class _Counter:
    def __init__(self, attribute: Optional[Callable]):
        self.cost = OpCost()
        self.attribute = attribute
        self.attn_depth = 0
        self.flop_dtype: Optional[torch.dtype] = None
        self.live: dict = {}            # storage key -> bytes, fresh ones
        self.known: set = set()         # the arguments' storages
        self.cur = 0
        self.peak = 0

    def _free(self, key) -> None:
        self.cur -= self.live.pop(key, 0)

    def track(self, storage) -> None:
        key = storage._cdata
        if key in self.known or key in self.live:
            return
        n = storage.nbytes()
        self.live[key] = n
        weakref.finalize(storage, self._free, key)
        self.cur += n
        if self.cur > self.peak:
            self.peak = self.cur

    def op_info(self, func) -> _OpInfo:
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _OpInfo(func)
        return info

    def measure(self, info: _OpInfo, args, kwargs, ins: list, out) -> tuple:
        """(bytes, flops, the first operand's dtype, cast) of one op."""
        outs = _tensors(out, [])
        if (info.name in ("_to_copy", "copy_") and outs
                and outs[0].device.type != "cpu"
                and ins[-1].device.type == "cpu"):
            return 0, 0, ins[0].dtype, False    # from the host: no HBM op
        reads = ins[1:] if info.write_only else ins
        b = sum(_span_bytes(t) for t in reads)
        if info.mutable and not outs and ins:
            b += _span_bytes(ins[0])        # the target, written once
        b += sum(_span_bytes(t) for t in outs)
        f = 0
        if info.flop is not None:
            f = info.flop(*args, **kwargs, out_val=out)
        first = ins[0].dtype if ins else None
        cast = (info.name == "_to_copy" and bool(ins) and bool(outs)
                and outs[0].dtype != first)
        return b, f, first, cast

    def add(self, info: _OpInfo, b, f, first, cast, out) -> None:
        cost = self.cost
        cost.n_ops += 1
        if info.free:
            return
        if f:
            key = _dtype_name(self.flop_dtype or first)
            cost.flops += f
            cost.flops_by_dtype[key] = cost.flops_by_dtype.get(key, 0) + f
        cost.bytes += b
        if self.attn_depth > 0:
            cost.attn_bytes += b
        if cast:
            cost.cast_bytes += b
        if self.attribute is not None:
            shape = tuple(out.shape) if isinstance(out, torch.Tensor) else (
                tuple(out[0].shape) if isinstance(out, (list, tuple)) and out
                and isinstance(out[0], torch.Tensor) else ())
            self.attribute(f"{info.name} {shape}", b, f)

    def replayed(self, fn: Callable, args: tuple):
        """``fn(*args)`` counted, or its recorded count replayed (meta
        operands only; ``plain_kernel``)."""
        key = _key(args)
        if key is None:
            return fn(*args)
        key = (fn.__module__, fn.__qualname__, key, self.flop_dtype,
               self.attn_depth > 0, self.attribute is not None)
        hit = _REPLAY.get(key)
        cost = self.cost
        if hit is None:
            before = [getattr(cost, k) for k in _TOTALS]
            by_dtype = dict(cost.flops_by_dtype)
            entry, kept_peak = self.cur, self.peak
            self.peak = self.cur
            seen: list = []
            attribute = self.attribute
            if attribute is not None:
                self.attribute = lambda *e: (seen.append(e), attribute(*e))
            try:
                out = fn(*args)
            finally:
                self.attribute = attribute
            call_peak = self.peak - entry
            self.peak = max(kept_peak, self.peak)
            single = isinstance(out, torch.Tensor)
            items = [out] if single else out
            fresh = isinstance(items, (list, tuple)) and all(
                t is None or (isinstance(t, torch.Tensor) and t.is_meta
                              and t.is_contiguous()
                              and t.untyped_storage().nbytes()
                              == t.numel() * t.element_size())
                for t in items)
            if fresh:
                _REPLAY[key] = (
                    [getattr(cost, k) - b for k, b in zip(_TOTALS, before)],
                    {k: v - by_dtype.get(k, 0)
                     for k, v in cost.flops_by_dtype.items()
                     if v != by_dtype.get(k, 0)},
                    call_peak, seen, single,
                    [None if t is None else (t.shape, t.dtype)
                     for t in items])
            return out
        totals, by_dtype, call_peak, seen, single, specs = hit
        for k, d in zip(_TOTALS, totals):
            setattr(cost, k, getattr(cost, k) + d)
        for k, d in by_dtype.items():
            cost.flops_by_dtype[k] = cost.flops_by_dtype.get(k, 0) + d
        self.peak = max(self.peak, self.cur + call_peak)
        outs = [None if spec is None else
                torch.empty(spec[0], dtype=spec[1], device="meta")
                for spec in specs]
        for t in outs:
            if t is not None:
                self.track(t.untyped_storage())
        for e in seen:
            self.attribute(*e)
        return outs[0] if single else tuple(outs)

    def collective(self, func, args, kwargs):
        """Run one collective, count its result's bytes under its kind and
        group (no HBM bytes) and return its result."""
        name = func.overloadpacket.__name__
        out = func(*args, **kwargs)
        if name in _NOT_COLLECTIVES:
            return out
        kind = _KIND.get(name)
        if kind is None:
            raise NotImplementedError(
                f"collective {func} is none of the reference's kinds "
                f"{COLLECTIVE_KINDS}: the count cannot place it")
        result = args[0] if func.namespace == "c10d" else out
        ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs),
                                                             [])}
        for t in _tensors(out, []):
            if t.untyped_storage()._cdata not in ins:
                self.track(t.untyped_storage())
        b = sum(t.numel() * t.element_size() for t in _tensors(result, []))
        cost = self.cost
        cost.n_ops += 1
        cost.coll_bytes[kind] += b
        cost.coll_counts[kind] += 1
        by_kind = cost.coll_groups.setdefault(_group_name(func, args), {})
        entry = by_kind.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += b
        return out

    def run_dtensor(self, func, info: _OpInfo, args, kwargs):
        """Run one op on DTensor operands (DTensor computes on the local
        shards, unseen by the mode) and count it at the local shards: its
        operands' and results' ``_local_tensor``s."""
        out = func(*args, **kwargs)
        if info.free or info.alias:
            self.cost.n_ops += 1
            return out
        ins = _tensors((args, kwargs), [])
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in _tensors(out, []):
            st = t.untyped_storage()
            if st._cdata not in in_keys:
                self.track(st)
        b, f, first, cast = self.measure(info, _locals(args),
                                         _locals(kwargs), ins, _locals(out))
        self.add(info, b, f, first, cast, _locals(out))
        return out

    def run(self, func, info: _OpInfo, args, kwargs):
        """Run one leaf op, count it and return its result."""
        if info.alias:                  # no bytes, no new storage
            self.cost.n_ops += 1
            return func(*args, **kwargs)
        key = None
        if info.fresh:
            key = _key((args, tuple(kwargs.items())))
            if key is not None:
                key = (func, key)
                hit = _MEMO.get(key)
                if hit is not None:
                    single, specs, b, f, first, cast = hit
                    outs = [torch.empty_strided(shape, stride, dtype=dt,
                                                device="meta")
                            for shape, stride, dt in specs]
                    for t in outs:
                        self.track(t.untyped_storage())
                    out = outs[0] if single else tuple(outs)
                    self.add(info, b, f, first, cast, out)
                    return out
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs), [])
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in _tensors(out, []):
            st = t.untyped_storage()
            if st._cdata not in in_keys:
                self.track(st)
        b, f, first, cast = self.measure(info, args, kwargs, ins, out)
        outs = _tensors(out, [])
        if key is not None and all(t.device.type == "meta" for t in outs):
            specs = [(t.shape, t.stride(), t.dtype) for t in outs]
            _MEMO[key] = (isinstance(out, torch.Tensor), specs, b, f,
                              first, cast)
        self.add(info, b, f, first, cast, out)
        return out


class _Mode(TorchDispatchMode):
    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return self.counter.collective(func, args, kwargs)
        # a composite op (``matmul``, ``einsum``, ``softmax``: under
        # ``inference_mode`` they reach the mode whole) counts as the ops
        # it runs, as it does with autograd on
        info = self.counter.op_info(func)
        if info.composite:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if any(_is_dtensor(t) for t in tree_flatten((args, kwargs))[0]):
            return self.counter.run_dtensor(func, info, args, kwargs)
        return self.counter.run(func, info, args, kwargs)


def storages_outlive_their_wrappers() -> bool:
    """True where a storage's Python object lives as long as the storage
    (PyTorch keeps it, as it keeps a tensor's), which the live-memory
    count needs."""
    t = torch.empty(1, device="meta")
    fired: list = []
    weakref.finalize(t.untyped_storage(), fired.append, 1)
    alive = not fired
    del t
    return alive and bool(fired)


def analyze(fn: Callable, *args, attribute: Optional[Callable] = None
            ) -> OpCost:
    """Run ``fn(*args)`` under the count and return its ``OpCost``.
    ``attribute(key, bytes, flops)`` is called for each op that moves
    bytes, keyed ``"<aten op> <result shape>"``, as the reference's
    ``analyze`` calls its ``attribute``."""
    global _COUNTER
    if _COUNTER is not None:
        raise RuntimeError("op_count.analyze does not nest")
    if not storages_outlive_their_wrappers():
        raise RuntimeError("this PyTorch drops a storage's Python object "
                           "before the storage: live memory cannot be "
                           "tracked")
    counter = _Counter(attribute)
    arg_storages = {}
    for t in _tensors(args, []):
        st = t.untyped_storage()
        arg_storages[st._cdata] = st.nbytes()
    counter.known = set(arg_storages)
    _COUNTER = counter
    try:
        with _Mode(counter):
            out = fn(*args)
    finally:
        _COUNTER = None
    cost = counter.cost
    cost.argument_bytes = int(sum(arg_storages.values()))
    out_storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in _tensors(out, [])}
    cost.output_bytes = int(sum(n for k, n in out_storages.items()
                                if k not in arg_storages))
    cost.alias_bytes = int(sum(n for k, n in out_storages.items()
                               if k in arg_storages))
    cost.temp_bytes = int(counter.peak)
    cost.peak_estimate_bytes = cost.argument_bytes + cost.temp_bytes
    del out
    return cost

