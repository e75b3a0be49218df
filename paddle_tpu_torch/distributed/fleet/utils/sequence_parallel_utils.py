"""Megatron-style sequence parallelism over the mp group (counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``; ref:
python/paddle/distributed/fleet/utils/sequence_parallel_utils.py ScatterOp
:85, GatherOp :97, AllGatherOp :111, ReduceScatterOp :127,
ColumnSequenceParallelLinear :427, RowSequenceParallelLinear :562).

Activations are ``[s, b, h]``, sharded on dimension 0 (``:15-16``). The
reference moves them between layouts with GSPMD constraints; the port, one
process per rank, runs the collectives: :class:`ScatterOp` splits forward
and all-gathers backward, :class:`GatherOp` the reverse,
:class:`AllGatherOp` all-gathers forward and reduce-scatters backward,
:class:`ReduceScatterOp` the reverse. A rank sees only its share of the
sequence, so the gradient of a parameter applied on the shard (marked by
``mark_as_sequence_parallel_parameter``) is partial on each rank:
:func:`register_sequence_parallel_allreduce_hooks` all-reduces it over mp,
where the reference's registration is a no-op under GSPMD (``:96-100``;
ROADMAP C2).
"""
from __future__ import annotations

import torch

from ...collective import Group
from ..layers.mpu.mp_layers import (_AllGatherFromMP, _GatherFromMP,
                                    _MpLayerBase, _ReduceScatterToMP,
                                    _ScatterToMP, _resolve_group,
                                    mark_as_sequence_parallel_parameter)
from ....base.amp_state import amp_cast

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "scatter", "all_gather", "reduce_scatter",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]


def _group(group) -> Group:
    g = _resolve_group(group)
    if g is None:
        raise RuntimeError("sequence parallelism needs an mp group: call "
                           "fleet.init() with mp_degree > 1 or pass group=")
    return g


class ScatterOp:
    """Replicated -> sequence-sharded: split forward, all-gather backward."""

    @staticmethod
    def apply(input, group=None):  # noqa: A002
        return _ScatterToMP.apply(input, _group(group), 0)


class GatherOp:
    """Sequence-sharded -> replicated: all-gather forward, split backward."""

    @staticmethod
    def apply(input, group=None):  # noqa: A002
        return _GatherFromMP.apply(input, _group(group), 0)


class AllGatherOp:
    """All-gather forward, reduce-scatter backward (ref :111)."""

    @staticmethod
    def apply(input, group=None):  # noqa: A002
        return _AllGatherFromMP.apply(input, _group(group))


class ReduceScatterOp:
    """Reduce-scatter forward, all-gather backward (ref :127)."""

    @staticmethod
    def apply(input, group=None):  # noqa: A002
        return _ReduceScatterToMP.apply(input, _group(group))


def scatter(input, group=None):  # noqa: A002
    return ScatterOp.apply(input, group)


def all_gather(input, group=None):  # noqa: A002
    return AllGatherOp.apply(input, group)


def reduce_scatter(input, group=None):  # noqa: A002
    return ReduceScatterOp.apply(input, group)


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False):
    """ref :192: after every ``accumulation_steps``-th backward, each
    sequence-parallel parameter's gradient is all-reduced (summed) over the
    mp group, so every rank holds the whole sequence's gradient. Returns
    the hooks' handles. ``fuse`` is accepted for parity (each gradient is
    reduced on its own)."""
    from ...communication import all_reduce

    params = [p for p in model.parameters()
              if getattr(p, "is_sequence_parallel", False) and p.requires_grad]
    if not params:
        return []
    g = _group(None)
    seen = {}

    def hook(p):
        seen[p] = seen.get(p, 0) + 1
        if seen[p] % accumulation_steps == 0:
            all_reduce(p.grad, group=g)

    return [p.register_post_accumulate_grad_hook(hook) for p in params]


class ColumnSequenceParallelLinear(_MpLayerBase):
    """ref :427: the sequence-sharded input all-gathered (backward:
    reduce-scatter), then the column-parallel product, its output sharded
    on the features (``gather_output=True`` all-gathers them)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._init_mp(mp_group, device)
        self._check_divides("out_features", out_features)
        self.gather_output = gather_output
        self.weight = self._linear_weight(in_features, out_features, dtype, 1)
        self.bias = None
        if has_bias:  # the reference treats None as falsy (:433)
            self.bias = self._param(torch.zeros(out_features,
                                                device=self._device,
                                                dtype=dtype), 0)

    def forward(self, x):
        g = self.model_parallel_group
        if self.is_mp:
            x = _AllGatherFromMP.apply(x, g)
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        if self.is_mp and self.gather_output:
            y = _GatherFromMP.apply(y, g, -1)
        return y


class RowSequenceParallelLinear(_MpLayerBase):
    """ref :562: the feature-sharded input (``input_is_parallel=False``
    takes the rank's slice first), the row-parallel product, then a
    reduce-scatter onto the sequence dimension (backward: all-gather). The
    bias is replicated and added on the sequence shard, so it is marked
    sequence-parallel."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self._init_mp(mp_group, device)
        self._check_divides("in_features", in_features)
        self.input_is_parallel = input_is_parallel
        self.weight = self._linear_weight(in_features, out_features, dtype, 0)
        self.bias = None
        if has_bias:
            self.bias = self._param(torch.zeros(out_features,
                                                device=self._device,
                                                dtype=dtype), None)
            if self.is_mp:
                mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        g = self.model_parallel_group
        if self.is_mp and not self.input_is_parallel:
            x = _ScatterToMP.apply(x, g, -1)
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = torch.matmul(x, w)
        if self.is_mp:
            y = _ReduceScatterToMP.apply(y, g)
        return y if b is None else y + b
