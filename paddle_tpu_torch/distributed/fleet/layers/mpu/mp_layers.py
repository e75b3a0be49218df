"""Tensor-parallel (model-parallel) layers (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``; ref:
python/paddle/distributed/fleet/layers/mpu/mp_layers.py:47
VocabParallelEmbedding, :334 ColumnParallelLinear, :541 RowParallelLinear,
:742 ParallelCrossEntropy, and mp_ops.py's collectives).

The reference holds the full weight on every layer and lets GSPMD partition
it (``:1-16``). The port runs one process per rank, so each rank holds its
own shard and each layer issues its collectives itself, Megatron's way: each
is a ``torch.autograd.Function`` over the port's collectives on the mp group
(:class:`_CopyToMP`: identity forward, all-reduce backward;
:class:`_ReduceFromMP`: all-reduce forward, identity backward; the
all-gather / split pairs along a dimension; and for sequence parallelism the
all-gather / reduce-scatter pair along dimension 0).

A layer built from a seed draws its full weight from the RNG tracker's
global branch (the same stream on every rank) and keeps its slice, so an
mp=2 layer holds slices of the layer built at mp=1 from the same seed. A
shard carries the reference ``Parameter``'s metadata (``is_distributed``
True, ``tp_axis`` the full tensor's dimension it was cut along), the rank's
place (``_tp_shard = (rank, degree)``, which ``utils.load_jax_params``
reads) and the flat index of its first element in a shard's numbering
(``_sr_index_base = rank * numel``: a row shard, cut along dimension 0,
then draws the stochastic-rounding bits its elements draw unsharded; a
column shard draws others, ROADMAP C2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .....base.amp_state import amp_cast
from .....nn.layer.common import tp_meta

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "mark_as_sequence_parallel_parameter"]


# -- the mp group's collectives as autograd functions -------------------------

def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    from ....communication import all_gather_into_tensor

    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= group.nranks
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    all_gather_into_tensor(out, x.contiguous(), group=group, axis=dim)
    return out


def _split(x: torch.Tensor, group, dim: int, groups: int = 1) -> torch.Tensor:
    """The rank's part of ``x`` along ``dim``; with ``groups`` > 1 that
    dimension is ``groups`` equal parts (a fused qkv's q, k and v), each
    cut on its own, and the rank's cuts are laid side by side."""
    n = group.nranks
    dim = dim % x.dim()
    if x.shape[dim] % (n * groups):
        raise ValueError(f"dimension {dim} of shape {tuple(x.shape)} does not "
                         f"divide over {n} ranks in {groups} groups")
    parts = x.unflatten(dim, (groups, -1))
    return parts.chunk(n, dim + 1)[group.rank].flatten(dim, dim + 1) \
        .contiguous()


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    from ....communication import reduce_scatter

    parts = [c.contiguous() for c in x.chunk(group.nranks, 0)]
    out = torch.empty_like(parts[0])
    reduce_scatter(out, parts, group=group)
    return out


class _CopyToMP(torch.autograd.Function):
    """Entering a column-parallel region: identity forward; the input's
    gradient all-reduced over the mp group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        from ....communication import all_reduce

        dy = dy.contiguous().clone()
        all_reduce(dy, group=ctx.group)
        return dy, None


# the last input copied into an mp region: (input, group, grad mode, copy)
_last_copy = None


def _copy_to_mp(x: torch.Tensor, group) -> torch.Tensor:
    """``_CopyToMP`` once for consecutive column layers fed one tensor
    (q/k/v, gate/up): they share the copy, so autograd sums their input
    gradients first and the copy all-reduces the sum once. The last copy
    is kept until a column layer is fed another tensor (a view of its
    input: no memory of its own)."""
    global _last_copy
    grad = torch.is_grad_enabled()
    last = _last_copy
    if last is not None and last[0] is x and last[1] is group \
            and last[2] == grad:
        return last[3]
    y = _CopyToMP.apply(x, group)
    _last_copy = (x, group, grad, y)
    return y


class _ReduceFromMP(torch.autograd.Function):
    """Leaving a row-parallel region: the partial products all-reduced
    forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        from ....communication import all_reduce

        y = x.contiguous().clone()
        all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromMP(torch.autograd.Function):
    """All-gather along ``dim`` forward; the rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _split(dy, ctx.group, ctx.dim), None, None


class _ScatterToMP(torch.autograd.Function):
    """The rank's slice along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _split(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.group, ctx.dim), None, None


class _AllGatherFromMP(torch.autograd.Function):
    """Sequence parallel: all-gather along dimension 0 forward,
    reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, 0)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.group), None


class _ReduceScatterToMP(torch.autograd.Function):
    """Sequence parallel: reduce-scatter along dimension 0 forward,
    all-gather backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.group, 0), None


# -- layers --------------------------------------------------------------------

def _resolve_group(mp_group):
    """The explicit group, else the hybrid topology's mp group, else None
    (one rank)."""
    from ...base.topology import get_hybrid_communicate_group

    if mp_group is not None:
        return mp_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _full_weight_generator(device: torch.device) -> torch.Generator:
    """The RNG tracker's global branch on ``device``: the same stream on
    every rank (a branch never added forks off the process seed)."""
    from .....base import random as R

    tracker = R.get_rng_state_tracker()
    with tracker.rng_state(tracker.GLOBAL):
        return R.get_generator(device)


def shard_parameter_(p: nn.Parameter, axis: int, group,
                     groups: int = 1) -> nn.Parameter:
    """Cut ``p`` in place to the rank's slice along ``axis`` (of each of
    its ``groups`` parts, see :func:`_split`) and set its shard metadata
    (see the module's docstring)."""
    with torch.no_grad():
        p.data = _split(p.data, group, axis, groups)
    p.is_distributed = True
    p.tp_axis = axis
    p.tp_groups = groups
    p._tp_shard = (group.rank, group.nranks)
    p._sr_index_base = group.rank * p.numel()
    return p


def mark_as_sequence_parallel_parameter(param):
    """A parameter applied on the sequence shard (a norm's weight, a row
    layer's bias): its gradient is partial on each rank and
    ``register_sequence_parallel_allreduce_hooks`` all-reduces it."""
    param.is_sequence_parallel = True


class _MpLayerBase(nn.Module):
    """Resolves the mp group and the rank's device once, at construction."""

    def _init_mp(self, mp_group, device=None):
        g = _resolve_group(mp_group)
        self.model_parallel_group = g
        self.world_size = g.nranks if g is not None else 1
        self.rank = g.rank if g is not None else 0
        self.is_mp = self.world_size > 1
        if device is None:
            from .....base.device import get_device

            device = g.device if g is not None else get_device(None)
        self._device = torch.device(device)

    def _check_divides(self, what: str, n: int):
        if self.is_mp and n % self.world_size:
            raise ValueError(f"{what} {n} must divide mp degree "
                             f"{self.world_size}")

    def _param(self, full: torch.Tensor, axis: Optional[int]) -> nn.Parameter:
        """A parameter of ``full``, cut to the rank's slice along ``axis``
        at mp > 1 (``axis`` None: replicated)."""
        p = tp_meta(nn.Parameter(full), axis)
        if self.is_mp and axis is not None:
            shard_parameter_(p, axis, self.model_parallel_group)
        return p

    def _linear_weight(self, in_features, out_features, dtype, axis):
        limit = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features, device=self._device,
                        dtype=dtype)
        w.uniform_(-limit, limit, generator=_full_weight_generator(self._device))
        return self._param(w, axis)

    @classmethod
    def _from_dense(cls, dense: nn.Module, group, **attrs):
        """This layer over a dense layer's own parameters, cut in place
        (``TensorParallel``'s conversion: the parameter objects, their
        names and any optimizer holding them stay)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._init_mp(group, dense.weight.device)
        for k, v in attrs.items():
            setattr(self, k, v)
        return self


class VocabParallelEmbedding(_MpLayerBase):
    """Embedding with the vocabulary sharded over mp (weight ``[V/mp, h]``):
    a masked local lookup, then an all-reduce (ref: mp_layers.py:47)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._init_mp(mp_group, device)
        self._check_divides("vocab size", num_embeddings)
        w = torch.empty(num_embeddings, embedding_dim, device=self._device,
                        dtype=dtype)
        w.normal_(0.0, 1.0, generator=_full_weight_generator(self._device))
        self.weight = self._param(w, 0)

    def forward(self, x):
        w = amp_cast("embedding", self.weight)
        ids = x.long()
        if not self.is_mp:
            return w[ids]
        per = w.shape[0]
        start = self.rank * per
        outside = (ids < start) | (ids >= start + per)
        local = torch.where(outside, torch.zeros_like(ids), ids - start)
        out = w[local].masked_fill(outside.unsqueeze(-1), 0.0)
        return _ReduceFromMP.apply(out, self.model_parallel_group)


class _HiddenParallelEmbedding(_MpLayerBase):
    """An embedding sharded along the hidden dimension (weight ``[V,
    h/mp]``, ``tp_axis`` 1: the reference Llama's hint): the local lookup,
    then an all-gather along the hidden dimension (backward: the rank's
    slice). ``TensorParallel`` makes it from a dense ``Embedding``."""

    def forward(self, x):
        out = amp_cast("embedding", self.weight)[x.long()]
        if not self.is_mp:
            return out
        return _GatherFromMP.apply(out, self.model_parallel_group, -1)


class ColumnParallelLinear(_MpLayerBase):
    """Linear with ``out_features`` sharded over mp (weight ``[in,
    out/mp]``, ref: mp_layers.py:334). The input enters through
    :class:`_CopyToMP` (its gradient all-reduced), one copy for all the
    column layers fed the same tensor (:func:`_copy_to_mp`);
    ``gather_output=True`` all-gathers the output along its last
    dimension, ``False`` leaves it sharded (the input of a
    :class:`RowParallelLinear`)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._init_mp(mp_group, device)
        self._check_divides("out_features", out_features)
        self.gather_output = gather_output
        self.weight = self._linear_weight(in_features, out_features, dtype, 1)
        self.bias = None
        if has_bias:  # the reference treats None as falsy (mp_layers.py:386)
            self.bias = self._param(torch.zeros(out_features,
                                                device=self._device,
                                                dtype=dtype), 0)

    def forward(self, x):
        g = self.model_parallel_group
        if self.is_mp:
            x = _copy_to_mp(x, g)
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        if self.is_mp and self.gather_output:
            y = _GatherFromMP.apply(y, g, -1)
        return y


class RowParallelLinear(_MpLayerBase):
    """Linear with ``in_features`` sharded over mp (weight ``[in/mp,
    out]``, ref: mp_layers.py:541). ``input_is_parallel=False`` first takes
    the rank's slice of the input's last dimension. The partial products
    are all-reduced (:class:`_ReduceFromMP`), then the bias, replicated, is
    added once."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
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

    def forward(self, x):
        if self.is_mp and not self.input_is_parallel:
            x = _ScatterToMP.apply(x, self.model_parallel_group, -1)
        x, w, b = amp_cast("linear", x, self.weight, self.bias)
        y = torch.matmul(x, w)
        if self.is_mp:
            y = _ReduceFromMP.apply(y, self.model_parallel_group)
        return y if b is None else y + b


class _ParallelCE(torch.autograd.Function):
    """Softmax cross entropy over vocab-sharded logits, never gathering
    them: the local max, all-reduced (max); the local sum of ``exp``,
    all-reduced; the target logit from the rank that owns it, all-reduced.
    Backward: the local softmax minus the one-hot, no collective."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        from ....collective import ReduceOp
        from ....communication import all_reduce

        x = logits.float()
        per = x.shape[-1]
        start = group.rank * per
        gmax = x.max(dim=-1).values
        all_reduce(gmax, op=ReduceOp.MAX, group=group)
        x = x - gmax.unsqueeze(-1)
        e = torch.exp(x)
        total = e.sum(dim=-1)
        all_reduce(total, group=group)
        ids = label.long()
        if ids.dim() == x.dim():  # a trailing singleton label dimension
            ids = ids.squeeze(-1)
        valid = ids != ignore_index
        mine = valid & (ids >= start) & (ids < start + per)
        local = torch.where(mine, ids - start, torch.zeros_like(ids))
        picked = x.gather(-1, local.unsqueeze(-1)).squeeze(-1)
        picked = torch.where(mine, picked, torch.zeros_like(picked))
        all_reduce(picked, group=group)
        loss = torch.log(total) - picked
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        ctx.save_for_backward(e, total, local, mine, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, dloss):
        e, total, local, mine, valid = ctx.saved_tensors
        grad = e / total.unsqueeze(-1)
        grad.scatter_add_(-1, local.unsqueeze(-1),
                          -mine.to(grad.dtype).unsqueeze(-1))
        scale = torch.where(valid, dloss.float(), torch.zeros_like(dloss.float()))
        return (grad * scale.unsqueeze(-1)).to(ctx.dtype), None, None, None


class ParallelCrossEntropy(_MpLayerBase):
    """Per-token softmax cross entropy (``reduction="none"``) over logits
    sharded on the vocabulary (ref: mp_layers.py:742); at mp=1 the plain
    ``F.cross_entropy``. At the flagship the full logits would be ``[4,
    2048, 32000]``, 524 MB in bf16: they are never gathered."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        g = _resolve_group(mp_group)
        self.model_parallel_group = g
        self.world_size = g.nranks if g is not None else 1
        self.is_mp = self.world_size > 1
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        if not self.is_mp:
            from .....nn import functional as F

            return F.cross_entropy(input, label, reduction="none",
                                   ignore_index=self.ignore_index)
        logits = amp_cast("cross_entropy", input)
        return _ParallelCE.apply(logits, label, self.model_parallel_group,
                                 self.ignore_index)
