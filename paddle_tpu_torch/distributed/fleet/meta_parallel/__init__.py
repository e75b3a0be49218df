"""Meta-parallel model wrappers, the tensor-parallel half (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/__init__.py``; ref:
python/paddle/distributed/fleet/meta_parallel/tensor_parallel.py).

The reference places every parameter on the hybrid mesh, sharded on its
``tp_axis`` where the mp degree divides it (``place_parameters_on_mesh``,
``:63-83``), and GSPMD inserts the collectives. The port runs one process
per rank: :func:`place_parameters` cuts each such parameter to the rank's
slice and puts the layer that owns it behind its Megatron counterpart (a
``Linear`` with ``tp_axis`` 1 becomes a column-parallel layer whose output
stays sharded, one with ``tp_axis`` 0 a row-parallel layer taking a sharded
input, an ``Embedding`` with ``tp_axis`` 0 a vocab-parallel one, with
``tp_axis`` 1 one sharded on the hidden dimension whose output is
all-gathered); the rest is replicated. A parameter with a ``tp_unit``
(an attention projection's head width) is cut only into whole units, and
one the degree cannot cut so raises; a fused projection with
``tp_groups`` parts (GPT's and BERT's qkv: q, k and v side by side) is cut
in each part, so a rank keeps the same heads of q, k and v, bias alike.
The parameter objects and their names stay, and fleet knows no model: a
model reads its shards off its parameters' shapes (the local head counts
of the Llama, GPT and BERT) and its head's layer
(the vocab-sharded loss). :class:`TensorParallel` broadcasts what is
replicated and, with dp > 1, averages the gradients over the dp group
through ``DataParallel``.

:class:`SegmentParallel` broadcasts the parameters over the sep group (the
model splits only its attention's sequence, through
``ops.ring_attention.sep_parallel_attention``, and computes the rest on
every sep rank) and, with dp > 1, averages the gradients over the dp group
through ``DataParallel``. The pipeline (``PipelineLayer``,
``PipelineParallel``, ``LayerDesc``, ``SharedLayerDesc``) is in
``pipeline_parallel``, MoE with expert parallelism (``MoELayer``,
``TopKGate``, ``ExpertMLP``, ``place_experts_on_mesh``) in ``moe``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers.mpu.mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
    _HiddenParallelEmbedding,
    shard_parameter_,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "TensorParallel", "SegmentParallel", "place_parameters",
           "LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel", "ExpertMLP", "MoELayer", "TopKGate",
           "place_experts_on_mesh", "ClipGradForMOEByGlobalNorm"]


class _MetaParallelBase:
    """Common wrapper plumbing (ref: meta_parallel_base.py)."""

    def __init__(self, layers, hcg, strategy=None):
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    __call__ = forward

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)


def _tp_layer(module: nn.Module, group):
    """The tensor-parallel counterpart of a dense ``Linear`` or
    ``Embedding`` by its weight's ``tp_axis``, over its own parameters cut
    in place; None where it has no hint or the degree does not divide."""
    from ....nn import Embedding, Linear

    w = getattr(module, "weight", None)
    axis = getattr(w, "tp_axis", None)
    groups = getattr(w, "tp_groups", 1)
    if axis is None or w.shape[axis] % (group.nranks * groups):
        return None
    if isinstance(module, Linear):
        if axis == 1:
            layer = ColumnParallelLinear._from_dense(
                module, group, gather_output=False)
            if module.bias is not None:
                shard_parameter_(module.bias, 0, group, groups)
        else:
            layer = RowParallelLinear._from_dense(
                module, group, input_is_parallel=True)
        shard_parameter_(w, axis, group, groups)
        layer.weight, layer.bias = w, module.bias
        return layer
    if isinstance(module, Embedding):
        cls = VocabParallelEmbedding if axis == 0 else _HiddenParallelEmbedding
        layer = cls._from_dense(module, group)
        shard_parameter_(w, axis, group)
        layer.weight = w
        return layer
    return None


def check_whole_units(layers: nn.Module, degree: int) -> None:
    """Raise where the mp ``degree`` cannot cut a parameter with a
    ``tp_unit`` into whole units along its ``tp_axis`` (each rank keeps
    whole heads; the reference's GSPMD can split inside one, ROADMAP C2).
    A fused projection (``tp_groups`` parts, a qkv's q, k and v) is cut
    in each part, so the degree must divide each part's units."""
    for name, p in layers.named_parameters():
        unit = getattr(p, "tp_unit", None)
        if unit is None or p.tp_axis is None or \
                getattr(p, "is_distributed", False):
            continue
        groups = getattr(p, "tp_groups", 1)
        n = p.shape[p.tp_axis] // (unit * groups)
        if n % degree:
            per = f" in each of its {groups} parts" if groups > 1 else ""
            raise ValueError(
                f"tensor parallelism at mp degree {degree}: {name} holds "
                f"{n} units of {unit}{per} along its tp_axis {p.tp_axis} "
                "(heads in an attention projection); the degree must divide "
                "them, as each rank keeps whole units")


def place_parameters(layers: nn.Module, mp_group) -> nn.Module:
    """The counterpart of the reference's ``place_parameters_on_mesh``: each
    ``Linear``/``Embedding`` whose weight has a ``tp_axis`` the mp degree
    divides becomes its tensor-parallel layer over the rank's slice (see
    the module's docstring); every other parameter is replicated as it
    is. Returns ``layers``, changed in place."""
    if mp_group is None or mp_group.nranks <= 1:
        return layers
    check_whole_units(layers, mp_group.nranks)
    swaps = [(parent, name, child) for parent in layers.modules()
             for name, child in parent.named_children()]
    for parent, name, child in swaps:
        w = getattr(child, "weight", None)
        if getattr(w, "is_distributed", False):
            continue  # a tensor-parallel layer already
        layer = _tp_layer(child, mp_group)
        if layer is not None:
            setattr(parent, name, layer)
    return layers


class TensorParallel(_MetaParallelBase):
    """ref: meta_parallel/tensor_parallel.py: shard every parameter on its
    ``tp_axis`` (:func:`place_parameters`) and replicate the rest, then
    broadcast the replicated parameters over the mp group from its first
    rank. With dp > 1 the layers are also wrapped in ``DataParallel`` over
    the dp group (its ``_dp``): every parameter broadcast from the group's
    first rank, the gradients averaged at the end of each backward.

    On the port's Llama (q/k/v and gate/up ``tp_axis`` 1, o and down 0, the
    embedding and the untied head 1): each attention keeps ``num_heads /
    mp`` local heads and ``num_key_value_heads / mp`` local kv heads (a kv
    head count the degree does not divide raises); the q/k/v and the
    gate/up layers share one copy of their input into the mp region, and
    the o and down projections all-reduce their partial products once, so
    a block has one all-reduce each way per attention and per MLP; the head
    gives vocab-sharded logits (``forward`` returns this rank's shard) and
    ``loss`` runs through ``ParallelCrossEntropy``."""

    def _prepare_for_model(self):
        self._dp = None
        n = self._hcg.get_model_parallel_world_size()
        if n > 1:
            check_whole_units(self._layers, n)
            mp = self._hcg.get_model_parallel_group()
            place_parameters(self._layers, mp)
            self._broadcast_replicated(mp)
        dp = self._hcg.get_data_parallel_group()
        if dp is not None and dp.nranks > 1:
            from ...parallel import DataParallel

            self._dp = DataParallel(self._layers, group=dp)

    @torch.no_grad()
    def _broadcast_replicated(self, mp):
        from ...communication import broadcast

        for p in self._layers.parameters():
            if not getattr(p, "is_distributed", False):
                broadcast(p.data, src=mp.ranks[0], group=mp)


class SegmentParallel(_MetaParallelBase):
    """ref: meta_parallel/segment_parallel.py:26: every parameter broadcast
    over the sep group from its first rank; with dp > 1 the layers are
    also wrapped in ``DataParallel`` over the dp group (its ``_dp``). The
    model's attention runs ``sep_parallel_attention``, whose Megatron
    pair leaves every other gradient equal over the sep group."""

    def _prepare_for_model(self):
        from ...communication import broadcast

        self._dp = None
        sep = self._hcg.get_sep_parallel_group()
        if sep is not None and sep.nranks > 1:
            with torch.no_grad():
                for p in self._layers.parameters():
                    broadcast(p.data, src=sep.ranks[0], group=sep)
        dp = self._hcg.get_data_parallel_group()
        if dp is not None and dp.nranks > 1:
            from ...parallel import DataParallel

            self._dp = DataParallel(self._layers, group=dp)


from .pipeline_parallel import (  # noqa: E402,F401
    LayerDesc,
    PipelineLayer,
    PipelineParallel,
    SharedLayerDesc,
)
from .moe import (  # noqa: E402,F401
    ClipGradForMOEByGlobalNorm,
    ExpertMLP,
    MoELayer,
    TopKGate,
    place_experts_on_mesh,
)
