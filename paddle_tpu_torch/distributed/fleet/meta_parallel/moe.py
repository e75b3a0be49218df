"""Mixture-of-Experts with expert parallelism (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/moe.py``; ref:
python/paddle/incubate/distributed/models/moe/ moe_layer.py,
gate/gshard_gate.py, grad_clip.py).

The routing is the reference's, op for op: a top-k softmax gate with the
gshard load-balance loss and a capacity per expert, and two dispatch modes,
``"einsum"`` (a dense ``[N, E, C]`` dispatch mask and two contractions) and
``"sort"`` (a stable sort of the N·k (token, expert) slots by expert, a
scatter into the ``[E, C, H]`` expert buffer, a gather and a weighted
scatter-add back). The experts are stacked, ``w1 [E, H, F]`` and ``w2 [E,
F, H]``, with ``ep_axis`` 0.

Expert parallelism. The reference shards the expert dimension over its
``ep`` mesh axis and keeps the tokens replicated: its ep run equals the
replicated one. The port does the same with one process per rank.
:func:`place_experts_on_mesh` cuts ``w1`` and ``w2`` to the rank's E/ep
experts; every rank builds the same ``[E, C, H]`` expert input from the
same tokens, takes its experts' rows (``_ScatterToMP``: the backward
all-gathers the rows' gradients, so the input's gradient is whole on every
rank), runs its experts, and all-gathers their outputs (``_GatherFromMP``:
the backward takes the rank's rows, so no expert gradient is counted
twice). That is an all-gather over the ep group, not an all-to-all: an
all-to-all arises only when the tokens are sharded too, which the
reference's ep does not do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as TF

from ....base.device import get_device
from ....base.dtype import to_torch_dtype
from ....base.random import get_generator
from ....nn.clip import ClipGradByGlobalNorm, _sq_sum

__all__ = ["ExpertMLP", "TopKGate", "MoELayer", "place_experts_on_mesh",
           "ClipGradForMOEByGlobalNorm", "is_expert_param"]

# jax.nn.gelu's default is the tanh approximation
_ACTS = {"gelu": lambda x: TF.gelu(x, approximate="tanh"), "relu": torch.relu}


def _uniform(shape, bound, device, dtype, generator):
    w = torch.empty(shape, device=device, dtype=dtype)
    return nn.Parameter(w.uniform_(-bound, bound, generator=generator))


class ExpertMLP(nn.Module):
    """E stacked feed-forward experts: ``w1 [E, H, F]``, ``w2 [E, F, H]``,
    each with ``ep_axis`` 0. Under expert parallelism (``ep_group``, set by
    :func:`place_experts_on_mesh`) a rank holds E/ep of them."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: str = "gelu", *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = get_device(device)
        dtype = to_torch_dtype(dtype)
        gen = generator if generator is not None else get_generator(dev)
        self.num_experts = num_experts
        self.activation = activation
        self.w1 = _uniform([num_experts, d_model, d_hidden],
                           1.0 / math.sqrt(d_model), dev, dtype, gen)
        self.w2 = _uniform([num_experts, d_hidden, d_model],
                           1.0 / math.sqrt(d_hidden), dev, dtype, gen)
        self.w1.ep_axis = 0
        self.w2.ep_axis = 0
        self.ep_group = None

    def forward(self, x):
        """``x``: ``[E, C, H]`` (every expert's slots) -> ``[E, C, H]``."""
        from ..layers.mpu.mp_layers import _GatherFromMP, _ScatterToMP

        g = self.ep_group
        sharded = g is not None and g.nranks > 1
        if sharded:
            x = _ScatterToMP.apply(x, g, 0)
        h = _ACTS[self.activation](torch.bmm(x, self.w1))
        out = torch.bmm(h, self.w2)
        return _GatherFromMP.apply(out, g, 0) if sharded else out


class TopKGate(nn.Module):
    """Top-k softmax gate with the gshard load-balance loss (ref:
    gate/gshard_gate.py, gate/naive_gate.py); ``top_k`` 1 or 2."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 or 2 (gshard/switch gating)")
        dev = get_device(device)
        gen = generator if generator is not None else get_generator(dev)
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.weight = _uniform([d_model, num_experts],
                               1.0 / math.sqrt(d_model), dev,
                               to_torch_dtype(dtype), gen)

    def capacity(self, num_tokens: int) -> int:
        return max(self.top_k, int(math.ceil(
            num_tokens / self.num_experts * self.capacity_factor)))

    def forward(self, x):
        """``x``: ``[N, H]`` -> ``(dispatch [N, E, C], combine [N, E, C],
        l_aux)``."""
        cap = self.capacity(int(x.shape[0]))
        e = self.num_experts
        gates = torch.softmax((x @ self.weight).float(), dim=-1)
        mask1 = TF.one_hot(gates.argmax(-1), e).to(gates.dtype)
        l_aux = (gates.mean(0) * mask1.mean(0)).sum() * e
        if self.top_k == 2:
            gates2 = gates.masked_fill(mask1 > 0, -math.inf)
            mask2 = TF.one_hot(gates2.argmax(-1), e).to(gates.dtype)
        else:
            mask2 = torch.zeros_like(mask1)
        # each token's place in its expert's capacity
        pos1 = torch.cumsum(mask1, 0) - mask1
        mask1 = mask1 * (pos1 < cap)
        pos2 = torch.cumsum(mask2, 0) - mask2 + mask1.sum(0)
        mask2 = mask2 * (pos2 < cap)
        g1 = (gates * mask1).sum(-1)
        g2 = (gates * mask2).sum(-1)
        denom = g1 + g2
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        g1, g2 = g1 / denom, g2 / denom
        cap1 = TF.one_hot((pos1 * mask1).sum(-1).long(), cap).to(gates.dtype)
        cap2 = TF.one_hot((pos2 * mask2).sum(-1).long(), cap).to(gates.dtype)
        combine = (g1[:, None, None] * mask1[:, :, None] * cap1[:, None, :]
                   + g2[:, None, None] * mask2[:, :, None] * cap2[:, None, :])
        dispatch = (combine > 0).to(x.dtype)
        return dispatch, combine.to(x.dtype), l_aux


class MoELayer(nn.Module):
    """ref: incubate moe_layer.py MoELayer, a drop-in FFN: ``[B, S, H] ->
    [B, S, H]``, setting ``self.l_aux`` on each call.

    ``dispatch_mode``: ``"einsum"`` (the GShard dense dispatch) or
    ``"sort"`` (the scatter dispatch, O(N·k·H) instead of O(N·E·C·H); the
    same routing when nothing overflows; on overflow only the drop order
    differs: einsum drops every second choice after the first choices,
    sort goes by token within each expert). ``"sort"`` takes only the
    built-in gate and experts."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 gate: Optional[TopKGate] = None,
                 experts: Optional[nn.Module] = None,
                 activation: str = "gelu", dispatch_mode: str = "einsum", *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dispatch_mode not in ("einsum", "sort"):
            raise ValueError(f"dispatch_mode must be 'einsum' or 'sort', got "
                             f"{dispatch_mode!r}")
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.num_experts = num_experts
        self.gate = gate or TopKGate(d_model, num_experts, top_k,
                                     capacity_factor, **kw)
        self.experts = experts or ExpertMLP(num_experts, d_model, d_hidden,
                                            activation, **kw)
        if dispatch_mode == "sort" and (type(self.gate) is not TopKGate or
                                        type(self.experts) is not ExpertMLP):
            raise ValueError(
                "dispatch_mode='sort' supports only the built-in "
                "TopKGate/ExpertMLP; use dispatch_mode='einsum' with "
                "custom gate/experts layers")
        self.l_aux = None
        self.dispatch_mode = dispatch_mode

    def forward(self, x):
        b, s, h = x.shape
        tokens = x.reshape(b * s, h)
        if self.dispatch_mode == "sort":
            out, self.l_aux = self._forward_sort(tokens)
            return out.reshape(b, s, h)
        dispatch, combine, self.l_aux = self.gate(tokens)
        n, e, c = dispatch.shape
        # [N, H], [N, E, C] -> [E, C, H] and back
        expert_in = (dispatch.reshape(n, e * c).t() @ tokens).reshape(e, c, h)
        expert_out = self.experts(expert_in)
        out = combine.reshape(n, e * c) @ expert_out.reshape(e * c, h)
        return out.reshape(b, s, h)

    def _forward_sort(self, t):
        n, h = t.shape
        e, k = self.num_experts, self.gate.top_k
        cap = self.gate.capacity(n)
        dev = t.device
        gates = torch.softmax((t @ self.gate.weight).float(), dim=-1)
        gate_vals, expert_ids = torch.topk(gates, k, dim=-1)  # [N, k]
        mask1 = TF.one_hot(expert_ids[:, 0], e).to(gates.dtype)
        l_aux = (gates.mean(0) * mask1.mean(0)).sum() * e
        flat_expert = expert_ids.reshape(-1)
        src_token = torch.arange(n * k, device=dev) // k
        order = torch.argsort(flat_expert, stable=True)
        sorted_expert = flat_expert[order]
        counts = torch.bincount(sorted_expert, minlength=e)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(n * k, device=dev) - starts[sorted_expert]
        keep_sorted = pos < cap
        # renormalised over the surviving slots, as the einsum gate's
        # denominator is taken after its capacity mask
        keep = torch.zeros(n * k, dtype=torch.bool, device=dev)
        keep[order] = keep_sorted
        kept = gate_vals * keep.reshape(n, k)
        denom = kept.sum(-1, keepdim=True)
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        flat_gate = (kept / denom).reshape(-1).to(t.dtype)
        # a slot in the [E*C] buffer; overflow goes to the trash row E*C
        slot = torch.where(keep_sorted, sorted_expert * cap + pos,
                           torch.full_like(pos, e * cap))
        src = src_token[order]
        buf = torch.zeros(e * cap + 1, h, dtype=t.dtype, device=dev)
        buf = buf.index_put((slot,), t[src])
        xout = self.experts(buf[:e * cap].reshape(e, cap, h))
        out_buf = torch.cat([xout.reshape(e * cap, h),
                             torch.zeros(1, h, dtype=t.dtype, device=dev)])
        gathered = out_buf[slot] * flat_gate[order][:, None]
        # at most two adds a token (top_k <= 2) onto a zero row: the sum
        # does not depend on their order
        out = torch.zeros(n, h, dtype=t.dtype, device=dev).index_add(
            0, src, gathered)
        return out, l_aux


def place_experts_on_mesh(layer: nn.Module, group, ep_axis: str = "ep"):
    """Expert parallelism over ``group``: every parameter with an
    ``ep_axis`` is cut in place to this rank's 1/ep of that dimension (rank
    r keeps experts ``[r·E/ep, (r+1)·E/ep)``), and every ``ExpertMLP``
    exchanges its experts over ``group``. ``ep_axis`` (the reference's mesh
    axis name) is accepted for parity. Returns ``layer``."""
    from ..layers.mpu.mp_layers import _split

    if group is None or group.nranks <= 1:
        return layer
    n = group.nranks
    for name, p in layer.named_parameters():
        ax = getattr(p, "ep_axis", None)
        if ax is None or getattr(p, "_ep_shard", None) is not None:
            continue
        if p.shape[ax] % n:
            raise ValueError(
                f"expert dim of parameter {name} ({p.shape[ax]}) is not "
                f"divisible by the {ep_axis!r} degree {n}; choose "
                "num_experts divisible by the EP degree")
        with torch.no_grad():
            p.data = _split(p.data, group, ax)
        p._ep_shard = (group.rank, n)
    for m in layer.modules():
        if isinstance(m, ExpertMLP):
            m.ep_group = group
    return layer


def is_expert_param(p) -> bool:
    """Default expert-parameter predicate: anything carrying the ``ep_axis``
    hint (ExpertMLP's stacked weights) or an explicit ``is_expert`` flag."""
    return getattr(p, "ep_axis", None) is not None or bool(
        getattr(p, "is_expert", False))


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    """Expert-aware global-norm clip (ref: incubate/distributed/models/moe/
    grad_clip.py). Under expert parallelism a rank holds 1/ep of the
    experts and all of every other parameter, so the squares of the expert
    gradients are summed over ``moe_group`` and those of the rest counted
    once: ``global_norm^2 = norm^2(the rest) + all_reduce(norm^2(local
    experts))``, one scale for every gradient, equal on every rank. With
    ``moe_group`` None (or of one rank) it is the dense clip, bit for bit."""

    def __init__(self, clip_norm=1.0, is_expert_param_func=None,
                 moe_group=None):
        super().__init__(clip_norm)
        self.is_expert = (is_expert_param_func if is_expert_param_func
                          is not None else is_expert_param)
        self.moe_group = moe_group

    def _reduce_expert_sq(self, sq):
        from ...communication import all_reduce

        all_reduce(sq, group=self.moe_group)
        return sq

    def _total_sq(self, clippable):
        if self.moe_group is None or self.moe_group.nranks <= 1:
            # every expert is here: the dense clip's sum, in its order
            return super()._total_sq(clippable)
        expert_sq = normal_sq = None
        for p, g in clippable:
            s = _sq_sum(g)
            if self.is_expert(p):
                expert_sq = s if expert_sq is None else expert_sq + s
            else:
                normal_sq = s if normal_sq is None else normal_sq + s
        if expert_sq is not None:
            expert_sq = self._reduce_expert_sq(expert_sq)
        parts = [s for s in (normal_sq, expert_sq) if s is not None]
        total = parts[0]
        for s in parts[1:]:
            total = total + s
        return total
