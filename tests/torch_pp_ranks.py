"""Rank bodies for the port's pipeline, ring-attention and MoE CPU tests
(``PipelineParallel`` over point-to-point sends, ``sep_parallel_attention``
and ``SegmentParallel``, ``MoELayer`` with expert parallelism).

Each body runs in a gloo rank started by ``torch_dist_ranks.run_ranks`` and
returns numpy results; the tests compute the reference's results in the
pytest process and pass them (and the reference's weights) in as numpy.
This module imports torch and the port only (the children import it
fresh).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _leaf(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), requires_grad=True)


class Block(nn.Module):
    """The reference tests' pipeline block: ``relu(fc(x))``."""

    def __init__(self, h):
        super().__init__()
        from paddle_tpu_torch.nn import Linear

        self.fc = Linear(h, h, device="cpu", dtype=torch.float32)

    def forward(self, x):
        return torch.relu(self.fc(x))


def _ce(logits, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1))


# ---------------------------------------------------------------------------
# the pipeline


def block_pipe(n_layers, h, c, V):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.nn import Linear

    return PipelineLayer(
        [LayerDesc(Block, h) for _ in range(n_layers)]
        + [Linear(h, c, device="cpu", dtype=torch.float32)],
        num_virtual_pipeline_stages=V, loss_fn=_ce)


def pipeline_block_body(rank, world, dp, V, M, n_layers, arrays, xs, ys,
                        lr):
    """``fleet.init(dp, pp=world/dp)``, ``distributed_model`` (a
    ``PipelineParallel`` over the Block pipeline) and SGD through
    ``distributed_optimizer``; ``train_batch`` on each step's batch (each
    dp rank on its rows of every microbatch), then ``eval_batch`` on the
    last one (the loss, and the logits)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.utils import load_jax_params

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "pp_degree": world // dp}
    s.pipeline_configs = {"accumulate_steps": M}
    hcg = fleet.init(strategy=s, device="cpu")
    h, c = arrays["_post.0.weight"].shape
    pipe = block_pipe(n_layers, h, c, V)
    load_jax_params(pipe, arrays)
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(SGD(learning_rate=lr,
                                          parameters=pipe.parameters()))
    d = hcg.get_data_parallel_rank()
    losses = []
    for x, y in zip(xs, ys):
        x, y = _dp_rows(x, d, dp, M), _dp_rows(y, d, dp, M)
        losses.append(float(model.train_batch(
            (torch.from_numpy(x), torch.from_numpy(y)), opt)))
    ev = float(model.eval_batch((torch.from_numpy(x), torch.from_numpy(y))))
    logits = model.eval_batch((torch.from_numpy(x), torch.from_numpy(y)),
                              compute_loss=False)
    return {"losses": losses, "eval": ev, "logits": logits.numpy(),
            "stage": hcg.get_stage_id(), "dp_rank": d,
            "params": {n: p.detach().numpy().copy()
                       for n, p in pipe.named_parameters()},
            "hops": model.hops,
            "n_syncs": model._dp.n_syncs if model._dp is not None else 0}


def _dp_rows(a, d, dp, M):
    """dp rank ``d``'s rows of each of the ``M`` microbatches of ``a``
    (the reference shards every microbatch over dp)."""
    mb = a.shape[0] // M
    part = mb // dp
    return np.concatenate([a[m * mb + d * part:m * mb + (d + 1) * part]
                           for m in range(M)])


def llama_pipe(cfg, V=1, recompute=0, device="cpu", dtype=torch.float32):
    """Llama as a ``PipelineLayer``: the embedding, the decoder layers, the
    final norm and the head, built in ``LlamaForCausalLM``'s order (so from
    one seed both hold the same weights)."""
    from paddle_tpu_torch.base.random import get_generator
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer
    from paddle_tpu_torch.nn import Embedding, Linear, RMSNorm

    dev = torch.device(device)
    gen = get_generator(dev)
    kw = dict(device=dev, dtype=dtype)
    h = cfg.hidden_size
    return PipelineLayer(
        [LayerDesc(Embedding, cfg.vocab_size, h, generator=gen, **kw)]
        + [LayerDesc(LlamaDecoderLayer, cfg, generator=gen, **kw)
           for _ in range(cfg.num_hidden_layers)]
        + [LayerDesc(RMSNorm, h, cfg.rms_norm_eps, **kw),
           LayerDesc(Linear, h, cfg.vocab_size, bias=False, generator=gen,
                     **kw)],
        num_virtual_pipeline_stages=V, loss_fn=_ce,
        recompute_interval=recompute)


def pipeline_llama_body(rank, world, V, M, n_layers, arrays, ids, labels,
                        steps, clip_norm, recompute):
    """``LlamaConfig.tiny`` at ``n_layers`` as a pipeline at pp = world:
    AdamW with ``ClipGradByGlobalNorm`` through ``distributed_optimizer``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import load_jax_params

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": world}
    s.pipeline_configs = {"accumulate_steps": M}
    fleet.init(strategy=s, device="cpu")
    pipe = llama_pipe(LlamaConfig.tiny(num_hidden_layers=n_layers), V,
                      recompute)
    load_jax_params(pipe, arrays)
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, parameters=pipe.parameters(),
        grad_clip=ClipGradByGlobalNorm(clip_norm)))
    clip = opt._inner_opt._grad_clip
    losses, norms = [], []
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    for _ in range(steps):
        losses.append(float(model.train_batch((x, y), opt)))
        norms.append(float(clip.last_global_norm))
    return {"losses": losses, "norms": norms,
            "params": {n: p.detach().numpy().copy()
                       for n, p in pipe.named_parameters()}}


def shared_pipe(h, n_layers, num_stages=None):
    """A pipeline whose first and last layer are one ``SharedLayerDesc``
    instance (a ``Linear(h, h)``), the Blocks between them."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.nn import Linear

    tied = SharedLayerDesc("tied", Linear, h, h, device="cpu",
                           dtype=torch.float32)
    return PipelineLayer([tied] + [LayerDesc(Block, h)
                                   for _ in range(n_layers)] + [tied],
                         num_stages=num_stages, loss_fn=_ce)


def shared_body(rank, world, M, n_layers, arrays, xs, ys, lr, clip_norm):
    """The tied pipeline at pp = world: SGD with ``ClipGradByGlobalNorm``
    through ``distributed_optimizer``; the losses, the clip's norms, the
    stage's parameters."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.utils import load_jax_params

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": world}
    s.pipeline_configs = {"accumulate_steps": M}
    fleet.init(strategy=s, device="cpu")
    pipe = shared_pipe(xs.shape[-1], n_layers)
    load_jax_params(pipe, arrays)
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(SGD(
        learning_rate=lr, parameters=pipe.parameters(),
        grad_clip=ClipGradByGlobalNorm(clip_norm)))
    losses, norms = [], []
    for x, y in zip(xs, ys):
        losses.append(float(model.train_batch(
            (torch.from_numpy(x), torch.from_numpy(y)), opt)))
        norms.append(float(opt._inner_opt._grad_clip.last_global_norm))
    return {"losses": losses, "norms": norms,
            "params": {n: p.detach().numpy().copy()
                       for n, p in pipe.named_parameters()}}


def routing_body(rank, world):
    """pp beside mp, sep or sharding raises (one ``fleet.init`` each); the
    messages."""
    from paddle_tpu_torch.distributed import fleet

    out = {}
    for other in ("mp", "sep", "sharding"):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"pp_degree": 2, f"{other}_degree": 2}
        fleet.init(strategy=s, device="cpu")
        pipe = block_pipe(4, 8, 3, 1)
        try:
            fleet.distributed_model(pipe)
            out[other] = "no error"
        except NotImplementedError as e:
            out[other] = str(e)
    return out


# ---------------------------------------------------------------------------
# ring attention and SegmentParallel


def ring_body(rank, world, q, k, v, c, causal):
    """``sep_parallel_attention`` over the world group on the global
    q/k/v: the output and the gradients of ``sum(out * c)``."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops.ring_attention import sep_parallel_attention

    g = collective._get_global_group()
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    out = sep_parallel_attention(tq, tk, tv, g, causal=causal)
    (out * torch.from_numpy(c)).sum().backward()
    return {"out": out.detach().numpy(), "dq": tq.grad.numpy(),
            "dk": tk.grad.numpy(), "dv": tv.grad.numpy()}


class SepBlock(nn.Module):
    """The reference test's attention block (tests/test_hybrid_parallel.py
    SepBlock): qkv, attention over the sep group (or plain), o, residual."""

    def __init__(self, h, heads, use_sep=True, device="cpu",
                 dtype=torch.float32):
        super().__init__()
        from paddle_tpu_torch.nn import Linear

        self.h, self.heads, self.use_sep = h, heads, use_sep
        self.qkv = Linear(h, 3 * h, device=device, dtype=dtype)
        self.o = Linear(h, h, device=device, dtype=dtype)

    def forward(self, x):
        from paddle_tpu_torch.ops.ring_attention import (
            ring_attention, sep_parallel_attention)

        b, s, hh = x.shape
        d = hh // self.heads
        qkv = self.qkv(x).reshape(b, s, 3, self.heads, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.use_sep:
            out = sep_parallel_attention(q, k, v, causal=True)
        else:
            out = ring_attention(q, k, v, None, causal=True)
        return x + self.o(out.reshape(b, s, hh))


class SepNet(nn.Module):
    """Two SepBlocks and a head (``[B, S, h] -> [B, S, c]``)."""

    def __init__(self, h, heads, c, use_sep=True):
        super().__init__()
        from paddle_tpu_torch.nn import Linear

        self.blocks = nn.ModuleList([SepBlock(h, heads, use_sep)
                                     for _ in range(2)])
        self.head = Linear(h, c, device="cpu", dtype=torch.float32)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return self.head(x)


def sep_body(rank, world, arrays, heads, xs, ys, lr):
    """``fleet.init(sep_degree=world)`` and ``distributed_model`` (a
    ``SegmentParallel``) around a SepNet, SGD steps on the whole
    sequence (each rank's attention on its block of it)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.utils import load_jax_params

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sep_degree": world}
    fleet.init(strategy=s, device="cpu")
    h, c = arrays["head.weight"].shape
    net = SepNet(h, heads, c)
    load_jax_params(net, arrays)
    model = fleet.distributed_model(net)
    opt = SGD(learning_rate=lr, parameters=net.parameters())
    losses = []
    for x, y in zip(xs, ys):
        loss = _ce(model(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return {"losses": losses, "wrapper": type(model).__name__,
            "params": {n: p.detach().numpy().copy()
                       for n, p in net.named_parameters()}}


# ---------------------------------------------------------------------------
# MoE with expert parallelism


def moe_ep_body(rank, world, arrays, x, c, mode, clip_norm):
    """An ``MoELayer`` with its experts placed over the world group (E/ep
    a rank): the output, the gradients (experts gathered whole) and the
    MoE clip's global norm over the rank's gradients."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import \
        _all_gather
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ClipGradForMOEByGlobalNorm, MoELayer, place_experts_on_mesh)
    from paddle_tpu_torch.utils import load_jax_params

    g = collective._get_global_group()
    e, hdim, f = arrays["experts.w1"].shape
    moe = MoELayer(hdim, f, e, top_k=2, capacity_factor=4.0,
                   dispatch_mode=mode, device="cpu")
    place_experts_on_mesh(moe, g)
    load_jax_params(moe, arrays)
    tx = _leaf(x)
    out = moe(tx)
    ((out * torch.from_numpy(c)).sum() + 0.1 * moe.l_aux).backward()
    grads = {n: (_all_gather(p.grad, g, 0) if getattr(p, "_ep_shard", None)
                 else p.grad).numpy().copy()
             for n, p in moe.named_parameters()}
    pg = [(p, p.grad) for p in moe.parameters()]
    clip = ClipGradForMOEByGlobalNorm(clip_norm, moe_group=g)
    return {"out": out.detach().numpy(), "dx": tx.grad.numpy(),
            "grads": grads, "l_aux": float(moe.l_aux),
            "shapes": {n: tuple(p.shape) for n, p in moe.named_parameters()},
            "moe_norm": float(clip.global_norm(pg)),
            "no_group_norm": float(
                ClipGradForMOEByGlobalNorm(clip_norm).global_norm(pg))}


def moe_clip_routing_body(rank, world):
    """``distributed_optimizer`` over an optimizer with the MoE clip, on a
    topology of mp=2, pp=2 and dp=2 (one ``fleet.init`` each): the error,
    or the clip's type where it is kept."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        ClipGradForMOEByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD

    out = {}
    for axis in ("mp", "pp", "dp"):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {f"{axis}_degree": 2}
        fleet.init(strategy=s, device="cpu")
        net = Block(4)
        opt = SGD(learning_rate=0.1, parameters=net.parameters(),
                  grad_clip=ClipGradForMOEByGlobalNorm(1.0))
        try:
            out[axis] = type(fleet.distributed_optimizer(opt)._grad_clip
                             ).__name__
        except NotImplementedError as e:
            out[axis] = str(e)
    return out
