"""Rank bodies for the port's tensor-parallel CPU tests (the hybrid topology,
the mp layers, ``TensorParallel`` on Llama, sequence parallelism).

Each body runs in a gloo rank started by
``torch_dist_ranks.run_ranks`` and returns numpy results; the tests compute
the reference's results in the pytest process and pass them (and the
reference's full weights) in as numpy. This module imports torch and the
port only (the children import it fresh).
"""
from __future__ import annotations

import numpy as np
import torch


def _recorder():
    from paddle_tpu_torch.distributed.communication import flight_recorder

    return flight_recorder.recorder()


def _fleet(dp: int, mp: int):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    return fleet.init(strategy=s, device="cpu")


def _gather(t: torch.Tensor, group, dim: int) -> np.ndarray:
    from paddle_tpu_torch.distributed.fleet.layers.mpu.mp_layers import \
        _all_gather

    return _all_gather(t.detach().contiguous(), group, dim).numpy()


def _full(p: torch.Tensor, group) -> np.ndarray:
    """A parameter (or its gradient's parameter) whole: gathered over the
    mp group along its ``tp_axis`` where it is a shard."""
    if getattr(p, "is_distributed", False):
        return _gather(p, group, p.tp_axis)
    return p.detach().numpy().copy()


def _full_grad(p: torch.Tensor, group) -> np.ndarray:
    if getattr(p, "is_distributed", False):
        return _gather(p.grad, group, p.tp_axis)
    return p.grad.detach().numpy().copy()


def _leaf(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), requires_grad=True)


# ---------------------------------------------------------------------------
# the hybrid topology


def topology_body(rank, world, dp, mp):
    """``fleet.init`` at dp x mp: this rank's groups and coordinates, the
    role makers and ``UtilBase`` on the live group."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.base.role_maker import \
        _RoleMakerBase

    hcg = _fleet(dp, mp)
    res = {
        "groups": {name: hcg._groups[name].ranks for name in hcg._groups},
        "dp": (hcg.get_data_parallel_rank(), hcg.get_data_parallel_world_size(),
               hcg.get_data_parallel_group().ranks),
        "mp": (hcg.get_model_parallel_rank(), hcg.get_model_parallel_world_size(),
               hcg.get_model_parallel_group().ranks),
        "pp": (hcg.get_stage_id(), hcg.get_pipe_parallel_group().ranks),
        "sharding": (hcg.get_sharding_parallel_rank(),
                     hcg.get_sharding_parallel_group().ranks),
        "sep": (hcg.get_sep_parallel_rank(), hcg.get_sep_parallel_group().ranks),
        "check": hcg.get_check_parallel_group().ranks,
        "check_sharding": hcg.get_check_parallel_group(True).ranks,
        "dp_sep": hcg.get_dp_sep_parallel_group().ranks,
        "global_rank": hcg.get_global_rank(),
        "fleet": (fleet.get_rank(), fleet.worker_num(), fleet.worker_index()),
        "role": (_RoleMakerBase().worker_index(), _RoleMakerBase().worker_num()),
    }
    util = fleet.UtilBase()
    res["util_sum"] = util.all_reduce(np.array([rank, 1.0]), "sum")
    res["util_max"] = util.all_reduce(np.array([rank]), "max")
    res["util_gather"] = util.all_gather({"r": rank})
    res["file_shard"] = util.get_file_shard([f"f{i}" for i in range(7)])
    # the mp group's all-reduce reaches only this rank's mp peers
    t = torch.tensor([float(rank)])
    from paddle_tpu_torch.distributed import all_reduce

    all_reduce(t, group=hcg.get_model_parallel_group())
    res["mp_sum"] = float(t)
    t = torch.tensor([float(rank)])
    all_reduce(t, group=hcg.get_data_parallel_group())
    res["dp_sum"] = float(t)
    return res


# ---------------------------------------------------------------------------
# the mp layers


def _linear_pair(case, key, gather_output, input_is_parallel):
    from paddle_tpu_torch.distributed.fleet.layers.mpu import (
        ColumnParallelLinear, RowParallelLinear)
    from paddle_tpu_torch.utils import load_jax_params

    col = ColumnParallelLinear(16, 32, has_bias=True,
                               gather_output=gather_output, device="cpu")
    row = RowParallelLinear(32, 8, input_is_parallel=input_is_parallel,
                            device="cpu")
    load_jax_params(col, case[key]["col"])
    load_jax_params(row, case[key]["row"])
    return col, row


def mp_linears_body(rank, world, case, full):
    """Column then row (sharded between them), and each alone with a whole
    input or output, at mp = world; ``full``: also the embedding, the
    cross entropy, the TP MLP's training and ``split``."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.distributed import split
    from paddle_tpu_torch.distributed.fleet.layers.mpu import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.utils import load_jax_params

    hcg = _fleet(1, world)
    g = hcg.get_model_parallel_group()
    res = {}
    col, row = _linear_pair(case, "pair", False, True)
    x = _leaf(case["x"])
    y = row(col(x))
    (y * torch.from_numpy(case["cy"])).sum().backward()
    res["pair"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                   "col.weight": _full_grad(col.weight, g),
                   "col.bias": _full_grad(col.bias, g),
                   "row.weight": _full_grad(row.weight, g),
                   "row.bias": _full_grad(row.bias, g),
                   "shapes": (tuple(col.weight.shape), tuple(row.weight.shape)),
                   "meta": [(p.tp_axis, p.is_distributed) for p in
                            (col.weight, col.bias, row.weight, row.bias)]}
    # the column layer gathering its output; the row layer slicing its input
    col, row = _linear_pair(case, "pair", True, False)
    x = _leaf(case["x"])
    h = col(x)
    (h * torch.from_numpy(case["ch"])).sum().backward()
    res["col_gather"] = {"y": h.detach().numpy(), "dx": x.grad.numpy()}
    xr = _leaf(case["xr"])
    y = row(xr)
    (y * torch.from_numpy(case["cy"])).sum().backward()
    res["row_split"] = {"y": y.detach().numpy(), "dx": xr.grad.numpy()}
    if not full:
        return res

    emb = VocabParallelEmbedding(32, 16, device="cpu")
    load_jax_params(emb, case["emb"])
    out = emb(torch.from_numpy(case["ids"]))
    (out * torch.from_numpy(case["cemb"])).sum().backward()
    res["emb"] = {"y": out.detach().numpy(), "dw": _full_grad(emb.weight, g)}

    per = case["logits"].shape[1] // world
    logits = _leaf(case["logits"][:, rank * per:(rank + 1) * per])
    pce = ParallelCrossEntropy()
    loss = pce(logits, torch.from_numpy(case["labels"]))
    (loss * torch.from_numpy(case["closs"])).sum().backward()
    res["pce"] = {"loss": loss.detach().numpy(),
                  "dlogits": _gather(logits.grad, g, 1)}

    # the reference's test_tp_training_matches_serial: a TP MLP, SGD
    class TPNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = ColumnParallelLinear(16, 32, has_bias=True,
                                            gather_output=False, device="cpu")
            self.fc2 = RowParallelLinear(32, 4, input_is_parallel=True,
                                         device="cpu")

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    net = TPNet()
    load_jax_params(net, case["mlp"])
    opt = SGD(learning_rate=0.1, parameters=net.parameters())
    losses = []
    for xs, ys in zip(case["mlp_x"], case["mlp_y"]):
        loss = F.cross_entropy(net(torch.from_numpy(xs)), torch.from_numpy(ys))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    res["mlp_losses"] = losses

    # split: the layer split builds, rebuilt from the same seed, whole
    xs = torch.from_numpy(case["x"])
    got, want = {}, {}
    for kind, args in (("col", ((16, 32), "linear", 1)),
                       ("row", ((16, 8), "linear", 0)),
                       ("emb", ((32, 16), "embedding", 0))):
        inp = torch.from_numpy(case["ids"]) if kind == "emb" else xs
        pt_seed(11)
        got[kind] = split(inp, *args).detach().numpy()
        pt_seed(11)
        size = args[0]
        if kind == "col":
            layer = ColumnParallelLinear(*size, has_bias=True, device="cpu")
            w, b = _full(layer.weight, g), _full(layer.bias, g)
            want[kind] = case["x"] @ w + b
        elif kind == "row":
            layer = RowParallelLinear(*size, has_bias=True, device="cpu")
            w, b = _full(layer.weight, g), _full(layer.bias, g)
            want[kind] = case["x"] @ w + b
        else:
            layer = VocabParallelEmbedding(*size, device="cpu")
            want[kind] = _full(layer.weight, g)[case["ids"]]
    res["split"], res["split_want"] = got, want
    return res


# ---------------------------------------------------------------------------
# TensorParallel on Llama


def _tiny(arrays=None, **kw):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.utils import load_jax_params

    model = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    if arrays is not None:
        load_jax_params(model, arrays)
    return model


def tp_llama_body(rank, world, dp, arrays, ids, labels, steps, clip_norm):
    """``fleet.init(dp, mp)``, ``distributed_model`` and
    ``distributed_optimizer`` (AdamW with ``ClipGradByGlobalNorm``) around
    the Llama step; each dp rank trains on its part of the batch."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.layers.mpu import \
        ColumnParallelLinear
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.utils import load_jax_params

    mp = world // dp
    hcg = _fleet(dp, mp)
    g = hcg.get_model_parallel_group()
    res = {}
    # built from a seed: the TP model's shards are the serial model's slices
    pt_seed(3)
    serial = {n: p.detach().numpy().copy()
              for n, p in _tiny().named_parameters()}
    pt_seed(3)
    seeded = fleet.distributed_model(_tiny())
    res["seed_slices_equal"] = all(
        np.array_equal(_full(p, g), serial[n])
        for n, p in seeded.named_parameters())
    # an mp layer built at mp=world holds slices of the one built at mp=1
    pt_seed(4)
    one = ColumnParallelLinear(16, 32, has_bias=True, device="cpu",
                               mp_group=_OneRank())
    pt_seed(4)
    many = ColumnParallelLinear(16, 32, has_bias=True, device="cpu")
    res["mp_layer_seed_equal"] = bool(np.array_equal(
        _full(many.weight, g), one.weight.detach().numpy()))

    model = _tiny(arrays)
    tp = fleet.distributed_model(model)
    load_jax_params(model, arrays)  # the reference's whole arrays, sliced
    res["loaded_equal"] = all(np.array_equal(_full(p, g), arrays[n])
                              for n, p in model.named_parameters())
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(clip_norm))
    opt = fleet.distributed_optimizer(opt)
    b = ids.shape[0] // dp
    r = hcg.get_data_parallel_rank()
    x = torch.from_numpy(ids[r * b:(r + 1) * b])
    y = torch.from_numpy(labels[r * b:(r + 1) * b])
    losses, norms = [], []
    for i in range(steps):
        if i == steps - 1:
            seq0 = _recorder().snapshot()[-1].seq
        loss = tp.loss(x, y)
        loss.backward()
        opt.step()
        norms.append(float(opt._inner_opt._grad_clip.last_global_norm))
        opt.clear_grad()
        losses.append(float(loss.detach()))
    res["losses"], res["norms"] = losses, norms
    # the last step's collectives by group: {"mp"|"dp": {op: count}}
    ids_ = {str(g.id): "mp", str(hcg.get_data_parallel_group().id): "dp"}
    res["step_collectives"] = {}
    for e in _recorder().snapshot():
        if e.seq > seq0 and e.group in ids_:
            ops = res["step_collectives"].setdefault(ids_[e.group], {})
            ops[e.op] = ops.get(e.op, 0) + 1
    res["params"] = {n: _full(p, g) for n, p in model.named_parameters()}
    attn = model.llama.layers[0].self_attn  # the rank's heads
    res["heads"] = (attn.q_proj.weight.shape[1] // attn.head_dim,
                    attn.k_proj.weight.shape[1] // attn.head_dim)
    res["logits_shape"] = tuple(tp(x).shape)
    res["tp_axis"] = {n: (p.tp_axis, p.is_distributed, tuple(p.shape))
                      for n, p in model.named_parameters()}
    return res


class _OneRank:
    """A one-rank stand-in for an mp group (``nranks`` 1): the layer is
    built whole."""

    nranks = 1
    rank = 0
    device = torch.device("cpu")


# ---------------------------------------------------------------------------
# sequence parallelism


def sp_body(rank, world, case):
    """The four ops and the two linears at mp = world on ``[s, b, h]``
    activations, with and without the sequence-parallel hooks."""
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as SP
    from paddle_tpu_torch.utils import load_jax_params

    hcg = _fleet(1, world)
    g = hcg.get_model_parallel_group()
    res = {}
    x = case["x"]  # [s, b, h]
    s = x.shape[0] // world
    mine = slice(rank * s, (rank + 1) * s)
    c = torch.from_numpy(case["c"])

    xf = _leaf(x)
    out = SP.ScatterOp.apply(xf)
    (out * c[mine]).sum().backward()
    res["scatter"] = (out.detach().numpy(), xf.grad.numpy())
    xs = _leaf(x[mine])
    out = SP.GatherOp.apply(xs)
    (out * c).sum().backward()
    res["gather"] = (out.detach().numpy(), xs.grad.numpy())
    xs = _leaf(x[mine])
    out = SP.all_gather(xs)
    (out * c).sum().backward()
    res["all_gather"] = (out.detach().numpy(), xs.grad.numpy())
    xf = _leaf(x * (rank + 1))  # each rank's partial sum
    out = SP.reduce_scatter(xf)
    (out * c[mine]).sum().backward()
    res["reduce_scatter"] = (out.detach().numpy(), xf.grad.numpy())
    res["scatter_fn"] = SP.scatter(torch.from_numpy(x)).numpy()

    for hooks in (False, True):
        col = SP.ColumnSequenceParallelLinear(16, 32, has_bias=True,
                                              gather_output=False,
                                              device="cpu")
        row = SP.RowSequenceParallelLinear(32, 16, input_is_parallel=True,
                                           device="cpu")
        load_jax_params(col, case["col"])
        load_jax_params(row, case["row"])
        model = torch.nn.Sequential(col, row)
        handles = (SP.register_sequence_parallel_allreduce_hooks(model)
                   if hooks else [])
        xf = _leaf(x)
        y = SP.GatherOp.apply(model(SP.ScatterOp.apply(xf)))
        (y * c).sum().backward()
        res[f"linears_hooks{int(hooks)}"] = {
            "y": y.detach().numpy(), "dx": xf.grad.numpy(),
            "col.weight": _full_grad(col.weight, g),
            "col.bias": _full_grad(col.bias, g),
            "row.weight": _full_grad(row.weight, g),
            "row.bias": row.bias.grad.numpy().copy(),
            "n_hooks": len(handles),
            "sp_marked": bool(getattr(row.bias, "is_sequence_parallel", False)),
        }
    return res


def sharding_opt_body(rank, world, arrays, ids, labels, steps):
    """``fleet.init(sharding_degree=world)``, ``distributed_model`` and
    ``distributed_optimizer`` (which wraps ``DygraphShardingOptimizer``:
    stage 1 over the sharding group) around the Llama step, each rank on
    its part of the batch."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sharding_degree": world}
    fleet.init(strategy=s, device="cpu")
    model = fleet.distributed_model(_tiny(arrays))
    opt = fleet.distributed_optimizer(
        AdamW(learning_rate=1e-3, parameters=model.parameters()))
    b = ids.shape[0] // world
    x = torch.from_numpy(ids[rank * b:(rank + 1) * b])
    y = torch.from_numpy(labels[rank * b:(rank + 1) * b])
    losses = []
    for _ in range(steps):
        loss = model.loss(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return {"losses": losses, "inner": type(opt._inner_opt).__name__,
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()},
            "moment_shapes": {k: tuple(v.shape) for k, v in
                              opt._accumulators["moment1"].items()}}


# ---------------------------------------------------------------------------
# TensorParallel on GPT and BERT (the fused qkv cut in whole heads)


def _full_grouped(t: torch.Tensor, p: torch.Tensor, group) -> np.ndarray:
    """``t`` (a shard of ``p`` or of its gradient) whole: gathered along
    ``p``'s ``tp_axis`` and, for a fused qkv (``tp_groups`` parts, each
    cut alone), each rank's part put back in its place."""
    if not getattr(p, "is_distributed", False):
        return t.detach().numpy().copy()
    axis, groups = p.tp_axis, getattr(p, "tp_groups", 1)
    whole = _gather(t, group, axis)  # [rank 0's (q, k, v), rank 1's, ...]
    n = group.nranks
    parts = np.split(whole, n * groups, axis=axis)
    return np.concatenate([parts[r * groups + g] for g in range(groups)
                           for r in range(n)], axis=axis)


def tp_gpt_bert_body(rank, world, kind, arrays, ids, labels):
    """``TensorParallel`` at mp=world on the tiny GPT (``kind`` "gpt") or
    BERT MLM ("bert"), the reference's whole arrays loaded into the
    shards: the gathered logits, the loss through the vocab-sharded head,
    every parameter and gradient gathered whole, the local head counts,
    and whether the checkpoint's placement refuses the fused qkv shard."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.checkpoint import reshard
    from paddle_tpu_torch.models import (BertConfig, BertForMaskedLM,
                                         GPTConfig, GPTForCausalLM)
    from paddle_tpu_torch.utils import load_jax_params

    hcg = _fleet(1, world)
    g = hcg.get_model_parallel_group()
    if kind == "gpt":
        model = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
        qkv = model.transformer.h[0].attn.qkv_proj
    else:
        model = BertForMaskedLM(BertConfig.tiny(), device="cpu")
        qkv = model.bert.encoder[0].qkv
    tp = fleet.distributed_model(model)
    load_jax_params(model, arrays)
    res = {"loaded_equal": all(
        np.array_equal(_full_grouped(p, p, g), arrays[n])
        for n, p in model.named_parameters())}
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    res["logits"] = _gather(tp(x), g, -1)
    loss = tp.loss(x, y)
    loss.backward()
    res["loss"] = float(loss.detach())
    res["grads"] = {n: _full_grouped(p.grad, p, g)
                    for n, p in model.named_parameters()
                    if p.grad is not None}
    res["sharded"] = sorted(n for n, p in model.named_parameters()
                            if getattr(p, "is_distributed", False))
    res["qkv_local_cols"] = int(qkv.weight.shape[1])
    try:
        reshard.layer_placements(model)
        res["placement_refused"] = False
    except reshard.ReshardLayoutError:
        res["placement_refused"] = True
    return res
