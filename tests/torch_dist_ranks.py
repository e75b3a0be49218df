"""Rank processes for the port's multi-process CPU tests.

:func:`run_ranks` starts ``world`` processes with
``paddle_tpu_torch.distributed.spawn``; each joins a gloo world over a
``FileStore`` under the test's ``tmp_path`` (no port to collide with under
xdist), runs one rank body of this module with ``torch.set_num_threads(1)``
and saves what it returns; a rank that raises writes its traceback. Every
run has a timeout: on expiry the ranks are killed and the test fails, so a
collective that one rank never reaches cannot hang the suite.

This module imports torch and the port only (the children start from a
fresh import).
"""
from __future__ import annotations

import importlib
import os
import time
import traceback

import numpy as np
import torch

RANK_TIMEOUT_S = 120.0


def run_ranks(body, world: int, tmp_path, args=(), timeout: float = RANK_TIMEOUT_S,
              expect_exit=None):
    """Run ``body(rank, world, *args)`` on ``world`` gloo ranks; returns
    the ranks' results in rank order. ``expect_exit``: the exit codes the
    ranks must end with (default all 0; results are then not read)."""
    from paddle_tpu_torch.distributed import spawn

    out = tmp_path / f"ranks-{body.__name__}-{world}"
    out.mkdir()
    procs = spawn(_rank_main, args=(body.__module__, body.__name__,
                                    str(out / "store"), str(out), tuple(args)),
                  nprocs=world, join=False)
    end = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = "\n".join(f"--- rank {r} ---\n{(out / f'rank{r}.err').read_text()}"
                     for r in range(world) if (out / f"rank{r}.err").exists())
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s\n{errs}")
    codes = [p.exitcode for p in procs]
    if expect_exit is not None:
        assert codes == list(expect_exit), (codes, errs)
        return out
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}\n{errs}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(module, name, store, out, args):
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    os.environ["RANK_OUT_DIR"] = out
    try:
        body = getattr(importlib.import_module(module), name)
        from paddle_tpu_torch.distributed import (destroy_process_group,
                                                  init_parallel_env)

        init_parallel_env("cpu", init_method=f"file://{store}")
        res = body(rank, world, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
        # the process groups go down here, while the interpreter is whole,
        # and an error in their teardown fails the rank like any other
        destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


# ---------------------------------------------------------------------------
# inputs, made from a seed with numpy: the same arrays feed the reference


def collective_inputs(world: int, seed: int = 0) -> dict:
    """Per-rank arrays for every collective (``[world, ...]``)."""
    rng = np.random.RandomState(seed)
    n = 4 * world
    return {
        "f": rng.randn(world, n, 3).astype(np.float32),
        "i": rng.randint(-50, 50, (world, n, 3)).astype(np.int64),
        "list": rng.randn(world, world, 2, 3).astype(np.float32),
    }


def collectives_body(rank: int, world: int, seed: int) -> dict:
    """Every collective of the port on this rank's inputs; numpy results."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import ReduceOp
    from paddle_tpu_torch.distributed.communication import stream

    x = collective_inputs(world, seed)
    f = torch.from_numpy(x["f"][rank])
    i = torch.from_numpy(x["i"][rank])
    res = {}
    for op, name in ((ReduceOp.SUM, "sum"), (ReduceOp.MAX, "max"),
                     (ReduceOp.MIN, "min"), (ReduceOp.PROD, "prod"),
                     (ReduceOp.AVG, "avg")):
        t = f.clone()
        assert dist.all_reduce(t, op) is None
        res[f"all_reduce_{name}"] = t.numpy()
        t = i.clone()
        if op != ReduceOp.AVG:
            dist.all_reduce(t, op)
            res[f"all_reduce_{name}_int"] = t.numpy()
    t = f.clone()
    task = dist.all_reduce(t, sync_op=False)
    task.wait()
    res["all_reduce_async"] = t.numpy()
    lst = []
    dist.all_gather(lst, i)
    res["all_gather"] = np.stack([a.numpy() for a in lst])
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "v": [rank] * 3})
    res["all_gather_object"] = objs
    out = torch.empty(world * f.shape[0], 3)
    dist.all_gather_into_tensor(out, f)
    res["all_gather_into_tensor"] = out.numpy()
    out1 = torch.empty(f.shape[0], 3 * world)
    dist.all_gather_into_tensor(out1, f, axis=1)
    res["all_gather_into_tensor_axis1"] = out1.numpy()
    t = f.clone()
    dist.reduce(t, dst=world - 1)
    res["reduce"] = t.numpy()
    t = i.clone()
    dist.broadcast(t, src=1)
    res["broadcast"] = t.numpy()
    t = torch.empty(f.shape[0] // world, 3)
    dist.reduce_scatter(t, f.clone())
    res["reduce_scatter"] = t.numpy()
    t = torch.empty(f.shape[0] // world, 3, dtype=torch.int64)
    dist.reduce_scatter(t, list(i.clone().chunk(world, 0)), op=ReduceOp.MAX)
    res["reduce_scatter_max_list"] = t.numpy()
    t = torch.empty(2, 3)
    parts = list(torch.from_numpy(x["list"][0]))
    dist.scatter(t, parts if rank == 0 else None, src=0)
    res["scatter"] = t.numpy()
    gl = []
    dist.gather(i, gl, dst=0)
    res["gather"] = np.stack([a.numpy() for a in gl])
    outs = []
    dist.alltoall(outs, list(torch.from_numpy(x["list"][rank])))
    res["alltoall"] = np.stack([a.numpy() for a in outs])
    t = torch.empty_like(f)
    dist.alltoall_single(t, f.clone())
    res["alltoall_single"] = t.numpy()
    res["p2p_sendrecv"] = dist.p2p_sendrecv(f, src=0, dst=world - 1).numpy()
    perm = [(r, (r + 1) % world) for r in range(world)]
    res["ppermute_ring"] = dist.ppermute(i, perm).numpy()
    res["ppermute_partial"] = dist.ppermute(f, [(0, 1)]).numpy()
    res["rank_in_trace"] = dist.get_rank_in_trace()
    # point to point: the ring's right neighbour, sync and async
    right, left = (rank + 1) % world, (rank - 1) % world
    got = torch.empty_like(i)
    if rank % 2 == 0:
        dist.send(i, dst=right)
        dist.recv(got, src=left)
    else:
        dist.recv(got, src=left)
        dist.send(i, dst=right)
    res["send_recv"] = got.numpy()
    got2 = torch.empty_like(f)
    works = [dist.isend(f, dst=right), dist.irecv(got2, src=left)]
    for w in works:
        w.wait()
    res["isend_irecv"] = got2.numpy()
    objs = [None, None]
    if rank == 0:
        objs = [{"a": 1}, "two"]
    dist.broadcast_object_list(objs, src=0)
    res["broadcast_object_list"] = objs
    out_o = []
    dist.scatter_object_list(out_o, [f"obj{r}" for r in range(world)]
                             if rank == 0 else None, src=0)
    res["scatter_object_list"] = out_o
    # the stream variants are the plain collectives
    t = f.clone()
    stream.all_reduce(t, use_calc_stream=True)
    res["stream_all_reduce"] = t.numpy()
    lst = []
    stream.all_gather(lst, i, use_calc_stream=True)
    res["stream_all_gather"] = np.stack([a.numpy() for a in lst])
    # the multi-controller eager API: host numpy in, host numpy out
    from paddle_tpu_torch.distributed import multi_controller as mc

    res["mc_active"] = mc.active()
    res["mc_all_reduce"] = mc.eager_all_reduce(x["f"][rank], "avg")
    res["mc_all_gather"] = mc.eager_all_gather(x["i"][rank])
    res["mc_broadcast"] = mc.eager_broadcast(x["i"][rank], 1)
    res["mc_ppermute"] = mc.eager_ppermute(x["i"][rank], perm)
    res["mc_p2p"] = mc.eager_p2p(x["f"][rank], 0, world - 1)
    if rank == 0:
        mc.eager_send(x["i"][0], dst=world - 1)
    elif rank == world - 1:
        res["mc_recv"] = mc.eager_recv(0, like=x["i"][rank], deadline=60.0)
    res["mc_objects"] = mc.eager_all_gather_object({"r": rank})
    dist.barrier()
    res["backend"] = dist.get_backend()
    res["world"] = (dist.get_world_size(), dist.get_rank())
    from paddle_tpu_torch.distributed.communication import flight_recorder

    res["recorded"] = [s.op for s in flight_recorder.recorder().snapshot()]
    return res


# ---------------------------------------------------------------------------
# data parallelism and group sharding on LlamaConfig.tiny() in f32


def _tiny_model(arrays):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.utils import load_jax_params

    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(model, arrays)
    return model


def _step_body(model, opt):
    from paddle_tpu_torch.nn import functional as F

    def step(ids, labels):
        logits = model(ids)
        b, s, v = logits.shape
        loss = F.cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return step


def _local(rank, world, a):
    b = a.shape[0] // world
    return torch.from_numpy(a[rank * b:(rank + 1) * b])


def dp_body(rank, world, arrays, ids, labels, steps):
    """``DataParallel`` steps on this rank's part of the global batch, then
    ``no_sync`` accumulation and ``to_static`` under gloo."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed import DataParallel, all_gather
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.testing.capture import cpu_capture

    res = {}
    model = _tiny_model(arrays)
    dp = DataParallel(model, comm_buffer_size=1, last_comm_buffer_size=0.01)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(), fused=True)
    step = _step_body(dp, opt)
    x, y = _local(rank, world, ids), _local(rank, world, labels)
    res["losses"] = [float(step(x, y)) for _ in range(steps)]
    res["params"] = {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}
    res["buckets"] = len(dp._buckets)
    res["syncs"] = dp.n_syncs

    # no_sync: the first micro-batch's gradients stay local, the second
    # backward averages the sums
    m2 = _tiny_model(arrays)
    dp2 = DataParallel(m2)
    half = x.shape[0] // 2 or 1
    with dp2.no_sync():
        m2.loss(x[:half], y[:half]).backward()
    res["nosync_local"] = {n: p.grad.detach().clone()
                           for n, p in m2.named_parameters()}
    m2.loss(x[half:], y[half:]).backward()
    res["nosync_synced"] = {n: p.grad.detach().numpy().copy()
                            for n, p in m2.named_parameters()}
    m3 = _tiny_model(arrays)
    m3.loss(x[:half], y[:half]).backward()
    m3.loss(x[half:], y[half:]).backward()
    expect = {}
    for n, p in m3.named_parameters():
        rows = []
        all_gather(rows, p.grad.detach())
        expect[n] = (sum(rows) / world).numpy()
    res["nosync_expect"] = expect
    res["nosync_local"] = {n: g.numpy() for n, g in res["nosync_local"].items()}

    # to_static over a data-parallel step: gloo's all-reduce is a host
    # operation, so a capture meets a graph break
    m4 = _tiny_model(arrays)
    dp4 = DataParallel(m4)
    opt4 = AdamW(learning_rate=1e-3, parameters=m4.parameters(), fused=True)
    with cpu_capture():
        sf = jit.to_static(_step_body(dp4, opt4), layers=[m4],
                           optimizers=[opt4])
        sf(x, y)  # the eager warm-up
        try:
            sf(x, y)
            res["full_graph"] = "no error"
        except jit.GraphBreakError as e:
            res["full_graph"] = f"GraphBreakError: {e}"
    # full_graph=False: the split finds the carried loss needs its graph,
    # so the step runs eagerly from then on, and says so
    import warnings

    m5 = _tiny_model(arrays)
    dp5 = DataParallel(m5)
    opt5 = AdamW(learning_rate=1e-3, parameters=m5.parameters(), fused=True)
    with warnings.catch_warnings(record=True) as caught, cpu_capture():
        warnings.simplefilter("always")
        sf = jit.to_static(_step_body(dp5, opt5), layers=[m5],
                           optimizers=[opt5], full_graph=False)
        res["piecewise_losses"] = [float(sf(x, y)) for _ in range(steps + 1)]
    res["piecewise_warnings"] = [str(w.message) for w in caught]
    return res


def shard_body(rank, world, arrays, ids, labels, steps, levels):
    """Per level (and ``"dp"``, ``DataParallel`` as the baseline): the
    global losses' parts, the whole parameters after the steps, and the
    shapes this rank keeps between steps."""
    from paddle_tpu_torch.distributed import (DataParallel,
                                              group_sharded_parallel)
    from paddle_tpu_torch.optimizer import AdamW

    x, y = _local(rank, world, ids), _local(rank, world, labels)
    out = {}
    for level in ("dp", *levels):
        model = _tiny_model(arrays)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    fused=True)
        if level == "dp":
            wrapped = DataParallel(model)
        else:
            wrapped, opt, _ = group_sharded_parallel(model, opt, level)
        step = _step_body(wrapped, opt)
        losses = [float(step(x, y)) for _ in range(steps)]
        if level == "dp":
            params = {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()}
        else:
            params = {n: t.detach().numpy().copy()
                      for n, t in model._group_sharded.full_state().items()}
        out[level] = {
            "losses": losses, "params": params,
            "param_shapes": {n: tuple(p.shape)
                             for n, p in model.named_parameters()},
            "moment_shapes": {k: tuple(v.shape) for k, v in
                              opt._accumulators.get("moment1", {}).items()},
        }
    return out


# ---------------------------------------------------------------------------
# the rank-aware RNG and the watchdog


def rng_body(rank, world, seed):
    """Draws from the tracker's branches and the salt stream after
    ``model_parallel_random_seed(seed, rank)``."""
    from paddle_tpu_torch import seed as pt_seed
    from paddle_tpu_torch.base import random as R

    pt_seed(seed)
    R.model_parallel_random_seed(seed, tp_rank=rank)
    tracker = R.get_rng_state_tracker()
    out = {}
    for name in (tracker.GLOBAL, tracker.LOCAL):
        with tracker.rng_state(name):
            out[name] = torch.rand(8, generator=R.get_generator("cpu")).numpy()
    out["salts"] = R.sr_salts("cpu", 4).numpy()
    out["default"] = torch.rand(8, generator=R.get_generator("cpu")).numpy()
    return out


def watchdog_body(rank, world, timeout_s):
    """Rank 0 waits in a barrier rank 1 never reaches: the watchdog's
    ladder (warn, dump, abort) runs on rank 0's stderr, which this body
    sends to ``<out>/rank0.stderr``; rank 1 outlives the abort, then
    exits."""
    from paddle_tpu_torch.base import flags
    from paddle_tpu_torch.distributed import all_reduce, barrier

    t = torch.ones(2)
    all_reduce(t)  # a recorded collective before the hang
    if rank == 1:
        time.sleep(timeout_s * 2 + 2.0)
        return {}
    out = os.environ["RANK_OUT_DIR"]
    fd = os.open(os.path.join(out, "rank0.stderr"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)
    flags.set_flags({"comm_timeout_s": timeout_s})
    barrier()
    return {}


def exit_on_rank1(out_dir):
    """A ``spawn`` target: writes the rank environment it was given, and
    rank 1 exits 5."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "PADDLE_TRAINER_ID",
            "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK", "MASTER_ADDR",
            "MASTER_PORT")
    with open(os.path.join(out_dir, f"env{os.environ['RANK']}.txt"), "w") as f:
        f.write(" ".join(f"{k}={os.environ.get(k)}" for k in keys))
    if os.environ["RANK"] == "1":
        raise SystemExit(5)
