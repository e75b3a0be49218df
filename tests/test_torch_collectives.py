"""Port parity: the collectives of ``paddle_tpu_torch.distributed`` (gloo
ranks in processes) against the JAX package's traced collectives
(``paddle_tpu.distributed.shard_map`` over 2 and 4 devices of the virtual
8-device CPU mesh ``tests/conftest.py`` sets up).

The same per-rank arrays, made from a seed with numpy, feed both: the port
runs every collective once per rank in a world of 2 and of 4 processes
(one battery per world size, ``torch_dist_ranks.collectives_body``); the
reference maps each collective over a ``("x", world)`` mesh, rank r's
array being shard r. Held bitwise: integer results, max/min, gathers,
broadcast, scatter, all-to-all and the permutations; f32 sums and
averages to 1e-6. The eager-only calls (send/recv, isend/irecv, the object
lists, barrier) are held against what the contract says they deliver.
"""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import communication as jcomm
from paddle_tpu.distributed.collective import Group as JGroup
from paddle_tpu.distributed.collective import ReduceOp as JOp

import torch_dist_ranks as R

WORLDS = (2, 4)
SEED = 3
F32_TOL = 1e-6


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: [rank results]}: one battery per world size."""
    return {w: R.run_ranks(R.collectives_body, w,
                           tmp_path_factory.mktemp(f"coll{w}"), args=(SEED,))
            for w in WORLDS}


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("x",)), JGroup(
        list(range(world)), "x")


def ref_map(world, fn, *per_rank):
    """The reference's traced collective: ``fn(group, *shards)`` over a
    ``("x", world)`` mesh, each rank's array concatenated along axis 0 and
    rank r's output returned as element r."""
    mesh, g = _mesh(world)
    g.mesh = mesh
    arrays = [np.concatenate(list(a), 0) for a in per_rank]
    call = jdist.shard_map(lambda *ts: fn(g, *ts), mesh=mesh,
                           in_specs=tuple(P("x") for _ in arrays),
                           out_specs=P("x"))
    out = np.asarray(call(*arrays)._data)
    return np.split(out, world, 0)


def _inplace(op_fn):
    def run(g, t):
        op_fn(t, g)
        return t
    return run


def _check(world, port, key, want, exact):
    for r in range(world):
        got = port[world][r][key]
        w = np.asarray(want[r]).reshape(got.shape)
        if exact:
            np.testing.assert_array_equal(got, w, err_msg=f"{key} rank {r}")
        else:
            np.testing.assert_allclose(got, w, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,op", [("sum", JOp.SUM), ("max", JOp.MAX),
                                     ("min", JOp.MIN), ("prod", JOp.PROD),
                                     ("avg", JOp.AVG)])
def test_all_reduce(port, world, name, op):
    x = R.collective_inputs(world, SEED)
    want = ref_map(world, _inplace(lambda t, g: jcomm.all_reduce(t, op, group=g)),
                   x["f"])
    _check(world, port, f"all_reduce_{name}", want,
           exact=name in ("max", "min"))
    if name != "avg":
        want = ref_map(world, _inplace(
            lambda t, g: jcomm.all_reduce(t, op, group=g)), x["i"])
        _check(world, port, f"all_reduce_{name}_int", want, exact=True)
    if name == "sum":
        _check(world, port, "all_reduce_async",
               ref_map(world, _inplace(lambda t, g: jcomm.all_reduce(
                   t, group=g)), x["f"]), exact=False)
        _check(world, port, "stream_all_reduce",
               ref_map(world, _inplace(lambda t, g: jcomm.all_reduce(
                   t, group=g)), x["f"]), exact=False)


@pytest.mark.parametrize("world", WORLDS)
def test_gathers(port, world):
    import paddle_tpu as paddle

    x = R.collective_inputs(world, SEED)

    def gather_list(g, t):
        lst = []
        jcomm.all_gather(lst, t, group=g)
        return paddle.stack(lst)

    want = ref_map(world, gather_list, x["i"])
    _check(world, port, "all_gather", want, exact=True)
    _check(world, port, "stream_all_gather", want, exact=True)
    _check(world, port, "gather", ref_map(
        world, lambda g, t: jcomm.gather(t, dst=0, group=g), x["i"]),
        exact=True)

    def into(axis):
        def run(g, t):
            shape = list(t.shape)
            shape[axis] *= world
            out = paddle.zeros(shape, dtype="float32")
            jcomm.all_gather_into_tensor(out, t, group=g, axis=axis)
            return out
        return run

    _check(world, port, "all_gather_into_tensor",
           ref_map(world, into(0), x["f"]), exact=True)
    _check(world, port, "all_gather_into_tensor_axis1",
           ref_map(world, into(1), x["f"]), exact=True)


@pytest.mark.parametrize("world", WORLDS)
def test_rooted_collectives(port, world):
    x = R.collective_inputs(world, SEED)
    _check(world, port, "reduce", ref_map(world, _inplace(
        lambda t, g: jcomm.reduce(t, dst=world - 1, group=g)), x["f"]),
        exact=False)
    _check(world, port, "broadcast", ref_map(world, _inplace(
        lambda t, g: jcomm.broadcast(t, src=1, group=g)), x["i"]), exact=True)

    def scatter(g, lst):
        import paddle_tpu as paddle

        out = paddle.zeros([2, 3], dtype="float32")
        jcomm.scatter(out, [lst[j] for j in range(world)], src=0, group=g)
        return out

    _check(world, port, "scatter", ref_map(world, scatter, x["list"]),
           exact=True)


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter(port, world):
    import paddle_tpu as paddle

    x = R.collective_inputs(world, SEED)
    n = x["f"].shape[1] // world

    def rs(g, t):
        out = paddle.zeros([n, 3], dtype="float32")
        jcomm.reduce_scatter(out, t, group=g)
        return out

    _check(world, port, "reduce_scatter", ref_map(world, rs, x["f"]),
           exact=False)

    def rs_max(g, t):
        out = paddle.zeros([n, 3], dtype="int64")
        parts = [t[j * n:(j + 1) * n] for j in range(world)]
        jcomm.reduce_scatter(out, parts, op=JOp.MAX, group=g)
        return out

    _check(world, port, "reduce_scatter_max_list", ref_map(world, rs_max,
                                                          x["i"]), exact=True)


@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_and_permutations(port, world):
    import paddle_tpu as paddle

    x = R.collective_inputs(world, SEED)

    def a2a(g, lst):
        out = []
        jcomm.alltoall(out, [lst[j] for j in range(world)], group=g)
        return paddle.stack(out)

    _check(world, port, "alltoall", ref_map(world, a2a, x["list"]),
           exact=True)

    def a2a_single(g, t):
        out = paddle.zeros(list(t.shape), dtype="float32")
        jcomm.alltoall_single(out, t, group=g)
        return out

    _check(world, port, "alltoall_single", ref_map(world, a2a_single, x["f"]),
           exact=True)
    _check(world, port, "p2p_sendrecv", ref_map(
        world, lambda g, t: jcomm.p2p_sendrecv(t, 0, world - 1, group=g),
        x["f"]), exact=True)
    ring = [(r, (r + 1) % world) for r in range(world)]
    _check(world, port, "ppermute_ring", ref_map(
        world, lambda g, t: jcomm.ppermute(t, ring, group=g), x["i"]),
        exact=True)
    _check(world, port, "ppermute_partial", ref_map(
        world, lambda g, t: jcomm.ppermute(t, [(0, 1)], group=g), x["f"]),
        exact=True)
    mesh, g = _mesh(world)
    ranks = jdist.shard_map(
        lambda t: t * 0 + jcomm.get_rank_in_trace(g), mesh=mesh,
        in_specs=(P("x"),), out_specs=P("x"))(np.zeros(world, np.int32))
    assert [port[world][r]["rank_in_trace"] for r in range(world)] == \
        np.asarray(ranks._data).tolist()


@pytest.mark.parametrize("world", WORLDS)
def test_eager_only_calls_deliver_what_the_contract_says(port, world):
    x = R.collective_inputs(world, SEED)
    for r in range(world):
        res = port[world][r]
        left = (r - 1) % world
        np.testing.assert_array_equal(res["send_recv"], x["i"][left])
        np.testing.assert_array_equal(res["isend_irecv"], x["f"][left])
        assert res["all_gather_object"] == [{"rank": k, "v": [k] * 3}
                                            for k in range(world)]
        assert res["broadcast_object_list"] == [{"a": 1}, "two"]
        assert res["scatter_object_list"] == [f"obj{r}"]
        assert res["backend"] == "GLOO" and res["world"] == (world, r)
    # every rank recorded the same schedule of collectives, send/recv aside
    recorded = [[op for op in port[world][r]["recorded"]
                 if op not in ("send", "recv")] for r in range(world)]
    assert all(rec == recorded[0] for rec in recorded)
    assert "barrier" in recorded[0] and "all_reduce[prod]" in recorded[0]


@pytest.mark.parametrize("world", WORLDS)
def test_multi_controller_eager_api(port, world):
    """``multi_controller``'s eager collectives take and return host numpy,
    with the reference's shapes: gathers and permutations come back as
    ``[nproc, ...]`` views, every process's slot."""
    x = R.collective_inputs(world, SEED)
    moved = np.stack([x["i"][(k - 1) % world] for k in range(world)])
    p2p = np.zeros_like(x["f"])
    p2p[world - 1] = x["f"][0]
    for r in range(world):
        res = port[world][r]
        assert res["mc_active"]
        np.testing.assert_allclose(res["mc_all_reduce"], x["f"].mean(0),
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(res["mc_all_gather"], x["i"])
        np.testing.assert_array_equal(res["mc_broadcast"], x["i"][1])
        np.testing.assert_array_equal(res["mc_ppermute"], moved)
        np.testing.assert_array_equal(res["mc_p2p"], p2p)
        assert res["mc_objects"] == [{"r": k} for k in range(world)]
    np.testing.assert_array_equal(port[world][world - 1]["mc_recv"],
                                  x["i"][0])


def test_the_package_exports_the_references_collectives():
    import paddle_tpu_torch.distributed as tdist

    names = ["all_gather", "all_gather_into_tensor", "all_gather_object",
             "all_reduce", "alltoall", "alltoall_single", "barrier",
             "broadcast", "get_rank_in_trace", "p2p_sendrecv", "ppermute",
             "recv", "reduce", "reduce_scatter", "scatter", "send", "gather",
             "scatter_object_list", "broadcast_object_list", "wait", "isend",
             "irecv", "is_available", "get_backend", "ParallelMode",
             "ReduceType", "gloo_init_parallel_env", "gloo_barrier",
             "gloo_release", "Group", "ReduceOp", "new_group", "get_group",
             "is_initialized", "destroy_process_group", "DataParallel",
             "ParallelEnv", "get_rank", "get_world_size",
             "init_parallel_env", "shard_map", "group_sharded_parallel",
             "save_group_sharded_model", "spawn", "launch"]
    for n in names:
        assert hasattr(jdist, n), n
        assert hasattr(tdist, n), n
    with pytest.raises(NotImplementedError, match="no mesh"):
        tdist.shard_map(lambda t: t)
