"""Port parity: the hybrid topology and the fleet front of
``paddle_tpu_torch.distributed.fleet`` against the JAX package's.

Held: ``CommunicateTopology``'s answers (``get_comm_list``,
``get_axis_list``, ``get_rank``, ``get_coord``, ``get_rank_from_stage``,
``world_size``) equal the reference's exactly over several ``dims``; at 4
gloo ranks (dp=2, mp=2) each rank's groups are the ranks the reference's
topology lists for its coordinate, its rank getters give its own
coordinates, and a collective over the mp or dp group reaches only those
peers; ``DistributedStrategy``'s ``hybrid_configs`` merge; the role makers
read rank and size from the launcher's environment (and from
``torch.distributed`` in a rank), as the reference's read the environment;
the data generators' output equals the reference's byte for byte.
"""
import io
import itertools
import sys

import numpy as np
import pytest

from paddle_tpu.distributed.fleet.base import role_maker as jroles
from paddle_tpu.distributed.fleet.base.distributed_strategy import \
    DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet.base.topology import \
    CommunicateTopology as JTopo

from paddle_tpu_torch.distributed.fleet.base import role_maker as troles
from paddle_tpu_torch.distributed.fleet.base.distributed_strategy import \
    DistributedStrategy as TStrategy
from paddle_tpu_torch.distributed.fleet.base.topology import \
    CommunicateTopology as TTopo

import torch_dist_ranks as R
import torch_tp_ranks as T

AXES = ["dp", "pp", "sharding", "sep", "mp"]
DIMS = [(1, 1, 1, 1, 1), (2, 1, 1, 1, 2), (2, 2, 1, 1, 2), (1, 2, 2, 1, 2),
        (3, 1, 2, 1, 1), (2, 1, 1, 2, 2)]


def _answers(topo, dims):
    out = {"world": topo.world_size(),
           "names": topo.get_hybrid_group_names()}
    for ax, d in zip(AXES, dims):
        out[f"comm/{ax}"] = topo.get_comm_list(ax)
        out[f"dim/{ax}"] = (topo.get_dim(ax), topo.get_dim_size(ax))
        for i in range(d):
            out[f"axis/{ax}/{i}"] = topo.get_axis_list(ax, i)
    for r in range(topo.world_size()):
        coord = topo.get_coord(r)
        out[f"coord/{r}"] = tuple(coord)
        out[f"rank/{r}"] = topo.get_rank(**dict(zip(AXES, coord)))
        for ax, d in zip(AXES, dims):
            for i in range(d):
                out[f"stage/{r}/{ax}/{i}"] = topo.get_rank_from_stage(
                    r, **{ax: i})
    return out


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_topology_answers_equal_the_reference(dims):
    assert _answers(TTopo(AXES, dims), dims) == _answers(JTopo(AXES, dims), dims)


def test_custom_order():
    order = ["mp", "dp"]
    for dims in ((2, 3), (4, 1)):
        t, j = TTopo(order, dims), JTopo(order, dims)
        assert [t.get_comm_list(a) for a in order] == \
            [j.get_comm_list(a) for a in order]
        assert t.coordinate == j.coordinate


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.run_ranks(T.topology_body, 4, tmp_path_factory.mktemp("topo"),
                       args=(2, 2))


def test_groups_and_coordinates_at_dp2_mp2(ranks):
    ref = JTopo(AXES, (2, 1, 1, 1, 2))

    def group_of(axis, r):
        return next(g for g in ref.get_comm_list(axis) if r in g)

    for r, res in enumerate(ranks):
        coord = dict(zip(AXES, ref.get_coord(r)))
        assert res["global_rank"] == r
        assert res["dp"] == (coord["dp"], 2, group_of("dp", r))
        assert res["mp"] == (coord["mp"], 2, group_of("mp", r))
        assert res["pp"] == (0, [r]) and res["sharding"] == (0, [r])
        assert res["sep"] == (0, [r])
        # pp x mp: the ranks sharing this rank's dp coordinate
        assert res["check"] == res["check_sharding"] == group_of("mp", r)
        assert res["dp_sep"] == group_of("dp", r)
        assert res["mp_sum"] == sum(group_of("mp", r))
        assert res["dp_sum"] == sum(group_of("dp", r))
        assert res["fleet"] == (r, 4, r) and res["role"] == (r, 4)


def test_util_base_on_the_live_group(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["util_sum"], [6.0, 4.0])
        np.testing.assert_array_equal(res["util_max"], [3])
        assert res["util_gather"] == [{"r": i} for i in range(4)]
        want = [["f0", "f1"], ["f2", "f3"], ["f4", "f5"], ["f6"]][r]
        assert res["file_shard"] == want


def test_strategy_merges_hybrid_configs():
    outs = []
    for cls in (TStrategy, JStrategy):
        s = cls()
        s.hybrid_configs = {"mp_degree": 2}
        s.hybrid_configs = {"dp_degree": 4, "order": ["mp", "dp"]}
        s.recompute = True
        outs.append((dict(s.hybrid_configs), s.recompute,
                     s.pipeline_configs, repr(s)))
    assert outs[0] == outs[1]
    assert outs[0][0]["mp_degree"] == 2 and outs[0][0]["dp_degree"] == 4


def test_role_makers_from_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    for mod in (troles, jroles):
        pc = mod.PaddleCloudRoleMaker()
        assert (pc.worker_index(), pc.worker_num()) == (3, 8)
        assert pc.is_worker() and not pc.is_server()
        ud = mod.UserDefinedRoleMaker(current_id=1, worker_num=2,
                                      role=mod.Role.SERVER)
        assert (ud.worker_index(), ud.worker_num(), ud._role()) == \
            (1, 2, mod.Role.SERVER)
        f = mod.Fleet()
        f._role_maker = pc
        assert (f.worker_index(), f.worker_num(), f.is_first_worker()) == \
            (3, 8, False)
    assert [getattr(troles.Role, n) for n in ("WORKER", "SERVER", "ALL")] == \
        [getattr(jroles.Role, n) for n in ("WORKER", "SERVER", "ALL")]


def _generators(mod):
    class Slots(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def gen():
                nums = [int(v) for v in line.split()]
                yield [("ids", nums), ("len", [len(nums)])]
                yield [("first", nums[:1])]
            return gen

    class Words(mod.MultiSlotStringDataGenerator):
        def generate_sample(self, line):
            return iter([[("words", line.split()), ("tag", ["x"])]])

    return Slots(), Words()


def test_data_generators_bytes_equal_the_reference(tmp_path, monkeypatch):
    path = tmp_path / "data.txt"
    path.write_text("1 2 3\n40 5\n\n7\n")
    outs = []
    for mod in (troles, jroles):
        slots, words = _generators(mod)
        lines = list(slots.run_from_files([str(path)]))
        lines += list(words.run_from_files([str(path)]))
        stdout = io.StringIO()
        monkeypatch.setattr(sys, "stdin", io.StringIO(path.read_text()))
        monkeypatch.setattr(sys, "stdout", stdout)
        slots.run_from_stdin()
        monkeypatch.undo()
        outs.append(("\n".join(lines) + "\n" + stdout.getvalue()).encode())
    assert outs[0] == outs[1]
    assert outs[0].startswith(b"3 1 2 3 1 3\n1 1\n")
    with pytest.raises(NotImplementedError):
        troles.MultiSlotDataGenerator().generate_sample("1")


def test_every_group_is_built_in_one_order():
    """The fused lists (check, sharding check, dp_sep) partition the ranks
    as the reference's axes do."""
    t = TTopo(AXES, (2, 2, 1, 1, 2))
    for axes in (("pp", "mp"), ("pp", "sharding", "mp"), ("dp", "sep")):
        lists = t.get_fused_comm_list(axes)
        assert sorted(itertools.chain(*lists)) == list(range(8))
        for g in lists:
            coords = [t.get_coord(r) for r in g]
            fixed = [i for i, a in enumerate(AXES) if a not in axes]
            assert len({tuple(c[i] for i in fixed) for c in coords}) == 1
