"""Port parity: the distributed checkpoint (``distributed/checkpoint``: the
file format and the in-RAM reshard), ``distributed/io.py`` and
``fleet/utils/fs.py`` against the JAX package's.

- Reshard assembly, exact: the reference's payloads of a 2-way sharded
  state (split into two ranks' payloads) assemble in the port to the
  reference's own assembly; the port's payloads of :class:`Placed` shards
  assemble to the whole (bf16 through its bits); the coverage check and
  the layout error say what the reference's say.
- Across two gloo ranks (rank bodies in ``tests/torch_ckpt_ranks.py``):
  group-sharded stage 3 under a supervisor with sharded peer payloads;
  a fresh supervisor at world 1 resumes the cut through ``loads_combined``
  (``reshard_resumes == 1``) bitwise the ranks' gathered state, and
  ``load_state_dict`` at world 1 of the ranks' ``save_state_dict`` equals
  it too.
- ``save_state_dict``/``load_state_dict`` of whole tensors read the
  reference's files and the reference reads the port's (f32).
- ``LocalFS`` does what the reference's does; ``HDFSClient`` raises without
  a hadoop client, as the reference's.
"""
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jdcp
from paddle_tpu.distributed import io as jio
from paddle_tpu.distributed.checkpoint import reshard as jreshard
from paddle_tpu.distributed.fleet.utils import fs as jfs
from paddle_tpu_torch.distributed import checkpoint as tdcp
from paddle_tpu_torch.distributed import io as tio
from paddle_tpu_torch.distributed.checkpoint import reshard as treshard
from paddle_tpu_torch.distributed.fleet.utils import fs as tfs
from paddle_tpu_torch.distributed.store import FileKVStore
from paddle_tpu_torch.training import PeerReplicator, TrainingSupervisor

import torch_ckpt_ranks
from torch_dist_ranks import run_ranks


def _jax_sharded_state():
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from paddle_tpu.base.tensor import Tensor

    mesh = Mesh(np.array(jax.devices()[:2]), ("sharding",))
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    m = np.arange(8, dtype=np.float32) * 0.5
    state = {"step": 6, "optim": [{
        "moment1": Tensor(jax.device_put(
            w, NamedSharding(mesh, P("sharding", None))), _internal=True),
        "moment2": jax.device_put(m, NamedSharding(mesh, P("sharding")))}],
        "cursor": {"quarantined": [2]}}
    return state, w, m


def _split(payload, SHARD_TAG):
    """One payload's shard maps split into two ranks' payloads."""
    blob = pickle.loads(payload)

    def take(node, i):
        if isinstance(node, dict) and node.get(SHARD_TAG) == 1:
            offs = sorted(node["shards"])
            return {**node, "shards": {offs[i]: node["shards"][offs[i]]}}
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        if isinstance(node, list):
            return [take(v, i) for v in node]
        return node

    return [pickle.dumps({**blob, "state": take(blob["state"], i)})
            for i in (0, 1)]


def test_reference_payloads_assemble_as_in_the_reference():
    state, w, m = _jax_sharded_state()
    layout = {"world": 2, "mesh": {"sharding": 2}}
    parts = _split(jreshard.dumps_sharded(state, layout=layout),
                   jreshard._SHARD_TAG)
    assert treshard._SHARD_TAG == jreshard._SHARD_TAG
    target = {"world": 1, "mesh": {"sharding": 1}}
    got, saved = treshard.loads_combined(parts, target_layout=target)
    want, jsaved = jreshard.loads_combined(parts, target_layout=target)
    assert saved == jsaved == layout
    assert got["step"] == want["step"] == 6
    assert got["cursor"] == want["cursor"]
    np.testing.assert_array_equal(got["optim"][0]["moment1"].numpy(), w)
    np.testing.assert_array_equal(np.asarray(got["optim"][0]["moment2"]), m)
    assert [treshard.sharded_leaf_count(p) for p in parts] == \
        [jreshard.sharded_leaf_count(p) for p in parts] == [2, 2]
    errs = []
    for mod in (treshard, jreshard):
        with pytest.raises(ValueError) as ei:
            mod.loads_combined(parts[:1])
        errs.append(str(ei.value))
    assert errs[0] == errs[1] and "incomplete shard coverage" in errs[0]


def test_layout_error_names_both_layouts_as_the_reference():
    state, _, _ = _jax_sharded_state()
    saved = {"world": 1, "mesh": {"sharding": 2}}
    target = {"world": 1, "mesh": {"sharding": 3}}
    payload = jreshard.dumps_sharded(state, layout=saved)
    msgs = []
    for mod in (treshard, jreshard):
        with pytest.raises(mod.ReshardLayoutError) as ei:
            mod.loads_combined([payload], target_layout=target)
        assert isinstance(ei.value, ValueError)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and str(saved) in msgs[0] and \
        str(target) in msgs[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_placed_shards_assemble_to_the_whole(dtype):
    g = torch.Generator().manual_seed(0)
    whole = torch.randn(8, 6, generator=g).to(dtype)
    vec = torch.randn(8, generator=g).to(dtype)
    layout = {"world": 2, "mesh": {"sharding": 2}}
    payloads = []
    for r in (0, 1):
        sd = {"w": whole[4 * r:4 * r + 4].clone(), "v": vec[4 * r:4 * r + 4],
              "scalar": torch.tensor(2.5), "n": 3}
        placed = treshard.place(sd, {"w": ((8, 6), (4 * r, 0)),
                                     "v": ((8,), (4 * r,))})
        payloads.append(treshard.dumps_sharded({"model": [placed]}, layout))
    out, saved = treshard.loads_combined(payloads)
    got = out["model"][0]
    assert saved == layout
    assert got["w"].dtype == dtype and torch.equal(got["w"], whole)
    assert torch.equal(got["v"], vec)
    assert got["scalar"].shape == () and float(got["scalar"]) == 2.5
    assert got["n"] == 3
    with pytest.raises(ValueError, match="incomplete shard coverage"):
        treshard.loads_combined(payloads[1:])
    if dtype == torch.float32:  # the reference reads the port's f32 payloads
        jout, _ = jreshard.loads_combined(payloads)
        np.testing.assert_array_equal(
            np.asarray(jout["model"][0]["w"].numpy()), whole.numpy())
    with pytest.raises(ValueError, match="does not lie in"):
        treshard.Placed(torch.zeros(5, 6), (8, 6), (4, 0))


def test_file_checkpoint_roundtrips_and_crosses_packages(tmp_path):
    import paddle_tpu as paddle

    rng = np.random.RandomState(0)
    arrays = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    # the port writes, both packages read
    tdcp.save_state_dict({"m": {k: torch.from_numpy(v) for k, v in
                                arrays.items()}, "step": 7},
                         str(tmp_path / "t"))
    tgt = {"m": {k: torch.zeros(v.shape) for k, v in arrays.items()},
           "step": 0}
    tdcp.load_state_dict(tgt, str(tmp_path / "t"))
    assert tgt["step"] == 7
    for k, v in arrays.items():
        np.testing.assert_array_equal(tgt["m"][k].numpy(), v)
    jt = {"m": {k: paddle.zeros(list(v.shape)) for k, v in arrays.items()},
          "step": 0}
    jdcp.load_state_dict(jt, str(tmp_path / "t"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(jt["m"][k]._data), v)
    # the reference writes, the port reads
    jdcp.save_state_dict({"m": {k: paddle.to_tensor(v) for k, v in
                                arrays.items()}, "step": 9},
                         str(tmp_path / "j"))
    tgt = {"m": {k: torch.zeros(v.shape) for k, v in arrays.items()},
           "step": 0}
    tdcp.load_state_dict(tgt, str(tmp_path / "j"))
    assert tgt["step"] == 9
    for k, v in arrays.items():
        np.testing.assert_array_equal(tgt["m"][k].numpy(), v)
    with pytest.raises(KeyError, match="missing"):
        tdcp.load_state_dict({"m": {"zz": torch.zeros(1)}},
                             str(tmp_path / "t"))
    with pytest.raises(ValueError, match="shape mismatch"):
        tdcp.load_state_dict({"m": {"a": torch.zeros(3, 3)}},
                             str(tmp_path / "t"))
    with pytest.raises(FileNotFoundError):
        tdcp.load_state_dict({}, str(tmp_path / "none"))


def test_two_rank_shards_resume_and_load_at_world_one(tmp_path):
    """Stage 3 on two gloo ranks, then world 1 here: the peer tier's cut
    through ``loads_combined`` and the file checkpoint through
    ``load_state_dict`` both give the ranks' gathered state, bitwise."""
    from paddle_tpu_torch.testing.elastic_shard_worker import (batch_fn,
                                                               build_model)

    store_dir, save_dir = tmp_path / "store", tmp_path / "distcp"
    ranks = run_ranks(torch_ckpt_ranks.sharded_rig, 2, tmp_path,
                      args=(4, str(store_dir), str(save_dir)))
    assert ranks[0]["losses"] == ranks[1]["losses"]
    whole = ranks[0]["whole"]
    # the ranks' shards, concatenated in rank order, are the whole too
    for k, (t0, dim) in ranks[0]["local"].items():
        full = t0 if dim is None else torch.cat(
            [t0, ranks[1]["local"][k][0]], dim)
        if k in whole:
            assert torch.equal(full, whole[k]), k
        whole.setdefault(k, full)
    # the peer tier at world 1
    model, opt = build_model("cpu")
    sup = TrainingSupervisor(
        lambda b: 1.0, batch_fn, layers=[model], optimizers=[opt],
        peer=PeerReplicator(FileKVStore(str(store_dir)), 0, 1, tag="ck"),
        sharded_state=True, snapshot_interval=2,
        state_layout={"world": 1, "mesh": {"sharding": 1}})
    assert sup.peer.ranks() == [0, 1]
    assert sup.resume() == 5 and sup.reshard_resumes == 1
    got = {f"model.{k}": v for k, v in model.state_dict().items()}
    got.update({f"opt.{k}": v for k, v in opt.state_dict().items()
                if torch.is_tensor(v)})
    assert set(got) == set(whole)
    for k, v in whole.items():
        assert torch.equal(got[k], v), k
    assert opt._global_step == ranks[0]["global_step"]
    # the file checkpoint at world 1, into whole tensors
    target = {"model": {}, "opt": {}}
    for k, v in whole.items():
        part, _, key = k.partition(".")
        target[part][key] = torch.zeros_like(v)
    tdcp.load_state_dict(target, str(save_dir))
    for k, v in whole.items():
        part, _, key = k.partition(".")
        assert torch.equal(target[part][key], v), k
    # a layout no dimension divides is refused, naming both
    bad = {"world": 1, "mesh": {"sharding": 7}}
    sup2 = TrainingSupervisor(
        lambda b: 1.0, batch_fn, layers=[model], optimizers=[opt],
        peer=PeerReplicator(FileKVStore(str(store_dir)), 0, 1, tag="ck"),
        sharded_state=True, snapshot_interval=2, state_layout=bad)
    with pytest.raises(treshard.ReshardLayoutError) as ei:
        sup2.resume()
    assert str(bad) in str(ei.value) and "'sharding': 2" in str(ei.value)


def test_persistables_and_local_fs_match_reference(tmp_path):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.utils import load_jax_params

    paddle.seed(0)
    jm = jnn.Linear(4, 3)
    tm = Linear(4, 3, device="cpu", dtype=torch.float32)
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    tio.save_persistables(dirname=str(tmp_path / "p"), main_program=tm)
    jm2 = jnn.Linear(4, 3)
    jio.load_persistables(dirname=str(tmp_path / "p"), main_program=jm2)
    np.testing.assert_array_equal(np.asarray(jm2.weight._data),
                                  tm.weight.detach().numpy())
    tm2 = Linear(4, 3, device="cpu", dtype=torch.float32)
    tio.load_persistables(dirname=str(tmp_path / "p"), main_program=tm2)
    assert torch.equal(tm2.weight, tm.weight)
    assert tio.is_persistable(tm.weight) == jio.is_persistable(jm.weight)
    with pytest.raises(ValueError, match="Layer"):
        tio.save_persistables(dirname=str(tmp_path), main_program=None)

    def scen(fs_mod, root):
        fs = fs_mod.LocalFS()
        out = [fs.is_exist(str(root)), fs.need_upload_download()]
        fs.mkdirs(str(root / "a" / "b"))
        fs.touch(str(root / "a" / "f.txt"))
        with open(root / "a" / "f.txt", "w") as f:
            f.write("hello")
        out += [fs.ls_dir(str(root / "a")), fs.list_dirs(str(root)),
                fs.is_file(str(root / "a" / "f.txt")),
                fs.is_dir(str(root / "a")), fs.cat(str(root / "a" / "f.txt"))]
        with pytest.raises(fs_mod.ExecuteError):
            fs.touch(str(root / "a" / "f.txt"), exist_ok=False)
        fs.mv(str(root / "a" / "f.txt"), str(root / "a" / "g.txt"))
        with pytest.raises(fs_mod.ExecuteError):
            fs.mv(str(root / "a" / "b"), str(root / "a" / "g.txt"))
        fs.upload_dir(str(root / "a"), str(root / "c"))
        fs.delete(str(root / "a"))
        out += [fs.ls_dir(str(root)), fs.ls_dir(str(root / "c")),
                fs.ls_dir(str(root / "none"))]
        with pytest.raises(RuntimeError, match="hadoop"):
            fs_mod.HDFSClient(hadoop_home=str(root / "no-hadoop"))
        return out

    assert scen(tfs, tmp_path / "t") == scen(jfs, tmp_path / "j")
