"""Port parity: ``paddle_tpu_torch.save`` / ``load`` (``framework/io.py``)
against ``paddle_tpu.save`` / ``load``.

Nested state round trips within the port, and files crossing the packages in
both directions: f32 (and integer) tensors as they are, bf16 through the raw
``uint16`` form (the port writes the bits with ``"dtype": "bfloat16"`` in
the tag; it reads the reference's ``ml_dtypes`` arrays through their bits).
Values compare exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import io as tio


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.randn(3, 4).astype(np.float32),
        "steps": np.arange(5, dtype=np.int64),
        "nested": {"m": [rng.randn(2).astype(np.float32),
                         (rng.randn(1, 2).astype(np.float32), 7)],
                   "lr": 0.125, "name": "adamw"},
    }


def _to(P, tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy()) if P == "torch" else paddle.to_tensor(tree)
    if isinstance(tree, dict):
        return {k: _to(P, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(P, v) for v in tree)
    return tree


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.dtype == torch.bfloat16 \
            else tree.detach().numpy()
    if hasattr(tree, "_data"):
        return np.asarray(tree._data).astype(np.float32) \
            if str(tree.dtype).endswith("bfloat16") else np.asarray(tree._data)
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_nested_round_trip(tmp_path):
    s = _state()
    path = str(tmp_path / "sub" / "s.pdparams")
    ptt.save(_to("torch", s), path)
    got = ptt.load(path)
    assert isinstance(got["w"], torch.Tensor)
    _equal(_np(got), s)
    _equal(ptt.load(path, return_numpy=True), s)


def test_dumps_loads_round_trip():
    s = _to("torch", _state(1))
    _equal(_np(tio.loads(tio.dumps(s))), _np(s))


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_f32_files_cross_packages(tmp_path, direction):
    s = _state(2)
    path = str(tmp_path / "s.pdparams")
    if direction == "port_to_reference":
        ptt.save(_to("torch", s), path)
        got = paddle.load(path)
    else:
        paddle.save(_to("paddle", s), path)
        got = ptt.load(path)
    _equal(_np(got), s)


def test_bf16_port_file_reads_in_the_reference_as_raw_uint16(tmp_path):
    import ml_dtypes

    t = torch.randn(4, 5).to(torch.bfloat16)
    path = str(tmp_path / "b.pdparams")
    ptt.save({"w": t}, path)
    raw = paddle.load(path, return_numpy=True)["w"]
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(raw.view(ml_dtypes.bfloat16).astype(np.float32),
                                  t.float().numpy())
    back = ptt.load(path)["w"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_bf16_reference_file_reads_in_the_port(tmp_path):
    import ml_dtypes

    a = np.random.RandomState(3).randn(3, 3).astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "b.pdparams")
    paddle.save({"w": paddle.to_tensor(a), "x": [paddle.to_tensor(a)]}, path)
    got = ptt.load(path)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), a.astype(np.float32))
    np.testing.assert_array_equal(got["x"][0].float().numpy(), a.astype(np.float32))
    assert ptt.load(path, return_numpy=True)["w"].dtype == np.uint16


def test_stop_gradient_crosses(tmp_path):
    p = torch.nn.Parameter(torch.ones(2))
    path = str(tmp_path / "p.pdparams")
    ptt.save({"p": p, "c": torch.zeros(2)}, path)
    import pickle

    with open(path, "rb") as f:
        raw = pickle.load(f)  # the reference's tag, readable without either package
    assert raw["p"]["stop_gradient"] is False and raw["c"]["stop_gradient"] is True
    _equal(_np(paddle.load(path)), {"p": np.ones(2, np.float32),
                                    "c": np.zeros(2, np.float32)})
    got = ptt.load(path)
    assert got["p"].requires_grad and not got["c"].requires_grad


def test_module_and_optimizer_state_round_trip(tmp_path):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    torch.manual_seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    ids = torch.randint(0, 256, (2, 8))
    m.loss(ids, ids).backward()
    opt.step()
    path = str(tmp_path / "m.pdparams")
    ptt.save({"model": m.state_dict(), "opt": opt.state_dict()}, path)
    got = ptt.load(path)
    m2 = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m2.load_state_dict(got["model"])
    for (n, a), (_, b) in zip(m.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), n
    _equal(_np(got["opt"]), _np(opt.state_dict()))


def test_errors_match_the_reference(tmp_path):
    for mod in (paddle, ptt):
        with pytest.raises(ValueError, match="directory"):
            mod.save({}, str(tmp_path))
        with pytest.raises(ValueError, match="not found"):
            mod.load(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="reserved"):
        ptt.save({"__paddle_tpu_tensor__": 1}, str(tmp_path / "x"))
