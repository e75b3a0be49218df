"""Port parity: ``amp.debugging`` (operator stats, the tensor checker,
``compare_accuracy``) against the JAX package's, on the CPU.

The reference observes ops at its tape; the port observes aten ops through a
dispatch mode, so op names differ (``matmul`` there is ``mm`` here,
``multiply`` is ``mul``). The cases compare what does not hang on names:
counts of NaN/Inf, the stats of the same op's output (absmax to 1e-6
relative, absmin and mean to 1e-5), whether the checker fires on the same planted overflow, the
``debug_step`` window, and the CSV ``compare_accuracy`` writes from the
reference's own JSONL dumps (byte-equal).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.ops import kernels

REL = 1e-6  # absmax: the largest output element
STAT = 1e-5  # absmin and mean: XLA's and torch's f32 products differ by ulps


@pytest.fixture(autouse=True)
def _reset_observers():
    yield
    from paddle_tpu.base import tape

    jdbg.disable_tensor_checker()
    jdbg._active_collector = None
    tape._op_observers.clear()
    tape._backward_tick_callbacks.clear()
    tdbg.disable_tensor_checker()
    tdbg._active_collector = None
    tdbg._op_observers.clear()
    tdbg._backward_tick_callbacks.clear()
    tdbg._sync_mode()
    assert not kernels.OBSERVERS


def _xw():
    return (np.random.RandomState(0).randn(4, 8).astype(np.float32),
            np.random.RandomState(1).randn(8, 8).astype(np.float32))


class TestOperatorStats:
    def test_collect_and_summary(self, capsys):
        x, w = _xw()
        with jdbg.collect_operator_stats() as jcol:
            JF.relu(paddle.matmul(paddle.to_tensor(x), paddle.to_tensor(w)))
        with tdbg.collect_operator_stats() as tcol:
            torch.relu(torch.from_numpy(x) @ torch.from_numpy(w))
        jrows = {r["op"]: r for r in jcol.rows()}
        trows = {r["op"]: r for r in tcol.rows()}
        for jop, top in (("matmul", "mm"), ("relu", "relu")):
            j, t = jrows[jop], trows[top]
            assert (t["dtype"], t["calls"], t["num_nan"], t["num_inf"]) == \
                (j["dtype"], j["calls"], j["num_nan"], j["num_inf"])
            np.testing.assert_allclose(t["absmax"], j["absmax"], rtol=REL)
            for k in ("absmin", "mean"):
                np.testing.assert_allclose(t[k], j[k], rtol=STAT)
        out = capsys.readouterr().out
        assert "mm" in out and "absmax" in out

    def test_enable_disable_pair(self, capsys):
        tdbg.enable_operator_stats_collection()
        assert kernels.OBSERVERS  # the kernels report while collecting
        torch.ones(2, 2) * 2.0
        rows = tdbg.disable_operator_stats_collection()
        assert any(r["num_nan"] == 0 for r in rows)
        assert "calls" in capsys.readouterr().out
        assert tdbg.disable_operator_stats_collection() == []

    def test_backward_ops_tracked(self):
        x = torch.ones(3, 3, requires_grad=True)
        with tdbg.collect_operator_stats(print_summary=False) as col:
            (x * x).sum().backward()
        ops = {r["op"] for r in col.rows()}
        assert any(op.startswith("grad_") for op in ops), ops
        jx = paddle.to_tensor(np.ones((3, 3), np.float32))
        jx.stop_gradient = False
        with jdbg.collect_operator_stats(print_summary=False) as jcol:
            (jx * jx).sum().backward()
        assert any(r["op"].startswith("grad_") for r in jcol.rows())

    def test_collection_skips_valueless_tensors(self):
        from torch._subclasses.fake_tensor import FakeTensorMode

        with tdbg.collect_operator_stats(print_summary=False) as col:
            with FakeTensorMode():
                a = torch.ones(2, 2)
                a * 2.0
        assert all(r["calls"] >= 1 for r in col.rows())
        assert not any(r["op"] == "mul" for r in col.rows())

    def test_dump_roundtrip(self, tmp_path):
        with tdbg.collect_operator_stats(output_dir=str(tmp_path), print_summary=False):
            torch.ones(2) + 1.0
        rows = [r for r in open(tmp_path / "op_stats.jsonl")]
        assert rows and "absmax" in rows[0]

    def test_kernel_reports_reach_the_observers(self):
        """A kernel's ctypes launch is invisible to the dispatcher: its
        wrapper reports its outputs (``kernels.report``) under its name."""
        with tdbg.collect_operator_stats(print_summary=False) as col:
            kernels.report("flash_attention_fwd", torch.ones(2, 3),
                           torch.full((2,), float("inf")))
        row = next(r for r in col.rows() if r["op"] == "flash_attention_fwd")
        assert row["calls"] == 1 and row["num_inf"] == 2
        assert not kernels.OBSERVERS


class TestTensorChecker:
    def test_abort_on_inf(self):
        for dbg, mk, mul in ((jdbg, paddle.to_tensor, "multiply"),
                             (tdbg, torch.from_numpy, "mul")):
            dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
                True, debug_mode=dbg.DebugMode.CHECK_NAN_INF_AND_ABORT))
            x = mk(np.array([1e38], np.float32))
            with pytest.raises(FloatingPointError, match=mul):
                x * 100.0
            dbg.disable_tensor_checker()
            x * 100.0  # no longer raises

    def test_kernel_output_is_checked(self):
        nan = torch.tensor([float("nan")])
        tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(True))
        with pytest.raises(FloatingPointError, match="flash_attention_bwd_dq"):
            kernels.report("flash_attention_bwd_dq", nan)
        tdbg.disable_tensor_checker()
        assert not kernels.OBSERVERS

    def test_warn_mode_logs_to_dir(self, tmp_path):
        for dbg, mk, sub in ((jdbg, paddle.to_tensor, "j"), (tdbg, torch.from_numpy, "t")):
            dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
                True, debug_mode=dbg.DebugMode.CHECK_NAN_INF,
                output_dir=str(tmp_path / sub)))
            mk(np.array([np.nan], np.float32)) + 1.0
            dbg.disable_tensor_checker()
            log = (tmp_path / sub / "tensor_check.log").read_text()
            assert "NaN" in log and "add" in log

    def test_checked_op_list_filters(self):
        for dbg, mk, mm, matmul in (
                (jdbg, paddle.to_tensor, "matmul", paddle.matmul),
                (tdbg, torch.from_numpy, "mm", torch.matmul)):
            dbg.enable_tensor_checker(dbg.TensorCheckerConfig(True, checked_op_list=[mm]))
            mk(np.array([np.inf], np.float32)) + 1.0  # add: not checked
            with pytest.raises(FloatingPointError):
                matmul(mk(np.full((2, 2), np.inf, np.float32)),
                       mk(np.ones((2, 2), np.float32)))
            dbg.disable_tensor_checker()

    def test_skipped_op_list(self):
        for dbg, mk, div in ((jdbg, paddle.to_tensor, "divide"),
                             (tdbg, torch.from_numpy, "div")):
            dbg.enable_tensor_checker(dbg.TensorCheckerConfig(True, skipped_op_list=[div]))
            a = mk(np.array([1.0], np.float32))
            a / 0.0  # skipped
            with pytest.raises(FloatingPointError):
                a * np.inf
            dbg.disable_tensor_checker()

    def test_debug_step_window(self):
        """The window ticks once per backward in both packages: outside it
        at step 0, inside after one backward, outside after two."""
        for dbg, mk, req in (
                (jdbg, paddle.to_tensor,
                 lambda t: setattr(t, "stop_gradient", False) or t),
                (tdbg, torch.from_numpy, lambda t: t.requires_grad_(True))):
            cfg = dbg.TensorCheckerConfig(True, debug_step=(1, 2))
            dbg.enable_tensor_checker(cfg)
            bad = mk(np.array([np.inf], np.float32))
            bad + 0.0
            req(mk(np.ones((2,), np.float32))).sum().backward()
            with pytest.raises(FloatingPointError):
                bad + 0.0
            req(mk(np.ones((2,), np.float32))).sum().backward()
            bad + 0.0
            assert cfg._step == 2
            dbg.disable_tensor_checker()

    def test_bad_config_rejected(self):
        for dbg in (jdbg, tdbg):
            with pytest.raises(ValueError):
                dbg.TensorCheckerConfig(True, debug_step=(3, 2))
            with pytest.raises(TypeError):
                dbg.TensorCheckerConfig(True, debug_mode="abort")

    def test_check_numerics_counts(self):
        a = np.array([1.0, np.nan, np.inf, -np.inf, 2.0], np.float32)
        got = [dbg.check_numerics(mk(a), "probe", "t",
                                  debug_mode=dbg.DebugMode.CHECK_NAN_INF)
               for dbg, mk in ((jdbg, paddle.to_tensor), (tdbg, torch.from_numpy))]
        assert got[0] == got[1] == (1, 2, 5)
        with pytest.raises(FloatingPointError):
            tdbg.check_numerics(torch.from_numpy(a))

    def test_check_layer_numerics_decorator(self):
        class Bad(torch.nn.Module):
            @tdbg.check_layer_numerics
            def forward(self, x):
                return x / 0.0

        with pytest.raises(FloatingPointError, match="output"):
            Bad()(torch.ones(2))
        with pytest.raises(FloatingPointError, match="input"):
            Bad()(torch.tensor([np.nan]))

    def test_overflow_mode_reports_out_of_fp16_range(self, tmp_path):
        for dbg, mk, sub in ((jdbg, paddle.to_tensor, "j"), (tdbg, torch.from_numpy, "t")):
            dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
                True, debug_mode=dbg.DebugMode.CHECK_ALL_FOR_OVERFLOW,
                output_dir=str(tmp_path / sub)))
            mk(np.array([1e5, 1.0], np.float32)) * 1.0
            dbg.disable_tensor_checker()
        hits = [[ln for ln in (tmp_path / s / "tensor_check.log").read_text().splitlines()
                 if ln.startswith("[tensor checker]")] for s in ("j", "t")]
        assert len(hits[0]) == len(hits[1]) == 1
        assert all("outside float16 range" in ln for ln in hits[0] + hits[1])


class TestCompareAccuracy:
    def test_planted_low_precision_overflow_flagged(self):
        def f(x):
            return (x * x).sum()

        x = np.full((4,), 3.3e4, np.float32)
        for dbg, mk in ((jdbg, paddle.to_tensor), (tdbg, torch.from_numpy)):
            report = dbg.compare_accuracy(f, args=(mk(x),), dtypes=("float32", "float16"))
            flagged = [r["flag"] for r in report if r["flag"]]
            assert any("OVERFLOW_IN_FLOAT16" in v for v in flagged), report

    def test_planted_bf16_overflow_flagged(self):
        def f(x):
            return x + x

        x = np.full((2,), 1.7e38, np.float32)
        for dbg, mk in ((jdbg, paddle.to_tensor), (tdbg, torch.from_numpy)):
            report = dbg.compare_accuracy(f, args=(mk(x),), dtypes=("float32", "bfloat16"))
            flagged = [r["flag"] for r in report if r["flag"]]
            assert any("OVERFLOW_IN_BFLOAT16" in v for v in flagged), report

    def test_dump_mode_csv_equals_the_reference(self, tmp_path, capsys):
        a_dir, b_dir = tmp_path / "a", tmp_path / "b"
        x = paddle.to_tensor(np.ones((4,), np.float32))
        with jdbg.collect_operator_stats(str(a_dir), print_summary=False):
            x * 2.0
            paddle.matmul(x.reshape([2, 2]), x.reshape([2, 2]))
        with jdbg.collect_operator_stats(str(b_dir), print_summary=False):
            x * np.float32(np.inf)
        jrep = jdbg.compare_accuracy(str(a_dir), str(b_dir), str(tmp_path / "j.csv"))
        trep = tdbg.compare_accuracy(str(a_dir), str(b_dir), str(tmp_path / "t.csv"))
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
        assert trep == jrep
        mult = next(r for r in trep if r["op"] == "multiply")
        assert mult["flag"] == "OVERFLOW_IN_RUN_B"
        with pytest.raises(ValueError, match="two dump paths"):
            tdbg.compare_accuracy(str(a_dir))

    def test_port_dumps_compare_like_the_references(self, tmp_path):
        """The same planted overflow through each package's own dumps: the
        same number of flagged ops, each OVERFLOW_IN_RUN_B."""
        flags = []
        for dbg, mk, sub in ((jdbg, paddle.to_tensor, "j"), (tdbg, torch.from_numpy, "t")):
            x = mk(np.ones((4,), np.float32))
            with dbg.collect_operator_stats(str(tmp_path / sub / "a"), print_summary=False):
                x * 2.0
            with dbg.collect_operator_stats(str(tmp_path / sub / "b"), print_summary=False):
                x * np.float32(np.inf)
            rep = dbg.compare_accuracy(str(tmp_path / sub / "a"), str(tmp_path / sub / "b"))
            flags.append(sorted(r["flag"] for r in rep if r["flag"]))
        assert flags[0] == flags[1] == ["OVERFLOW_IN_RUN_B"]
