"""AMP debugging tools: per-op tensor checking, operator stats, and
cross-dtype accuracy comparison (counterpart of
``paddle_tpu/amp/debugging.py``).

The reference observes every op at its tape's one dispatch point. The
port's counterpart is a ``TorchDispatchMode`` over aten ops, entered while
an observer is installed:

- observers see each op's output tensors right after it runs and compute
  nan/inf counts, absmax/absmin/mean on the device, read back once per op
  (a host sync per op — a debugging tool, not a fast path); ops whose
  output is uninitialised memory (``empty`` and kin) are skipped;
- op names are aten's (``mm``, ``add``, ``_softmax``; ``grad_<op>`` for an
  op run by the backward), not the tape's;
- a hand-written kernel's ``ctypes`` launch is invisible to the
  dispatcher, so each kernel wrapper reports its outputs to the observers
  under its own name (``flash_attention_fwd``, ...) when one is installed
  (``ops.kernels.OBSERVERS``);
- collection is eager: inside a CUDA-graph capture (and on export's fake
  tensors) outputs have no values and are skipped;
- ``debug_step`` ranges tick once per backward (the first op of a new
  autograd graph task), as the reference ticks per ``run_backward``.

``compare_accuracy`` keeps the reference's dump-file signature
(dump_path, another_dump_path, output_filename) over the JSONL stats dumps
written by ``collect_operator_stats(output_dir=...)`` and writes the same
CSV; it also takes a callable first argument, run under two dtypes and
diffed directly.
"""
from __future__ import annotations

import contextlib
import json
import os
import traceback
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

__all__ = [
    "DebugMode",
    "TensorCheckerConfig",
    "check_numerics",
    "enable_operator_stats_collection",
    "disable_operator_stats_collection",
    "collect_operator_stats",
    "enable_tensor_checker",
    "disable_tensor_checker",
    "compare_accuracy",
    "check_layer_numerics",
]

_FP16_MAX = 65504.0
_FP16_TINY = 6.103515625e-05  # smallest normal float16


class DebugMode(Enum):
    """Checker behavior.

    - CHECK_NAN_INF_AND_ABORT: raise on NaN/Inf outputs.
    - CHECK_NAN_INF: report NaN/Inf outputs, keep running.
    - CHECK_ALL_FOR_OVERFLOW: report fp32 outputs outside the float16
      representable range (overflow/underflow candidates for O1).
    - CHECK_ALL: report key stats for every checked op.
    """

    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


def _valueless(t: torch.Tensor) -> bool:
    """A tensor with no values to read: a fake (export) or meta tensor, or
    one on a CUDA stream that is capturing a graph."""
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(t, FakeTensor) or t.device.type == "meta":
        return True
    return (t.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _leaf_stats(t) -> Optional[dict]:
    """Stats for one output tensor; None for non-float, empty or valueless
    ones. Computed on the tensor's device in float64, read back once."""
    if not isinstance(t, torch.Tensor):
        return None
    if not (t.is_floating_point() or t.is_complex()) or t.numel() == 0:
        return None
    if _valueless(t):
        return None
    # the stats' own ops are nobody's to observe
    with _disable_current_modes():
        return _stats_of(t.detach())


def _stats_of(a: torch.Tensor) -> dict:
    """:func:`_leaf_stats` of a float tensor with values."""
    dtype_str = str(a.dtype).replace("torch.", "")
    if a.is_complex():
        finite = torch.isfinite(a.real) & torch.isfinite(a.imag)
        nan = torch.isnan(a.real) | torch.isnan(a.imag)
        inf = (torch.isinf(a.real) | torch.isinf(a.imag)) & ~nan
        af = a.abs().double()
    else:
        finite, nan, inf = torch.isfinite(a), torch.isnan(a), torch.isinf(a)
        af = a.double().abs()
    zero = torch.zeros((), dtype=torch.float64, device=a.device)
    fin = torch.where(finite, af, zero)
    n_fin = finite.sum()
    pos = torch.where(finite & (af > 0), af,
                      torch.full((), float("inf"), dtype=torch.float64,
                                 device=a.device))
    vals = torch.stack([nan.sum().double(), inf.sum().double(),
                        n_fin.double(), fin.max(), pos.min(),
                        fin.sum() / n_fin.clamp(min=1)]).tolist()
    num_nan, num_inf, n_finite = int(vals[0]), int(vals[1]), int(vals[2])
    if n_finite:
        absmax, absmin, mean = vals[3], vals[4], vals[5]
        if absmin == float("inf"):
            absmin = 0.0
    else:
        absmax = absmin = mean = float("nan")
    return {
        "dtype": dtype_str,
        "numel": int(a.numel()),
        "num_nan": num_nan,
        "num_inf": num_inf,
        "absmax": absmax,
        "absmin": absmin,
        "mean": mean,
    }


# ---------------------------------------------------------------------------
# The observation point: a dispatch mode over aten ops, plus the kernels'
# own reports
# ---------------------------------------------------------------------------

_op_observers: List[Callable] = []
_backward_tick_callbacks: List[Callable] = []
# ops whose outputs are uninitialised memory, tensors made from host data
# (the reference's ``to_tensor`` is no op either), and views/aliases that
# would only count their input again
_SKIPPED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "lift", "lift_fresh",
                      "lift_fresh_copy", "detach", "alias",
                      "_local_scalar_dense"})


class _ObserverMode(TorchDispatchMode):
    """Hands every aten op's outputs to the observers; ticks the
    backward callbacks once per new autograd graph task."""

    def __init__(self):
        super().__init__()
        self._task = -1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _SKIPPED:
            return out
        task = torch._C._current_graph_task_id()
        if task != -1 and task != self._task:
            self._task = task
            for cb in list(_backward_tick_callbacks):
                cb()
        if torch._C._current_autograd_node() is not None:
            name = "grad_" + name
        leaves = [t for t in pytree.tree_leaves(out)
                  if isinstance(t, torch.Tensor)]
        for obs in list(_op_observers):
            obs(name, leaves)
        return out


_mode: List[Optional[_ObserverMode]] = [None]


def _report_kernel(name: str, outs) -> None:
    """A kernel wrapper's outputs (``ops.kernels.report``)."""
    leaves = [t for t in outs if isinstance(t, torch.Tensor)]
    for obs in list(_op_observers):
        obs(name, leaves)


def _sync_mode() -> None:
    """Enter the dispatch mode (and the kernels' report hook) while any
    observer is installed; leave it when none is."""
    from ..ops import kernels

    want = bool(_op_observers or _backward_tick_callbacks)
    if want and _mode[0] is None:
        _mode[0] = _ObserverMode()
        _mode[0].__enter__()
        if _report_kernel not in kernels.OBSERVERS:
            kernels.OBSERVERS.append(_report_kernel)
    elif not want and _mode[0] is not None:
        m, _mode[0] = _mode[0], None
        m.__exit__(None, None, None)
        if _report_kernel in kernels.OBSERVERS:
            kernels.OBSERVERS.remove(_report_kernel)


def _add_observer(obs) -> None:
    _op_observers.append(obs)
    _sync_mode()


def _remove_observer(obs) -> None:
    if obs in _op_observers:
        _op_observers.remove(obs)
    _sync_mode()


# ---------------------------------------------------------------------------
# Operator stats collection
# ---------------------------------------------------------------------------


class _StatsCollector:
    """Aggregates per-(op, dtype) stats from the op observer."""

    def __init__(self):
        # (op, dtype) -> {calls, num_nan, num_inf, absmax, absmin, mean_sum}
        self.stats: Dict[Tuple[str, str], dict] = {}

    def __call__(self, op_name: str, leaves: Sequence):
        op = op_name or "op"  # backward ops arrive as "grad_<op>"
        seen_dtypes = set()  # "calls" = op INVOCATIONS per dtype
        for leaf in leaves:
            st = _leaf_stats(leaf)
            if st is None:
                continue
            key = (op, st["dtype"])
            ent = self.stats.setdefault(
                key,
                {"calls": 0, "leaves": 0, "num_nan": 0, "num_inf": 0,
                 "absmax": 0.0, "absmin": float("inf"),
                 "_mean_sum": 0.0, "_mean_count": 0},
            )
            if st["dtype"] not in seen_dtypes:
                seen_dtypes.add(st["dtype"])
                ent["calls"] += 1
            ent["leaves"] += 1
            ent["num_nan"] += st["num_nan"]
            ent["num_inf"] += st["num_inf"]
            if not np.isnan(st["absmax"]):
                ent["absmax"] = max(ent["absmax"], st["absmax"])
                if st["absmin"] > 0:
                    ent["absmin"] = min(ent["absmin"], st["absmin"])
                ent["_mean_sum"] += st["mean"]
                ent["_mean_count"] += 1

    def rows(self) -> List[dict]:
        out = []
        for (op, dt), ent in sorted(self.stats.items()):
            out.append({
                "op": op, "dtype": dt, "calls": ent["calls"],
                "num_nan": ent["num_nan"], "num_inf": ent["num_inf"],
                "absmax": ent["absmax"],
                "absmin": 0.0 if ent["absmin"] == float("inf") else ent["absmin"],
                "mean": ent["_mean_sum"] / max(ent["_mean_count"], 1),
            })
        return out

    def summary_table(self) -> str:
        """Printable table in the spirit of the reference's
        _print_operator_stats (ref: debugging.py:411): op, dtype call
        counts, nan/inf totals, absmax."""
        rows = self.rows()
        if not rows:
            return "<op stats: no float operator outputs observed>"
        header = (
            f"{'op':<28}{'dtype':<12}{'calls':>7}{'num_nan':>9}"
            f"{'num_inf':>9}{'absmax':>13}{'absmin':>13}{'mean':>13}"
        )
        lines = [header, "-" * len(header)]
        for r in rows:
            lines.append(
                f"{r['op']:<28}{r['dtype']:<12}{r['calls']:>7}"
                f"{r['num_nan']:>9}{r['num_inf']:>9}{r['absmax']:>13.4e}"
                f"{r['absmin']:>13.4e}{r['mean']:>13.4e}"
            )
        return "\n".join(lines)

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            for r in self.rows():
                f.write(json.dumps(r) + "\n")
        return path


_active_collector: Optional[_StatsCollector] = None


def enable_operator_stats_collection():
    """Start collecting per-op output stats (eager ops only)."""
    global _active_collector

    if _active_collector is not None:
        return
    _active_collector = _StatsCollector()
    _add_observer(_active_collector)


def disable_operator_stats_collection():
    """Stop collecting and print the summary table. Returns the list of
    per-(op, dtype) stat rows."""
    global _active_collector

    if _active_collector is None:
        return []
    col = _active_collector
    _active_collector = None
    _remove_observer(col)
    print(col.summary_table())
    return col.rows()


@contextlib.contextmanager
def collect_operator_stats(output_dir: Optional[str] = None,
                           print_summary: bool = True):
    """Context manager: collect per-op stats inside the block. Yields the
    collector; on exit prints the summary and, with ``output_dir``, writes
    ``op_stats.jsonl`` there (the dump ``compare_accuracy`` consumes)."""
    col = _StatsCollector()
    _add_observer(col)
    try:
        yield col
    finally:
        _remove_observer(col)
        if print_summary:
            print(col.summary_table())
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            col.dump(os.path.join(output_dir, "op_stats.jsonl"))


# ---------------------------------------------------------------------------
# Tensor checker
# ---------------------------------------------------------------------------


class TensorCheckerConfig:
    """Per-op numeric checking config .

    Args mirror the reference: ``enable``, ``debug_mode``, ``output_dir``
    (report lines are appended to ``<output_dir>/tensor_check.log``
    instead of printed), ``checked_op_list`` / ``skipped_op_list`` (exact
    op names), ``debug_step`` ((start, end) training-step window, ticked
    per backward, as the reference ticks per ``run_backward``), ``stack_height_limit`` (Python stack frames
    reported on a hit)."""

    def __init__(
        self,
        enable: bool,
        debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT,
        output_dir: Optional[str] = None,
        checked_op_list: Optional[Sequence[str]] = None,
        skipped_op_list: Optional[Sequence[str]] = None,
        debug_step: Optional[Tuple[int, int]] = None,
        stack_height_limit: int = 1,
    ):
        self.enable = bool(enable)
        if not isinstance(debug_mode, DebugMode):
            raise TypeError(
                f"debug_mode must be a DebugMode, got {type(debug_mode)}"
            )
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])
        if debug_step is not None:
            start, end = debug_step
            if start < 0 or end <= start:
                raise ValueError(
                    f"debug_step must be (start, end) with 0 <= start < "
                    f"end, got {debug_step}"
                )
            self.start_step, self.end_step = int(start), int(end)
        else:
            self.start_step = self.end_step = None
        self.stack_height_limit = int(stack_height_limit)
        self._step = 0

    # -- step window ----------------------------------------------------
    def update_and_check_step_id(self) -> bool:
        """Tick the training step (called per backward pass); returns
        whether checking is active for the current step."""
        self._step += 1
        return self._step_active()

    def _step_active(self) -> bool:
        if self.start_step is None:
            return True
        return self.start_step <= self._step < self.end_step

    def _op_selected(self, op: str) -> bool:
        if op in self.skipped_op_list:
            return False
        if self.checked_op_list:
            return op in self.checked_op_list
        return True

    # -- reporting ------------------------------------------------------
    def _report(self, msg: str):
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir, "tensor_check.log"), "a") as f:
                f.write(msg + "\n")
        else:
            print(msg)

    def _stack_suffix(self) -> str:
        if self.stack_height_limit <= 0:
            return ""
        frames = traceback.extract_stack()
        # prefer user frames (outside the framework); if the hit came
        # entirely from framework-internal code (hapi fit loop etc.),
        # report the innermost non-observer framework frames instead
        user = [f for f in frames if "paddle_tpu_torch" not in f.filename
                and "/torch/" not in f.filename]
        if not user:
            user = [f for f in frames if "/torch/" not in f.filename
                    and not f.filename.endswith("debugging.py")]
        user = user[-self.stack_height_limit:]
        return "".join(
            f"\n  at {f.filename}:{f.lineno} in {f.name}" for f in user
        )

    # -- the observer ---------------------------------------------------
    def __call__(self, op_name: str, leaves: Sequence):
        if not self.enable or not self._step_active():
            return
        op = op_name or "op"
        if not self._op_selected(op):
            return
        for leaf in leaves:
            st = _leaf_stats(leaf)
            if st is None:
                continue
            bad = st["num_nan"] + st["num_inf"]
            mode = self.debug_mode
            if mode in (DebugMode.CHECK_NAN_INF_AND_ABORT,
                        DebugMode.CHECK_NAN_INF):
                if bad:
                    msg = (
                        f"[tensor checker] op '{op}' output has "
                        f"{st['num_nan']} NaN / {st['num_inf']} Inf of "
                        f"{st['numel']} ({st['dtype']}), finite absmax="
                        f"{st['absmax']:.4e}{self._stack_suffix()}"
                    )
                    if mode is DebugMode.CHECK_NAN_INF_AND_ABORT:
                        raise FloatingPointError(msg)
                    self._report(msg)
            elif mode is DebugMode.CHECK_ALL_FOR_OVERFLOW:
                if st["dtype"] == "float32" and (
                    bad
                    or st["absmax"] > _FP16_MAX
                    or (0 < st["absmin"] < _FP16_TINY)
                ):
                    self._report(
                        f"[tensor checker] op '{op}' float32 output "
                        f"outside float16 range: absmax={st['absmax']:.4e} "
                        f"absmin={st['absmin']:.4e} nan={st['num_nan']} "
                        f"inf={st['num_inf']}{self._stack_suffix()}"
                    )
            elif mode is DebugMode.CHECK_ALL:
                self._report(
                    f"[tensor checker] op '{op}' {st['dtype']} "
                    f"numel={st['numel']} absmax={st['absmax']:.4e} "
                    f"absmin={st['absmin']:.4e} mean={st['mean']:.4e} "
                    f"nan={st['num_nan']} inf={st['num_inf']}"
                )


_active_checker: Optional[TensorCheckerConfig] = None


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Install the checker on every op (and every kernel's outputs)."""
    global _active_checker

    disable_tensor_checker()
    _active_checker = checker_config
    _backward_tick_callbacks.append(checker_config.update_and_check_step_id)
    _add_observer(checker_config)


def disable_tensor_checker():
    """Remove the active checker."""
    global _active_checker

    if _active_checker is None:
        return
    for lst in (_op_observers, _backward_tick_callbacks):
        for item in list(lst):
            if item is _active_checker or (
                getattr(item, "__self__", None) is _active_checker
            ):
                lst.remove(item)
    _active_checker = None
    _sync_mode()


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT,
                   stack_height_limit: int = 1,
                   output_dir: Optional[str] = None):
    """Check one tensor now. Returns (num_nan, num_inf, numel) as ints;
    a valueless tensor (inside a capture) is skipped."""
    st = _leaf_stats(tensor)
    if st is None:
        shape = getattr(tensor, "shape", None)
        return 0, 0, int(np.prod(shape)) if shape is not None else 0
    cfg = TensorCheckerConfig(
        True, debug_mode=debug_mode, output_dir=output_dir,
        stack_height_limit=stack_height_limit,
    )
    cfg(f"{op_type or 'check_numerics'}:{var_name}", [tensor])
    return st["num_nan"], st["num_inf"], st["numel"]


def check_layer_numerics(func: Callable) -> Callable:
    """Decorator: check a layer forward's tensor inputs and outputs for
    NaN/Inf. Raises FloatingPointError on a hit."""
    import functools

    def check_tree(tree, what, layer_name):
        leaves = [x for x in pytree.tree_leaves(tree)
                  if isinstance(x, torch.Tensor)]
        for i, leaf in enumerate(leaves):
            st = _leaf_stats(leaf)
            if st and (st["num_nan"] or st["num_inf"]):
                raise FloatingPointError(
                    f"{what} {i} of {layer_name}.forward has "
                    f"{st['num_nan']} NaN / {st['num_inf']} Inf"
                )

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        check_tree((args, kwargs), "input", type(self).__name__)
        out = func(self, *args, **kwargs)
        check_tree(out, "output", type(self).__name__)
        return out

    return wrapper


# ---------------------------------------------------------------------------
# Cross-dtype accuracy comparison
# ---------------------------------------------------------------------------


def _run_fn_with_stats(fn, args, kwargs, dtype: str):
    """Run fn with float tensor args cast to ``dtype``, collecting stats."""
    from ..base.dtype import to_torch_dtype

    dt = to_torch_dtype(dtype)

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dt)
        return x

    cargs = [cast(a) for a in args]
    ckw = {k: cast(v) for k, v in (kwargs or {}).items()}
    with collect_operator_stats(print_summary=False) as col:
        fn(*cargs, **ckw)
    return col.rows()


def _rows_by_op(rows: List[dict]) -> Dict[str, dict]:
    """Merge rows over dtypes per op (an op may emit several dtypes)."""
    out: Dict[str, dict] = {}
    for r in rows:
        ent = out.setdefault(
            r["op"],
            {"calls": 0, "num_nan": 0, "num_inf": 0, "absmax": 0.0,
             "dtypes": set()},
        )
        ent["calls"] += r["calls"]
        ent["num_nan"] += r["num_nan"]
        ent["num_inf"] += r["num_inf"]
        ent["absmax"] = max(ent["absmax"], r["absmax"])
        ent["dtypes"].add(r["dtype"])
    return out


def _compare_tables(rows_a, rows_b, label_a, label_b,
                    output_filename=None) -> List[dict]:
    a, b = _rows_by_op(rows_a), _rows_by_op(rows_b)
    report = []
    for op in sorted(set(a) | set(b)):
        ea = a.get(op)
        eb = b.get(op)
        flag = ""
        if ea and eb:
            if (eb["num_nan"] + eb["num_inf"]) > (ea["num_nan"] + ea["num_inf"]):
                flag = "OVERFLOW_IN_" + label_b.upper()
            elif (ea["num_nan"] + ea["num_inf"]) > (eb["num_nan"] + eb["num_inf"]):
                flag = "OVERFLOW_IN_" + label_a.upper()
            elif ea["absmax"] > 0 and (
                abs(ea["absmax"] - eb["absmax"]) / ea["absmax"] > 0.05
            ):
                flag = "ABSMAX_DIVERGED"
        report.append({
            "op": op,
            f"{label_a}_dtypes": ",".join(sorted(ea["dtypes"])) if ea else "",
            f"{label_a}_nan_inf": (ea["num_nan"] + ea["num_inf"]) if ea else "",
            f"{label_a}_absmax": ea["absmax"] if ea else "",
            f"{label_b}_dtypes": ",".join(sorted(eb["dtypes"])) if eb else "",
            f"{label_b}_nan_inf": (eb["num_nan"] + eb["num_inf"]) if eb else "",
            f"{label_b}_absmax": eb["absmax"] if eb else "",
            "flag": flag,
        })
    if output_filename:
        import csv

        with open(output_filename, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(report[0].keys()) if report
                               else ["op"])
            w.writeheader()
            w.writerows(report)
    flagged = [r for r in report if r["flag"]]
    print(
        f"compare_accuracy: {len(report)} ops compared "
        f"({label_a} vs {label_b}), {len(flagged)} flagged"
    )
    for r in flagged:
        print(f"  {r['op']:<28} {r['flag']}")
    return report


def compare_accuracy(
    dump_path,
    another_dump_path=None,
    output_filename: Optional[str] = None,
    loss_scale: float = 1,
    dump_all_tensors: bool = False,
    *,
    args: Sequence = (),
    kwargs: Optional[dict] = None,
    dtypes: Tuple[str, str] = ("float32", "bfloat16"),
):
    """Cross-dtype accuracy comparison.

    Two call forms:

    - ``compare_accuracy(dump_a, dump_b, out_csv)``: compare two
      ``op_stats.jsonl`` dumps written by
      ``collect_operator_stats(output_dir=...)`` (a path to the file or
      its directory); writes a CSV report.
    - ``compare_accuracy(fn, args=..., dtypes=("float32","bfloat16"))``:
      run ``fn`` twice with its float tensor args cast to each dtype,
      collecting per-op stats for both runs and diffing them — flags
      ops that produce NaN/Inf only in the lower precision or whose
      absmax diverges >5%.

    Returns the list of per-op comparison rows."""
    if callable(dump_path):
        fn = dump_path
        lo, hi = dtypes[0], dtypes[1]
        rows_a = _run_fn_with_stats(fn, args, kwargs, lo)
        rows_b = _run_fn_with_stats(fn, args, kwargs, hi)
        return _compare_tables(rows_a, rows_b, lo, hi, output_filename)

    if another_dump_path is None:
        raise ValueError(
            "compare_accuracy dump mode needs two dump paths "
            "(dump_path, another_dump_path); to compare a function "
            "under two dtypes pass a callable first argument instead"
        )

    def load(path):
        if os.path.isdir(path):
            path = os.path.join(path, "op_stats.jsonl")
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    if dump_all_tensors:
        print("compare_accuracy: dump_all_tensors is not supported "
              "(per-op stats only)")
    return _compare_tables(
        load(dump_path), load(another_dump_path), "run_a", "run_b",
        output_filename,
    )
