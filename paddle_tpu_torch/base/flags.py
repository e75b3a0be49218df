"""Runtime flag registry (counterpart of ``paddle_tpu/base/flags.py``,
copied as is: pure stdlib, the same flags and defaults, so the two
packages read the same ``FLAGS_<name>`` environment).

The reference's homegrown gflags clone
(ref: paddle/common/flags.h:336 ExportedFlagInfoMap; ~200 flags in
paddle/phi/core/flags.cc) exposed as ``paddle.set_flags/get_flags``
(ref: python/paddle/base/framework.py:109).

Flags are typed, documented, env-overridable (``FLAGS_<name>`` env vars,
parsed lazily), and observable by subsystems via callbacks.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List


@dataclass
class _FlagInfo:
    name: str
    default: Any
    doc: str
    type: type
    value: Any = None
    callbacks: List[Callable[[Any], None]] = field(default_factory=list)


class _FlagRegistry:
    def __init__(self):
        self._flags: Dict[str, _FlagInfo] = {}
        self._lock = threading.RLock()

    def define(self, name: str, default, doc: str = ""):
        with self._lock:
            if name in self._flags:
                return self._flags[name]
            info = _FlagInfo(name, default, doc, type(default))
            env = os.environ.get(f"FLAGS_{name}")
            info.value = self._coerce(info, env) if env is not None else default
            self._flags[name] = info
            return info

    @staticmethod
    def _coerce(info: _FlagInfo, raw):
        if info.type is bool:
            if isinstance(raw, str):
                return raw.lower() in ("1", "true", "yes", "on")
            return bool(raw)
        if info.type in (int, float):
            return info.type(raw)
        return raw

    def set(self, name: str, value):
        with self._lock:
            if name not in self._flags:
                # auto-register unknown flags (matches the reference's lenient
                # phi flag handling for plugin-defined flags)
                self.define(name, value)
                return
            info = self._flags[name]
            info.value = self._coerce(info, value)
            for cb in info.callbacks:
                cb(info.value)

    def get(self, name: str):
        with self._lock:
            if name not in self._flags:
                raise KeyError(f"unknown flag {name!r}")
            return self._flags[name].value

    def on_change(self, name: str, cb: Callable[[Any], None]):
        with self._lock:
            self._flags[name].callbacks.append(cb)

    def all(self) -> Dict[str, Any]:
        with self._lock:
            return {k: v.value for k, v in self._flags.items()}


_registry = _FlagRegistry()
define_flag = _registry.define


def set_flags(flags: Dict[str, Any]):
    """paddle.set_flags parity."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict")
    for k, v in flags.items():
        _registry.set(k, v)


def get_flags(flags):
    """paddle.get_flags parity: str or list of str -> dict."""
    if isinstance(flags, str):
        flags = [flags]
    return {k: _registry.get(k) for k in flags}


def flag(name: str):
    return _registry.get(name)


def on_flag_change(name, cb):
    _registry.on_change(name, cb)


# ---------------------------------------------------------------------------
# Core flags (subset of the reference's catalogue that is meaningful on TPU).
define_flag("check_nan_inf", False, "Scan op outputs for NaN/Inf (debug sanitizer; ref FLAGS_check_nan_inf)")
define_flag("check_nan_inf_level", 0, "0: abort on nan/inf, >0: log only (ref FLAGS_check_nan_inf_level)")
define_flag("benchmark", False, "Block-until-ready after each op for timing")
define_flag("host_trace_level", 1, "Host tracer verbosity (ref FLAGS_host_trace_level)")
define_flag("comm_timeout_s", 1800.0, "Collective watchdog deadline seconds per blocking wait (ref comm_task_manager)")
define_flag("comm_abort_on_timeout", True, "Watchdog aborts the process on a timed-out wait so the launcher relaunches (ref async error handling)")
define_flag("comm_warn_fraction", 0.5, "Watchdog ladder: warn when a wait has consumed this fraction of its deadline")
define_flag("comm_dump_fraction", 0.75, "Watchdog ladder: all-thread stack dump at this fraction of the deadline (abort fires at 1.0)")
define_flag("enable_comm_dynamic_check", False, "Cross-rank shape/dtype check before collectives (ref FLAGS_enable_nccl_dynamic_check)")
define_flag("comm_flight_recorder_len", 128, "Collective flight recorder ring size: last-N collective signatures kept per rank (dumped by the watchdog, cross-checked by collective_contract)")
define_flag("use_stream_safe_allocator", True, "no-op on TPU; kept for parity")
define_flag("eager_delete_tensor_gb", 0.0, "no-op on TPU; kept for parity")
define_flag("log_level", 0, "VLOG-style verbosity for utils.log")
define_flag(
    "dy2static_while_grad_bound", 0,
    "When > 0, a converted tensor-`while` whose carries need gradients "
    "runs as a bounded differentiable lax.scan of this many iterations "
    "with an early-exit mask (the bound MUST cover the true trip count; "
    "extra iterations are masked no-ops). 0 keeps the non-differentiable "
    "lax.while_loop (ref: while backward, static/nn/control_flow.py:682)")
define_flag("allocator_strategy", "xla", "TPU: XLA owns allocation; kept for parity")
define_flag("cudnn_deterministic", False, "maps to XLA deterministic ops flag semantics")
