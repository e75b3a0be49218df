"""Device/compile timeline hooks: CUDA-graph capture events on the obs
timeline and in the registry (counterpart of ``paddle_tpu/obs/compile.py``).

The reference counts XLA compilations from JAX's compile log records. The
port's counterpart of an XLA compile is a CUDA-graph capture: a
``jit.StaticFunction`` captures each argument signature once, on its
second call, and replays the graph from then on. ``jit`` calls its capture
listeners once per successful capture with the program's name and the
capture's wall seconds; this module is one such listener. A steady-state
recapture (a signature that keeps changing, a graph freed and taken
again) therefore shows up as a growing counter, the same failure contract
the reference's compile counter makes.

Install is explicit and idempotent (:func:`install_compile_events`);
:func:`uninstall_compile_events` detaches the listener again.

Series: counter ``graph_captures_total{program}``, histogram
``graph_capture_seconds{program}``; instants ``graph_capture`` and
``graph_capture_done`` on the ``compile`` tid. The names differ from the
reference's ``jax_compiles_total`` / ``jax_compile_seconds`` /
``xla_compile`` on purpose: they count another event.
"""
from __future__ import annotations

from .metrics import registry
from .trace import instant

__all__ = [
    "install_compile_events",
    "uninstall_compile_events",
    "compile_events_installed",
    "on_capture",
]


def on_capture(program: str, seconds: float) -> None:
    """Record one finished capture of ``program`` that took ``seconds``."""
    try:
        name = str(program)
        instant("graph_capture", tid="compile", program=name)
        registry().counter(
            "graph_captures_total", {"program": name},
            help="CUDA-graph captures by program name").inc()
        registry().histogram(
            "graph_capture_seconds", {"program": name},
            help="CUDA-graph capture wall time by program"
        ).observe(float(seconds))
        instant("graph_capture_done", tid="compile", program=name,
                seconds=float(seconds))
    except Exception:  # noqa: BLE001 — telemetry must never fail a capture
        pass


def compile_events_installed() -> bool:
    from .. import jit

    return on_capture in jit._capture_listeners


def install_compile_events() -> None:
    """Attach the capture listener to ``jit`` (idempotent)."""
    from .. import jit

    jit.add_capture_listener(on_capture)


def uninstall_compile_events() -> None:
    """Detach the capture listener (idempotent)."""
    from .. import jit

    jit.remove_capture_listener(on_capture)
