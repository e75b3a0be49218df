"""A CPU stand-in of ``jit.StaticFunction``'s CUDA-graph capture, for the
parity tests on machines without a card.

Inside :func:`cpu_capture`, a ``StaticFunction`` over CPU tensors takes the
card's code paths: its first call with an argument signature is the eager
warm-up; the next one "captures" — the converted function runs under the
capture's rules (dy2static's select path on, and a host read of a tensor
refused with the error the card's sync debug mode raises), so a graph
break, ``full_graph`` and the piecewise split behave as on the card; every
later call "replays" — the converted function runs under the same rules on
the capture's static inputs, reading each optimizer's learning rate from
the graph's buffer, and writes its tensors into the capture's outputs. The
capturing call's run is that call's result (its replay runs nothing), so a
step is taken once per call, as on the card.

It lives here, outside the library, because the card's path has no use for
it: the library's ``StaticFunction`` only captures on CUDA devices.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["cpu_capture"]

# the ops that read a tensor's value on the host: .item(), bool(), float(),
# int()
_READS = ("_local_scalar_dense", "is_nonzero")


class _NoHostReads(TorchDispatchMode):
    """Refuses a host read of a tensor as the card's sync debug mode "error"
    does inside a capture (``jit`` reads that error as a graph break)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in _READS:
            raise RuntimeError(
                "called a synchronizing CUDA operation: the CPU stand-in of "
                f"a capture refuses {func}, a host read of a tensor")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _rules():
    from ..jit import dy2static

    with dy2static.select_mode(True, "cpu"), _NoHostReads():
        yield


class _Graph:
    """Stands in for a ``torch.cuda.CUDAGraph``: ``replay`` runs the
    converted function on the capture's static inputs and copies its
    tensors into the capture's outputs; the first replay, the capturing
    call's, runs nothing."""

    def __init__(self, sf):
        self._sf = sf
        self.captured = None  # the jit._Captured this graph belongs to
        self._ran = True

    def replay(self):
        if self._ran:
            self._ran = False
            return
        c, sf = self.captured, self._sf
        # a graph writes the gradient of a static input afresh each replay
        # (it had none when captured): the eager run must not accumulate
        for t in pytree.tree_leaves(c.static_args):
            if isinstance(t, torch.Tensor):
                t.grad = None
        for o, buf in zip(sf._optimizers, c.lr_bufs):
            o._lr_override = buf
        try:
            with _rules():
                out = sf._fn(*c.static_args[0], **c.static_args[1])
        finally:
            for o in sf._optimizers:
                o._lr_override = None
        with torch.no_grad():
            for dst, src in zip(pytree.tree_leaves(c.out),
                                pytree.tree_leaves(out)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)


def _capture(self, call_args, dev):
    """``StaticFunction._capture`` for CPU tensors: this call runs under
    the capture's rules on static copies of its tensors; a failure puts the
    training state back and is handled as a failed capture on the card."""
    from .. import jit

    t_capture = time.perf_counter()
    static = pytree.tree_map(
        lambda x: (x.detach().clone().requires_grad_(x.requires_grad)
                   if isinstance(x, torch.Tensor) else x), call_args)
    snap = self._snapshot_host_state()
    try:
        with _rules():
            out = self._fn(*static[0], **static[1])
    except Exception as err:  # noqa: BLE001 - handled as a failed capture
        self._abandon_capture()
        self._restore_host_state(snap)
        return self._capture_failed(err)
    del snap
    out = pytree.tree_map(
        lambda x: x.detach() if isinstance(x, torch.Tensor) else x, out)
    graph = _Graph(self)
    lr_bufs = [torch.zeros((), dtype=torch.float32) for _ in self._optimizers]
    # the runs count their own steps and launches: a replay adds nothing
    graph.captured = jit._Captured(graph, static, out, lr_bufs,
                                   [0] * len(self._optimizers), {})
    jit._notify_capture(self.name, time.perf_counter() - t_capture)
    return graph.captured


@contextlib.contextmanager
def cpu_capture():
    """Inside the block, ``StaticFunction``s over CPU tensors are captured
    and replayed by the stand-in above."""
    from ..jit import StaticFunction

    device, capture = StaticFunction._device, StaticFunction._capture

    def on_cpu(self, args):
        return device(self, args) or torch.device("cpu")

    def capture_on(self, call_args, dev):
        if dev.type == "cpu":
            return _capture(self, call_args, dev)
        return capture(self, call_args, dev)

    StaticFunction._device, StaticFunction._capture = on_cpu, capture_on
    try:
        yield
    finally:
        StaticFunction._device, StaticFunction._capture = device, capture
