"""``to_static``: the train or eval step captured as a CUDA graph
(counterpart of ``paddle_tpu/jit``, whose ``jax.jit`` and ``lax.scan`` it
stands in for).

``to_static(fn, layers=, optimizers=, scalers=, full_graph=True)`` returns
a :class:`StaticFunction`. On the card, the first call with a given
argument signature (tensor shapes, dtypes and devices; the other
arguments' values) runs ``fn`` eagerly: it builds the kernels and creates
the optimizers' and scalers' state. The next call captures ``fn`` once as
a ``torch.cuda.CUDAGraph`` — forward, backward, ``step()``,
``clear_grad()`` and the scaler's ``update()``, whatever ``fn`` does — and
every call replays it. One graph per signature, as the reference keeps one
compiled program per argument structure, all in one memory pool of the
function. :meth:`StaticFunction.multi_step` copies each step's inputs into
the graph's inputs and replays K times, with no read back to the host
between replays. On CPU tensors (the tests) ``fn`` runs eagerly.

What a graph reads that changes from step to step lives on the device: the
learning rate of each optimizer is a device scalar the graph reads (filled
before each replay from ``get_lr()``, or from ``multi_step``'s
``lr_schedule``), the optimizers' and scalers' state is written in place,
and the port's random generators of the device (stochastic-rounding salts,
dropout) are registered with the graph, so each replay draws new numbers.
Host-side counters advance per replay by what the capture counted: each
optimizer's ``_global_step`` and the kernels' launch counts
(``ops.kernels.launch_counts``). ``GradScaler``'s skip counters advance only
on eager steps.

A capture that creates or rebinds optimizer state (a first step, a
``set_state_dict`` since the last call) puts the state back, runs that
call eagerly and captures the next one. ``full_graph=True`` (the
default) raises, with the reason, when the step cannot be captured (a host
read such as ``.item()``, a host branch on a device value).
``full_graph=False`` warns and runs the whole function eagerly from then
on, the reference's last resort; its piecewise split is not ported. ``enable_to_static(False)``
runs every function eagerly; ``not_to_static(fn)`` marks a function that
``to_static`` leaves eager.

A capture is the port's counterpart of an XLA compile: every listener
added with :func:`add_capture_listener` is called once per successful
capture with the program's name (``StaticFunction.name``, the function's
qualified name unless its owner names it) and the capture's wall seconds.
``obs.install_compile_events()`` counts them.
"""
from __future__ import annotations

import dis
import gc
import time
import types
import warnings
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = ["to_static", "not_to_static", "StaticFunction", "enable_to_static",
           "add_capture_listener", "remove_capture_listener"]

_enabled = [True]
_capture_listeners: List = []


def add_capture_listener(fn) -> None:
    """Call ``fn(program_name, seconds)`` after every successful capture
    (once per listener, however often it is added)."""
    if fn not in _capture_listeners:
        _capture_listeners.append(fn)


def remove_capture_listener(fn) -> None:
    """Stop calling ``fn``; a listener never added is ignored."""
    if fn in _capture_listeners:
        _capture_listeners.remove(fn)


def _notify_capture(name: str, seconds: float) -> None:
    for fn in list(_capture_listeners):
        fn(name, seconds)


def enable_to_static(flag: bool = True) -> None:
    """Globally run every ``to_static`` function eagerly (``False``), or
    capture again (``True``)."""
    _enabled[0] = bool(flag)


def not_to_static(fn):
    """Mark ``fn`` as one ``to_static`` leaves eager: it is never captured."""
    fn._not_to_static = True
    return fn


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _signature(tree):
    leaves, spec = pytree.tree_flatten(tree)
    return (spec, tuple(
        ("T", tuple(x.shape), x.dtype, str(x.device), x.requires_grad)
        if isinstance(x, torch.Tensor) else ("V", repr(x)) for x in leaves))


class _Captured:
    """One captured signature: the graph, its static inputs and output, the
    learning-rate buffers it reads, and the host counters a replay adds."""

    def __init__(self, graph, static_args, out, lr_bufs, step_delta,
                 count_delta):
        self.graph = graph
        self.static_args = static_args
        self.out = out
        self.lr_bufs = lr_bufs
        self.step_delta = step_delta
        self.count_delta = count_delta

    def load(self, args) -> None:
        for dst, src in zip(_tensors(self.static_args), _tensors(args)):
            dst.copy_(src)


class StaticFunction:
    """A step whose layers, optimizers and scalers are named up front (or
    found in ``fn``'s closure and globals at the first call, as the
    reference finds them)."""

    def __init__(self, fn, layers: Sequence[torch.nn.Module] = (),
                 optimizers: Sequence = (), scalers: Sequence = (),
                 full_graph: bool = True):
        if isinstance(layers, torch.nn.Module):
            layers = [layers]
        self._fn = fn
        # the program's name in capture events; an owner may rename it
        self.name = str(getattr(fn, "__qualname__", None)
                        or getattr(fn, "__name__", None) or repr(fn))
        self._layers = list(layers)
        self._optimizers = list(optimizers)
        self._scalers = list(scalers)
        self._needs_discovery = not (self._layers or self._optimizers
                                     or self._scalers)
        self._full_graph = bool(full_graph)
        self._fallback_eager = False
        self._warmed = set()  # signatures whose warm-up call ran
        self._graphs: Dict[Any, _Captured] = {}
        self._pool = None
        self._called = False

    # -- discovery ---------------------------------------------------------
    def _discover(self) -> None:
        """Layers, optimizers and scalers in ``fn``'s closure cells and the
        globals its code loads."""
        from ..amp.grad_scaler import AmpScaler
        from ..optimizer.optimizer import Optimizer

        fn = self._fn
        found = []
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                found.append(cell.cell_contents)
            except ValueError:
                pass
        if hasattr(fn, "__self__"):
            found.append(fn.__self__)
        code, glob = getattr(fn, "__code__", None), getattr(fn, "__globals__", None)
        if code is not None and glob is not None:
            names = set()

            def walk(co):
                for ins in dis.get_instructions(co):
                    if ins.opname == "LOAD_GLOBAL":
                        names.add(ins.argval)
                for const in co.co_consts:
                    if isinstance(const, types.CodeType):
                        walk(const)

            walk(code)
            found.extend(glob[n] for n in sorted(names) if n in glob)
        for obj in found:
            if isinstance(obj, torch.nn.Module) and obj not in self._layers:
                self._layers.append(obj)
            elif isinstance(obj, Optimizer) and obj not in self._optimizers:
                self._optimizers.append(obj)
            elif isinstance(obj, AmpScaler) and obj not in self._scalers:
                self._scalers.append(obj)

    def _params(self) -> List[torch.Tensor]:
        seen, out = set(), []
        for p in [*(p for m in self._layers for p in m.parameters()),
                  *(p for o in self._optimizers for p in o._parameter_list)]:
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
        return out

    def _device(self, args) -> Optional[torch.device]:
        """The CUDA device the step runs on, or None (run eagerly)."""
        for t in [*_tensors(args), *self._params()]:
            if t.device.type == "cuda":
                return t.device
        return None

    def _eager(self) -> bool:
        return (not _enabled[0] or self._fallback_eager
                or getattr(self._fn, "_not_to_static", False))

    # -- call ----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if self._needs_discovery:
            self._discover()
            self._needs_discovery = False
        self._called = True
        call_args = (args, kwargs)
        dev = None if self._eager() else self._device(call_args)
        if dev is None:
            return self._fn(*args, **kwargs)
        g = self._graph_for(call_args, dev)
        if g is None:  # a warm-up call, or the eager fallback
            return self._fn(*args, **kwargs)
        g.load(call_args)
        for buf, o in zip(g.lr_bufs, self._optimizers):
            buf.fill_(o.get_lr())
        self._replay(g)
        return pytree.tree_map(
            lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
            g.out)

    def _graph_for(self, call_args, dev) -> Optional[_Captured]:
        sig = _signature(call_args)
        g = self._graphs.get(sig)
        if g is not None:
            return g
        if sig not in self._warmed:
            self._warmed.add(sig)
            return None
        g = self._capture(call_args, dev)
        if g is not None:
            self._graphs[sig] = g
        return g

    def _replay(self, g: _Captured) -> None:
        from ..ops import kernels

        g.graph.replay()
        for o, d in zip(self._optimizers, g.step_delta):
            o._global_step += d
        kernels.add_launch_counts(g.count_delta)

    # -- capture ---------------------------------------------------------------
    def _generators(self, dev) -> List[torch.Generator]:
        from ..base import random as _random

        return [_random.get_generator(dev), _random.sr_generator(dev)]

    def _capture(self, call_args, dev) -> Optional[_Captured]:
        """Capture ``fn`` on static copies of the call's tensors. The
        capture records the step without running it: the caller replays
        it once for this call."""
        from ..ops import kernels

        t_capture = time.perf_counter()
        static = pytree.tree_map(
            lambda x: (x.detach().clone().requires_grad_(x.requires_grad)
                       if isinstance(x, torch.Tensor) else x), call_args)
        lr_bufs = [torch.zeros((), dtype=torch.float32, device=dev)
                   for _ in self._optimizers]
        steps0 = [o._global_step for o in self._optimizers]
        counts0 = kernels.launch_counts()
        state0 = [self._state_of(o) for o in self._optimizers]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators(dev):
            graph.register_generator_state(gen)
        sync_mode = torch.cuda.get_sync_debug_mode()
        for o, buf in zip(self._optimizers, lr_bufs):
            o._lr_override = buf
        err = inner = None
        # a CUDA graph freed while another is being captured breaks that
        # capture: the cyclic collector, which may free graphs left in
        # unreachable reference cycles (a dropped engine and its programs),
        # waits until the capture ends
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a CUDA call another thread makes meanwhile (a
            # router, a second engine's supervisor thread) cannot
            # invalidate this capture; the capturing thread's own
            # unsafe calls still raise
            with torch.cuda.device(dev), torch.cuda.graph(
                    graph, pool=self._pool,
                    capture_error_mode="thread_local"):
                # a host read during the capture raises here, with its place
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self._fn(*static[0], **static[1])
                except Exception as e:  # noqa: BLE001 - reported below
                    inner = e
                    raise
                finally:
                    torch.cuda.set_sync_debug_mode(sync_mode)
        except Exception as e:  # noqa: BLE001 - reported or re-raised below
            err = inner if inner is not None else e
        finally:
            if gc_was_on:
                gc.enable()
            for o in self._optimizers:
                o._lr_override = None
        step_delta = [o._global_step - s for o, s in zip(self._optimizers, steps0)]
        count_delta = kernels.count_delta(counts0, kernels.launch_counts())
        # the capture ran no device work: its host counters are the
        # replays' to add
        for o, s in zip(self._optimizers, steps0):
            o._global_step = s
        kernels.set_launch_counts(counts0)
        moved = [k for o, (ptrs, _) in zip(self._optimizers, state0)
                 for k, ptr in self._state_of(o)[0].items()
                 if ptrs.get(k) != ptr]
        if err is None and moved:
            # state created or rebound during the capture would be written
            # afresh on every replay (or read stale): put the state back as
            # it was, run this call eagerly, and capture the next one
            for o, (_, saved) in zip(self._optimizers, state0):
                o._accumulators, beta_vecs = saved
                if beta_vecs is not None:
                    o._beta_vecs = beta_vecs
            self._abandon_capture()
            return None
        if err is not None:
            self._abandon_capture()
            reason = f"{type(err).__name__}: {err}"
            if self._full_graph:
                raise RuntimeError(
                    "to_static could not capture the step as a CUDA graph "
                    f"(full_graph=True): {reason}") from err
            warnings.warn(
                "to_static(full_graph=False): the step cannot be captured as "
                f"a CUDA graph ({reason}); running the whole function "
                "eagerly from now on.", stacklevel=3)
            self._fallback_eager = True
            return None
        captured = _Captured(graph, static, out, lr_bufs, step_delta,
                             count_delta)
        _notify_capture(self.name, time.perf_counter() - t_capture)
        return captured

    @staticmethod
    def _state_of(o):
        """An optimizer's state: the address of each accumulator, and
        copies of its stores (and AdamW's beta-vector records) to put back
        after a capture that moved them."""
        ptrs = {(a, k): t.data_ptr() for a, store in o._accumulators.items()
                for k, t in store.items()}
        beta_vecs = getattr(o, "_beta_vecs", None)
        return ptrs, ({a: dict(st) for a, st in o._accumulators.items()},
                      None if beta_vecs is None else
                      {k: list(v) for k, v in beta_vecs.items()})

    def _abandon_capture(self) -> None:
        """After a failed capture: gradients the capture left are not
        values; the scalers' per-cycle state is reset."""
        for p in self._params():
            p.grad = None
        for s in self._scalers:
            s._opt_states.clear()
            s._interleave_snaps.clear()
            s._interleaved_opts.clear()

    # -- multi-step --------------------------------------------------------------
    def multi_step(self, *stacked_args, steps: Optional[int] = None,
                   lr_schedule=None):
        """K steps; returns the K outputs stacked, ``[K, ...]``, on the
        device.

        With ``steps=K`` the same arguments feed every step; without it,
        each tensor argument carries a leading axis of length K (per-step
        data). The learning rate is held at each optimizer's ``get_lr()``
        across the K steps unless ``lr_schedule`` gives it per step: a
        length-K sequence (or tensor), or a list of them, one per
        optimizer. Call the function once first (the warm-up call), as in
        the reference. On the card the K steps are K replays of the
        captured step with nothing read back to the host in between."""
        if self._needs_discovery:
            self._discover()
            self._needs_discovery = False
        if not self._called:
            raise RuntimeError(
                "multi_step requires one regular call first (to create "
                "optimizer state and cache the step's structure)")
        if steps is not None:
            n = int(steps)
            per_step = lambda t: stacked_args  # noqa: E731
        elif stacked_args:
            n = len(_tensors(stacked_args)[0])
            per_step = lambda t: pytree.tree_map(  # noqa: E731
                lambda a: a[t] if isinstance(a, torch.Tensor) else a,
                stacked_args)
        else:
            raise ValueError("multi_step needs steps= or stacked arguments")
        scheds = self._schedules(lr_schedule, n)
        dev = None if self._eager() else self._device((per_step(0), {}))
        if dev is None:
            return self._multi_step_eager(per_step, n, scheds)
        sig = _signature((per_step(0), {}))
        if sig not in self._warmed and sig not in self._graphs:
            raise RuntimeError(
                "multi_step requires one regular call first with the "
                "arguments of one step (their shapes, dtypes and devices)")
        g = self._graph_for((per_step(0), {}), dev)
        if g is None:  # a capture met new state, or full_graph=False fell back
            return self._multi_step_eager(per_step, n, scheds)
        lr_dev = [None if s is None else
                  torch.tensor(s, dtype=torch.float32).to(dev) for s in scheds]
        leaves, spec = pytree.tree_flatten(g.out)
        stacked = [torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
                   if isinstance(x, torch.Tensor) else None for x in leaves]
        for t in range(n):
            if steps is None or t == 0:
                g.load((per_step(t), {}))
            for buf, o, s in zip(g.lr_bufs, self._optimizers, lr_dev):
                if s is not None:
                    buf.copy_(s[t])
                elif t == 0:
                    buf.fill_(o.get_lr())
            self._replay(g)
            for buf, x in zip(stacked, leaves):
                if buf is not None:
                    buf[t].copy_(x)
        return pytree.tree_unflatten(
            [b if b is not None else x for b, x in zip(stacked, leaves)], spec)

    def _schedules(self, lr_schedule, n: int):
        if lr_schedule is None:
            return [None] * len(self._optimizers)
        if not (isinstance(lr_schedule, (list, tuple)) and lr_schedule
                and hasattr(lr_schedule[0], "__len__")):
            lr_schedule = [lr_schedule]  # one schedule: one optimizer
        if len(lr_schedule) != len(self._optimizers):
            raise ValueError(f"lr_schedule needs {len(self._optimizers)} "
                             f"entries, got {len(lr_schedule)}")
        out = []
        for s in lr_schedule:
            # the reference's schedule is f32: each rate rounded once
            vals = torch.as_tensor(s, dtype=torch.float32).reshape(-1)
            if vals.numel() != n:
                raise ValueError(f"lr_schedule: {vals.numel()} rates for "
                                 f"{n} steps")
            out.append(vals.tolist())
        return out

    def _multi_step_eager(self, per_step, n, scheds):
        held = [o.get_lr() for o in self._optimizers]
        outs = []
        try:
            for t in range(n):
                for o, h, s in zip(self._optimizers, held, scheds):
                    o._lr_override = h if s is None else s[t]
                args = per_step(t)
                outs.append(pytree.tree_map(
                    lambda x: x.detach() if isinstance(x, torch.Tensor) else x,
                    self._fn(*args)))
        finally:
            for o in self._optimizers:
                o._lr_override = None
        leaves0, spec = pytree.tree_flatten(outs[0])
        cols = list(zip(*(pytree.tree_flatten(o)[0] for o in outs)))
        return pytree.tree_unflatten(
            [torch.stack(c) if isinstance(c[0], torch.Tensor) else c[0]
             for c in cols], spec)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, layers=(), optimizers=(), scalers=(),
              full_graph=True, **kwargs):
    """``to_static(fn, layers=[...], optimizers=[...], scalers=[...])`` ->
    a :class:`StaticFunction` over ``fn``; ``to_static(module)`` makes the
    module's ``forward`` one. Usable as a decorator, with or without
    arguments."""

    def decorate(obj):
        if isinstance(obj, torch.nn.Module):
            obj.forward = StaticFunction(obj.forward, layers=[obj],
                                         full_graph=full_graph)
            return obj
        return StaticFunction(obj, layers=layers, optimizers=optimizers,
                              scalers=scalers, full_graph=full_graph)

    if function is not None:
        return decorate(function)
    return decorate
