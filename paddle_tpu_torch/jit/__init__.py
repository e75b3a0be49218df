"""``to_static``: the train or eval step captured as a CUDA graph
(counterpart of ``paddle_tpu/jit``, whose ``jax.jit`` and ``lax.scan`` it
stands in for), and ``save``/``load`` of a layer for inference.

``to_static(fn, layers=, optimizers=, scalers=, full_graph=True)`` returns
a :class:`StaticFunction`. As in the reference, ``fn`` first goes through
``dy2static.convert``: a Python ``if``/``while``/``for range()`` on a
tensor becomes a runtime dispatch that, inside a capture, selects between
both branches with ``torch.where`` (a ``while`` runs as a bounded masked
loop under ``FLAGS_dy2static_while_grad_bound``), and outside one reads
the predicate on the host as Python would. On the card, the first call
with a given argument signature (tensor shapes, dtypes and devices; the
other arguments' values) runs ``fn`` eagerly: it builds the kernels and
creates the optimizers' and scalers' state. The next call captures the
converted ``fn`` once as a ``torch.cuda.CUDAGraph`` — forward, backward,
``step()``, ``clear_grad()`` and the scaler's ``update()``, whatever ``fn``
does — and every call replays it. One graph per signature, as the
reference keeps one compiled program per argument structure, all in one
memory pool of the function. :meth:`StaticFunction.multi_step` copies each
step's inputs into the graph's inputs and replays K times, with no read
back to the host between replays. On CPU tensors ``fn`` runs eagerly
(``testing.capture.cpu_capture`` gives the parity tests a CPU stand-in of
the capture).

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
call eagerly and captures the next one. A host read of a device value
inside the capture (``.item()``, ``float(loss)``, a branch the conversion
could not rewrite) is a graph break. ``full_graph=True`` (the default)
raises it as :class:`dy2static.GraphBreakError`, with the place and the
rewrite options. ``full_graph=False`` does the reference's piecewise
split: the function is cut at the breaking top-level statement
(``dy2static.split_at_break``); the prefix and the suffix become
``StaticFunction``s of their own over the same layers, optimizers and
scalers, each captured as its own graph, and the breaking statement runs
eagerly on every call. Where no safe split exists, or a carried tensor
still requires grad while the code after the break differentiates, the
whole function runs eagerly from then on. The split's first call is its
trial: it takes a snapshot of the training state, and a trial that proves
unsafe puts the state back before the eager rerun. Later calls take no
snapshot (it would be a second copy of the state at every step): one whose
carry proves unsafe finishes eagerly from where it stands. ``enable_to_static(False)`` runs
every function eagerly; ``not_to_static(fn)`` marks a function that
``to_static`` leaves eager.

A capture is the port's counterpart of an XLA compile: every listener
added with :func:`add_capture_listener` is called once per successful
capture with the program's name (``StaticFunction.name``, the function's
qualified name unless its owner names it) and the capture's wall seconds.
``obs.install_compile_events()`` counts them.

``save(layer, path, input_spec=)`` writes ``{path}.pdiparams`` (the state
as pickled numpy arrays; bf16 as raw ``uint16``, since numpy has no
bfloat16) and ``{path}.pdmodel`` (pickled meta). With an ``input_spec``
the meta holds a ``torch.export`` program of the layer's eval-mode forward
with the parameters and buffers as explicit inputs, so the weights are
stored once. ``load`` returns a :class:`TranslatedLayer` over that program
(the flash forward runs in it as the registered operator
``paddle_tpu_torch::flash_fwd``), or the state dict when there is none.
"""
from __future__ import annotations

import dis
import gc
import io
import os
import pickle
import time
import types
import warnings
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from . import dy2static
from .dy2static import GraphBreakError

__all__ = ["to_static", "not_to_static", "StaticFunction", "enable_to_static",
           "add_capture_listener", "remove_capture_listener", "save", "load",
           "TranslatedLayer", "dy2static", "GraphBreakError"]

_enabled = [True]
_capture_listeners: List = []


def _is_host_read(err: BaseException) -> bool:
    """Whether a capture's error is a graph break: a host read of a device
    value (the card's sync debug mode, a call CUDA refuses while capturing)
    or a construct dy2static cannot capture."""
    if isinstance(err, GraphBreakError):
        return True
    msg = str(err)
    return isinstance(err, RuntimeError) and (
        "synchronizing CUDA operation" in msg
        or "operation not permitted when stream is capturing" in msg)


class _CaptureBreak(Exception):
    """A capture under ``full_graph=False`` met a graph break; carries the
    :class:`GraphBreakError` with the frames to split at."""

    def __init__(self, error: GraphBreakError):
        super().__init__(str(error))
        self.error = error


class _PiecewiseUnsafe(RuntimeError):
    """A piecewise split was built but is unsafe at runtime: a carried
    value of another type than tensors and numbers, or (``grad``) a carried
    tensor that requires grad while the code after the break
    differentiates."""

    def __init__(self, msg: str, grad: bool = False):
        super().__init__(msg)
        self.grad = grad


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
        # no_grad: a static input may require grad (a leaf the step
        # differentiates), and an in-place copy into such a leaf is refused
        with torch.no_grad():
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
        self._orig_fn = fn
        # dy2static: tensor-dependent if/while/for become runtime dispatch
        # (select under a capture, plain Python otherwise)
        self._fn = dy2static.convert(fn)
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
        self._piecewise = None  # set after a successful graph-break split
        self._split_depth = 0  # recursion guard for nested splits
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

        fn = self._orig_fn
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
                or getattr(self._orig_fn, "_not_to_static", False))

    # -- call ----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if self._needs_discovery:
            self._discover()
            self._needs_discovery = False
        self._called = True
        if self._piecewise is not None and not self._eager():
            return self._call_piecewise(args, kwargs)
        call_args = (args, kwargs)
        dev = None if self._eager() else self._device(call_args)
        if dev is None:
            return self._orig_fn(*args, **kwargs)
        try:
            g = self._graph_for(call_args, dev)
        except _CaptureBreak as brk:
            # split outside the handler: the failed capture's frames (and
            # the autograd graph they hold) go with the exception
            g = brk.error
        if isinstance(g, GraphBreakError):
            return self._split(g, args, kwargs)
        if g is None:  # a warm-up call, or the eager fallback
            # detached, as a replay's: an autograd graph the caller keeps
            # alive into the next call (the capture) would tie the
            # capture's backward to this call's stream
            return pytree.tree_map(
                lambda x: x.detach() if isinstance(x, torch.Tensor) else x,
                self._orig_fn(*args, **kwargs))
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
                    with dy2static.select_mode(True, dev.type):
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
            return self._capture_failed(err)
        captured = _Captured(graph, static, out, lr_bufs, step_delta,
                             count_delta)
        _notify_capture(self.name, time.perf_counter() - t_capture)
        return captured

    def _capture_failed(self, err: BaseException) -> None:
        """A capture raised ``err``: a graph break raises
        :class:`GraphBreakError` (``full_graph=True``) or asks the caller to
        split (``_CaptureBreak``); any other error raises, or makes the
        function eager from now on (``full_graph=False``)."""
        if _is_host_read(err):
            brk = dy2static.graph_break_error(err)
            if isinstance(err, GraphBreakError):  # dy2static's own words
                brk.args = err.args
            if self._full_graph:
                raise GraphBreakError(
                    "to_static could not capture the step as a CUDA graph "
                    f"(full_graph=True): {brk}") from err
            raise _CaptureBreak(brk) from None
        reason = f"{type(err).__name__}: {err}"
        if self._full_graph:
            raise RuntimeError(
                "to_static could not capture the step as a CUDA graph "
                f"(full_graph=True): {reason}") from err
        warnings.warn(
            "to_static(full_graph=False): the step cannot be captured as "
            f"a CUDA graph ({reason}); running the whole function "
            "eagerly from now on.", stacklevel=4)
        self._fallback_eager = True
        return None

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

    # -- piecewise capture (full_graph=False) ------------------------------
    def _call_piecewise(self, args, kwargs):
        """A call of the split function after its trial. It takes no
        snapshot of the training state. A later call can still prove unsafe
        (the break may bind another type on another branch): the call then
        finishes eagerly from where it stands — the prefix ran as the eager
        function would have — and the function runs eagerly from the next
        call on. A carried tensor that requires grad while the code after
        the break differentiates cannot be finished so (its history through
        the captured prefix is gone): that raises, and the prefix's effects
        stand."""
        def demote(why):
            warnings.warn(
                "to_static(full_graph=False): piecewise capture became "
                f"unsafe ({why}); this call finishes eagerly and the whole "
                "function runs eagerly from now on.", stacklevel=5)
            self._piecewise = None
            self._fallback_eager = True

        try:
            return self._piecewise.later(args, kwargs, demote)
        except _PiecewiseUnsafe as why:
            self._piecewise = None
            self._fallback_eager = True
            raise RuntimeError(
                "to_static(full_graph=False): piecewise capture became "
                f"unsafe on a later call ({why}); the captured prefix has "
                "run and its effects stand; the whole function runs eagerly "
                "from the next call on") from None

    def _split(self, err: GraphBreakError, args, kwargs):
        """After a graph break under ``full_graph=False``: split the
        function at the breaking statement and run this call piecewise (the
        trial, the one call that takes a snapshot of the training state),
        or, where no safe split exists, run it and every later call
        eagerly."""
        if self._split_depth < 3:
            piecewise = self._build_piecewise(err)
            if piecewise is not None:
                snap = self._snapshot_host_state()
                try:
                    out = piecewise(*args, **kwargs)
                except Exception as why:  # noqa: BLE001 - demoted below
                    # any failure of the trial demotes: the state goes back
                    # first, so a prefix that stepped an optimizer does not
                    # step twice; a user's own error re-raises from the
                    # eager run below with clean state
                    self._restore_host_state(snap)
                    warnings.warn(
                        "to_static(full_graph=False): piecewise capture "
                        f"unsafe ({why}); falling back to whole-function "
                        "eager execution.", stacklevel=3)
                else:
                    info = piecewise._info
                    warnings.warn(
                        "to_static(full_graph=False): graph break at line "
                        f"{info['line']} ({info['stmt']!r}) — piecewise "
                        "capture: prefix and suffix run captured, each its "
                        "own graph; only the breaking statement runs "
                        "eagerly each call (host side effects re-execute; "
                        f"carried locals: {info['carry1']}).", stacklevel=3)
                    self._piecewise = piecewise
                    return out
        warnings.warn(
            "to_static(full_graph=False): graph break — the step cannot be "
            "captured as a CUDA graph and no safe split exists; running "
            f"{getattr(self._orig_fn, '__qualname__', self._orig_fn)} "
            f"eagerly from now on. Reason: {err}", stacklevel=3)
        self._fallback_eager = True
        return self._orig_fn(*args, **kwargs)

    def _build_piecewise(self, err: GraphBreakError):
        """The split execution path after a graph break, or None.

        ``dy2static.split_at_break`` cuts ``fn`` at the breaking top-level
        statement; the prefix and the suffix become StaticFunctions over
        this one's layers, optimizers and scalers (each its own graph), and
        the breaking statement runs eagerly each call. Runtime rules:
        carried values are tensors or numbers, and where the code after the
        break differentiates, no carried tensor may require grad (a
        captured prefix hands its outputs over detached); on the trial a
        violation raises ``_PiecewiseUnsafe`` and the caller demotes. The
        returned function's ``later(args, kwargs, demote)`` runs a later
        call: a carry of another type calls ``demote`` and finishes the
        call eagerly (the break and the suffix's plain code on the carry as
        it is); a carried tensor that requires grad still raises."""
        import inspect

        fn = self._orig_fn
        code = getattr(fn, "__code__", None)
        if code is None:
            return None
        src_file = code.co_filename
        src_base = getattr(inspect.unwrap(fn), "__code__", code).co_firstlineno
        # every same-file frame, deepest first: a break inside a same-file
        # helper maps outside this function's body, but the call-site
        # frame still splits; converted code carries lines relative to the
        # function start
        parts = None
        for f, ln in getattr(err, "frames", ()):
            if f == src_file:
                line = ln
            elif f == f"<dy2static:{src_file}>":
                line = src_base + ln - 1
            else:
                continue
            parts = dy2static.split_at_break(fn, line)
            if parts is not None:
                break
        if parts is None:
            return None
        pre_fn, brk_fn, suf_fn, info = parts
        kw = dict(layers=self._layers, optimizers=self._optimizers,
                  scalers=self._scalers, full_graph=False)
        pre_sf = StaticFunction(pre_fn, **kw)
        suf_sf = StaticFunction(suf_fn, **kw)
        pre_sf.name, suf_sf.name = f"{self.name}:prefix", f"{self.name}:suffix"
        pre_sf._split_depth = suf_sf._split_depth = self._split_depth + 1
        differentiates = info["differentiates"]

        def unsafe(carry, stage) -> Optional[_PiecewiseUnsafe]:
            for k, v in carry.items():
                if isinstance(v, torch.Tensor):
                    if differentiates and v.requires_grad:
                        return _PiecewiseUnsafe(
                            f"{stage} carries tensor {k!r}, which requires "
                            "grad, across the split while the code after "
                            "the break differentiates — a captured prefix "
                            "hands it over without its grad history",
                            grad=True)
                elif not isinstance(v, (int, float, bool, complex,
                                        type(None))):
                    return _PiecewiseUnsafe(
                        f"{stage} carries non-tensor value {k!r} of type "
                        f"{type(v).__name__}")
            return None

        def detached(carry):
            # what a captured prefix hands over, on every call alike: a
            # backward through a carry raises instead of silently missing
            # the prefix's graph (the reference's carry marks)
            return {k: v.detach() if isinstance(v, torch.Tensor) else v
                    for k, v in carry.items()}

        def run(args, kw, demote):
            carry = pre_sf(*args, **kw)
            carry2 = None
            why = unsafe(carry, "prefix")
            if why is None:
                carry2 = brk_fn(detached(carry))
                why = unsafe(carry2, "break")
                if why is None:
                    return suf_sf(detached(carry2))
            if demote is None or why.grad:
                raise why
            demote(why)
            if carry2 is None:
                carry2 = brk_fn(carry)
            return suf_fn(carry2)

        def piecewise(*args, **kw):
            return run(args, kw, None)

        piecewise.later = run
        piecewise._info = info
        piecewise._prefix_sf, piecewise._suffix_sf = pre_sf, suf_sf
        return piecewise

    # -- training state snapshot (piecewise trial safety) --------------------
    def _generators_of(self) -> List[torch.Generator]:
        from ..base import random as _random

        devs = {p.device for p in self._params()}
        return [g for d in sorted(devs, key=str)
                for g in (_random.get_generator(d), _random.sr_generator(d))]

    def _snapshot_host_state(self):
        """Copies of the training state a prefix could commit: parameters,
        buffers and gradients, the optimizers' accumulators and step
        counts, the scalers' state and the generators. Makes a piecewise
        attempt atomic: if it proves unsafe mid-call the state goes back
        before the eager rerun (else a prefix that stepped the optimizer
        would step again). State is written in place on restore, so
        captured graphs keep their addresses."""
        params = self._params()
        bufs = [b for m in self._layers for b in m.buffers()]
        with torch.no_grad():
            return {
                "values": [(t, t.detach().clone()) for t in params + bufs],
                "grads": [(p, None if p.grad is None else p.grad.detach().clone())
                          for p in params],
                "optim": [(o, {a: {k: t.clone() for k, t in st.items()}
                               for a, st in o._accumulators.items()},
                           o._global_step, self._state_of(o)[1][1])
                          for o in self._optimizers],
                "scalers": [(s, [None if t is None else t.clone() for t in
                                 (s._scale, s._good_steps, s._bad_steps,
                                  s._found_inf)],
                             (s._n_skipped_steps, s._last_skip_step,
                              s._n_updates)) for s in self._scalers],
                "rng": [(g, g.get_state()) for g in self._generators_of()],
            }

    def _restore_host_state(self, snap) -> None:
        with torch.no_grad():
            for t, v in snap["values"]:
                t.copy_(v)
            for p, g in snap["grads"]:
                if g is None:
                    p.grad = None
                elif p.grad is None or p.grad.shape != g.shape:
                    p.grad = g
                else:
                    p.grad.copy_(g)
            for o, accs, step, beta_vecs in snap["optim"]:
                live = o._accumulators
                kept = {}
                for a, st in accs.items():
                    cur = live.get(a, {})
                    kept[a] = {}
                    for k, v in st.items():
                        t = cur.get(k)
                        if t is not None and t.shape == v.shape:
                            t.copy_(v)
                            kept[a][k] = t
                        else:
                            kept[a][k] = v
                o._accumulators = kept
                o._global_step = step
                if beta_vecs is not None:
                    o._beta_vecs = beta_vecs
            for s, tensors, counters in snap["scalers"]:
                live = [s._scale, s._good_steps, s._bad_steps, s._found_inf]
                for i, (cur, v) in enumerate(zip(live, tensors)):
                    if v is None or cur is None:
                        live[i] = v
                    else:
                        cur.copy_(v)
                (s._scale, s._good_steps, s._bad_steps, s._found_inf) = live
                (s._n_skipped_steps, s._last_skip_step, s._n_updates) = counters
                s._opt_states.clear()
                s._interleave_snaps.clear()
                s._interleaved_opts.clear()
            for g, st in snap["rng"]:
                g.set_state(st)

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
        if self._fallback_eager or self._piecewise is not None:
            raise RuntimeError(
                "multi_step requires full-graph capture, but this "
                "function hit a graph break (full_graph=False) and runs "
                "piecewise or eagerly; fix the break or use full_graph=True")
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
                    self._orig_fn(*args)))
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


# ---------------------------------------------------------------------------
# save / load (reference: jit.save / jit.load, its StableHLO export replaced
# by a torch.export program)
# ---------------------------------------------------------------------------

FORMAT = "paddle_tpu_torch.jit.v1"
_REFERENCE_FORMAT = "paddle_tpu.jit.v1"


def _spec_of(s, device: torch.device) -> torch.Tensor:
    """An example input for one ``input_spec`` entry: a ``(shape, dtype)``
    pair or any object with ``.shape`` and ``.dtype`` (the reference's
    ``static.InputSpec`` included)."""
    from ..base.dtype import to_torch_dtype

    if hasattr(s, "shape"):
        shape, dtype = s.shape, getattr(s, "dtype", None) or "float32"
    else:
        shape = s[0]
        dtype = s[1] if len(s) > 1 else "float32"
    if any(d is None or int(d) < 0 for d in shape):
        raise ValueError(f"jit.save: input_spec shape {tuple(shape)} has a "
                         "dynamic dimension; give every dimension")
    if not isinstance(dtype, (str, torch.dtype)):
        dtype = getattr(dtype, "name", None) or str(dtype)
    return torch.zeros(tuple(int(d) for d in shape),
                       dtype=to_torch_dtype(dtype), device=device)


class _PureForward(torch.nn.Module):
    """``layer``'s forward with its parameters and buffers as explicit
    inputs (``torch.func.functional_call``), the reference's
    ``pure_forward(param_arrays, buffer_arrays, *xs)``. The layer is held
    outside the module tree, so an export stores no weights."""

    def __init__(self, layer, param_names, buffer_names):
        super().__init__()
        self._held = [layer]
        self._names = (list(param_names), list(buffer_names))

    def forward(self, params, buffers, *xs):
        pn, bn = self._names
        state = {**dict(zip(pn, params)), **dict(zip(bn, buffers))}
        return torch.func.functional_call(self._held[0], state, xs)


def save(layer, path, input_spec=None, **config):
    """Save a layer for inference: ``{path}.pdiparams`` (the state dict as
    numpy arrays, bf16 as raw ``uint16``) and ``{path}.pdmodel`` (meta:
    ``format``, ``class``, ``param_names``, ``buffer_names``, ``exported``,
    and the names stored as ``uint16`` bf16). With ``input_spec`` (a list of
    ``(shape, dtype)`` pairs or objects with ``.shape``/``.dtype``),
    ``exported`` is a ``torch.export`` program of the eval-mode forward on
    the layer's device, whose parameters and buffers are inputs."""
    from ..framework.io import to_numpy

    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    param_names = [k for k, _ in layer.named_parameters()]
    buffer_names = [k for k, _ in layer.named_buffers()]
    tensors = {**layer.state_dict(), **dict(layer.named_buffers())}
    state = {k: to_numpy(v) for k, v in tensors.items()}
    bf16 = sorted(k for k, v in tensors.items() if v.dtype == torch.bfloat16)
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump(state, f, protocol=4)

    exported, device = None, None
    if input_spec is not None:
        params = tuple(p.detach() for _, p in layer.named_parameters())
        buffers = tuple(b for _, b in layer.named_buffers())
        device = (params or buffers)[0].device if (params or buffers) \
            else torch.device("cpu")
        xs = [_spec_of(s, device) for s in input_spec]
        was_training = layer.training
        layer.eval()
        try:
            with torch.no_grad():
                program = torch.export.export(
                    _PureForward(layer, param_names, buffer_names),
                    (params, buffers, *xs), strict=False)
        finally:
            layer.train(was_training)
        # the example inputs are the weights: the program keeps none of them
        try:
            program.example_inputs = None
        except AttributeError:  # a torch whose property has no setter
            program._example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf)
        exported = buf.getvalue()

    meta = {
        "format": FORMAT,
        "class": type(layer).__name__,
        "param_names": param_names,
        "buffer_names": buffer_names,
        "exported": exported,
        "bfloat16": bf16,
        "device": None if device is None else device.type,
    }
    with open(path + ".pdmodel", "wb") as f:
        pickle.dump(meta, f, protocol=4)


class TranslatedLayer:
    """Inference-only callable over a loaded ``torch.export`` program
    (reference: ``jit/translated_layer.py``): ``num_inputs`` data inputs,
    the weights fed from ``.pdiparams`` on every call."""

    def __init__(self, program, params, buffers):
        self._program = program
        self._module = program.module()
        self._params = tuple(params)
        self._buffers = tuple(buffers)
        n_state = len(self._params) + len(self._buffers)
        # data-input arity: the program's inputs minus the weights (the
        # Predictor sizes its feed slots from this)
        self.num_inputs = max(
            len(program.graph_signature.user_inputs) - n_state, 1)

    @property
    def program(self):
        """The ``torch.export.ExportedProgram``."""
        return self._program

    def __call__(self, *xs):
        with torch.no_grad():
            return self._module(self._params, self._buffers, *xs)

    def eval(self):
        return self

    def train(self, mode: bool = True):
        raise RuntimeError("TranslatedLayer is inference-only (exported)")


class ForeignProgramError(ValueError):
    """A ``.pdmodel`` whose program the port cannot run (a StableHLO export
    of the JAX package). ``state`` holds the ``.pdiparams`` it read."""

    def __init__(self, msg, state):
        super().__init__(msg)
        self.state = state


def _program_on(meta, dev: torch.device):
    """The exported program of ``meta`` with its device arguments moved to
    ``dev``. Tracing asked no device of the flash path (see
    ``nn.functional.attention._use_flash``), so a program saved on the CPU
    holds the same ``paddle_tpu_torch::flash_fwd`` nodes as one saved on the
    card, and launches the kernel there."""
    program = torch.export.load(io.BytesIO(meta["exported"]))
    if meta.get("device") and meta["device"] != dev.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    return program


def load(path, device=None, **config):
    """Load a :func:`save`'d model: a :class:`TranslatedLayer` on
    ``device`` (default the CUDA card, which raises where CUDA is absent;
    ``"cpu"`` on request) when the files hold a program, else the state
    dict as tensors on the host. A reference ``.pdmodel`` with a StableHLO
    program raises :class:`ForeignProgramError`, which carries the state
    read from its ``.pdiparams``."""
    from ..base.device import get_device
    from ..framework.io import from_numpy
    from ..ops import flash_attention  # noqa: F401 - registers paddle_tpu_torch::flash_fwd

    with open(path + ".pdmodel", "rb") as f:
        meta = pickle.load(f)
    with open(path + ".pdiparams", "rb") as f:
        raw = pickle.load(f)
    bf16 = set(meta.get("bfloat16") or ())
    state = {k: from_numpy(v, k in bf16) for k, v in raw.items()}
    if not meta.get("exported"):
        return state
    if meta.get("format") != FORMAT:
        raise ForeignProgramError(
            f"{path}.pdmodel holds a program of format "
            f"{meta.get('format')!r} (a StableHLO export of the JAX package), "
            "which the port cannot run; its weights were read from "
            f"{path}.pdiparams (this error's .state): build the layer in "
            "paddle_tpu_torch, load them and save it with "
            "paddle_tpu_torch.jit.save", state)
    dev = get_device(device)
    program = _program_on(meta, dev)
    params = [state[k].to(dev) for k in meta["param_names"]]
    buffers = [state[k].to(dev) for k in meta["buffer_names"]]
    return TranslatedLayer(program, params, buffers)
