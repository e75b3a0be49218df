"""Collective communication (counterpart of
``paddle_tpu/distributed/communication/__init__.py``), over
``torch.distributed``.

The reference runs a collective traced over a mesh axis by one controller,
or eagerly between launched processes (its multi-controller mode). The port
has no mesh: one process per rank is its only mode, so every collective
here is the eager multi-process one. The contract is the reference's: all
ranks of the group call the same collectives in the same order, with
matching shapes and dtypes; ``src``/``dst`` are global ranks. Each call
records its signature in the flight recorder before it runs
(``flight_recorder.record``; ``flight_recorder.contract`` cross-checks two
ranks' schedules), and its host wait runs under the collective watchdog
(``watchdog.watch``). In-place and return conventions are the
reference's: ``all_reduce`` writes its input and returns None when sync;
``sync_op=False`` returns a task whose ``wait()`` finishes it.

Backends. NCCL takes CUDA tensors only, for every collective. Gloo takes
CPU tensors for every collective, and CUDA tensors only for the ones in
``DEVICE_OPS["gloo"]`` (``all_reduce`` and ``broadcast``, the documented
ones); for any other collective a CUDA tensor under gloo is copied through
pinned host memory and back, and the bytes each collective staged are
counted (:func:`staged_bytes`). The table decides; nothing tries an op and
falls back. Under gloo a collective is a host operation, so inside a
``jit.to_static`` capture it is a graph break (``GraphBreakError``); under
NCCL it is captured into the graph. ``ReduceOp.AVG`` is the sum divided by
the group size, as the reference's ``pmean`` is.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..collective import Group, ReduceOp, _get_global_group
from . import flight_recorder
from .watchdog import watch

__all__ = ["flight_recorder", "all_reduce", "all_gather", "all_gather_object",
           "all_gather_into_tensor", "reduce", "broadcast", "reduce_scatter",
           "scatter", "gather", "alltoall", "alltoall_single", "send", "recv",
           "p2p_sendrecv", "ppermute", "barrier", "get_rank_in_trace",
           "DEVICE_OPS", "staged_bytes", "reset_staged_bytes"]

_ALL_OPS = frozenset({
    "all_reduce", "all_gather", "all_gather_object", "all_gather_into_tensor",
    "reduce", "broadcast", "reduce_scatter", "scatter", "gather", "alltoall",
    "alltoall_single", "send", "recv", "p2p_sendrecv", "ppermute",
    "barrier"})
# the collectives each backend takes on CUDA tensors; gloo stages the rest
# through pinned host memory, NCCL takes no CPU tensor at all
DEVICE_OPS: Dict[str, frozenset] = {
    "nccl": _ALL_OPS,
    "gloo": frozenset({"all_reduce", "broadcast"}),
}

_staged: Dict[str, int] = {}
# torch 2.13 renamed all_gather_into_tensor (same arguments)
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


def staged_bytes() -> Dict[str, int]:
    """Bytes copied through host memory per collective (both directions)
    since the last :func:`reset_staged_bytes`."""
    return dict(_staged)


def reset_staged_bytes() -> None:
    _staged.clear()


def _resolve(group: Optional[Group]) -> Group:
    if group is not None:
        return group
    from ..collective import is_initialized

    if not is_initialized():
        from ..parallel import init_parallel_env

        init_parallel_env()
    return _get_global_group()


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}  # AVG: the sum, then / n
_OP_KIND = {ReduceOp.SUM: "sum", ReduceOp.MAX: "max", ReduceOp.MIN: "min",
            ReduceOp.PROD: "prod", ReduceOp.AVG: "avg"}


def _torch_op(op: int):
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown ReduceOp {op}")
    return _TORCH_OPS[op]


def _capturing(t: torch.Tensor) -> bool:
    """Whether ``t``'s device is inside a ``jit.to_static`` capture (the
    card's stream capture, or the select mode a capture turns on)."""
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return True
    from ...jit import dy2static

    mode = dy2static._select[0]
    return mode is not None and mode in ("", t.device.type)


class _Plan:
    """How one collective runs on ``group``: on the tensors as they are, or
    staged through pinned host memory."""

    def __init__(self, g: Group, name: str, tensors: Sequence[torch.Tensor]):
        self.g, self.name = g, name
        backend = g.backend
        cuda = any(t.is_cuda for t in tensors)
        if backend == "nccl" and not cuda:
            raise RuntimeError(f"{name}: the NCCL backend takes CUDA tensors "
                               "only")
        if backend not in DEVICE_OPS:
            raise RuntimeError(f"{name}: unsupported backend {backend!r}")
        self.stage = cuda and name not in DEVICE_OPS[backend]
        if backend == "gloo" and any(_capturing(t) for t in tensors):
            from ...jit import GraphBreakError

            raise GraphBreakError(
                f"{name} under the gloo backend is a host operation: it "
                "cannot live inside a captured CUDA graph (run the step "
                "eagerly, split it with to_static(full_graph=False), or use "
                "NCCL)")

    def host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend reads it: itself, or a pinned host copy."""
        if not (self.stage and t.is_cuda):
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        _staged[self.name] = _staged.get(self.name, 0) + t.numel() * t.element_size()
        return h

    def empty_like(self, t: torch.Tensor, shape=None) -> torch.Tensor:
        """An output buffer where the backend writes (host when staged)."""
        shape = t.shape if shape is None else shape
        if self.stage and t.is_cuda:
            return torch.empty(shape, dtype=t.dtype, pin_memory=True)
        return torch.empty(shape, dtype=t.dtype, device=t.device)

    def result(self, o: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """An output on ``like``'s device (``o`` itself unless staged)."""
        if not (self.stage and like.is_cuda):
            return o
        res = torch.empty(o.shape, dtype=o.dtype, device=like.device)
        self.back(res, o)
        return res

    def back(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Write a result into ``dst`` (from host memory when staged)."""
        if src is dst:
            return
        if self.stage and dst.is_cuda and not src.is_cuda:
            _staged[self.name] = (_staged.get(self.name, 0)
                                  + src.numel() * src.element_size())
        dst.copy_(src)


class _Task:
    """What ``sync_op=False`` returns: ``wait()`` waits for the backend's
    work (under the watchdog) and then finishes the call (the copy back of
    a staged result, the division of an average)."""

    def __init__(self, works, finish=None, desc: str = ""):
        self._works = [w for w in works if w is not None]
        self._finish = finish
        self._desc = desc
        self._done = False

    def wait(self) -> bool:
        if not self._done:
            with watch(self._desc):
                for w in self._works:
                    w.wait()
            if self._finish is not None:
                self._finish()
            self._done = True
        return True

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)


def _run(g: Group, desc: str, launch, finish=None, sync_op: bool = True):
    """Launch the backend's work (``launch(async_op)`` returns works), then
    wait and finish it now (sync) or in the task's ``wait()``."""
    if sync_op:
        with watch(desc):
            launch(False)
        if finish is not None:
            finish()
        return None
    works = launch(True)
    return _Task(works if isinstance(works, list) else [works], finish, desc)


def _record(name: str, g: Group, t: Optional[torch.Tensor] = None,
            peer=None, detail: str = "") -> None:
    """The call's signature in the flight recorder; a call made while the
    card's stream is capturing (NCCL, inside a CUDA graph) says so."""
    if t is not None and t.is_cuda and torch.cuda.is_current_stream_capturing():
        detail = f"{detail} captured".strip()
    shape = tuple(t.shape) if t is not None else ()
    dtype = str(t.dtype).replace("torch.", "") if t is not None else ""
    flight_recorder.record(name, shape=shape, dtype=dtype, group=str(g.id),
                           peer=peer, detail=detail)


def _check_member(g: Group, rank: int, op: str) -> int:
    gr = g.get_group_rank(rank)
    if gr < 0:
        raise ValueError(f"{op}: rank {rank} is not a member of group {g.ranks}")
    return gr


def all_reduce(tensor: torch.Tensor, op: int = ReduceOp.SUM,
               group: Optional[Group] = None, sync_op: bool = True):
    """paddle.distributed.all_reduce: reduces ``tensor`` over the group, in
    place."""
    g = _resolve(group)
    plan = _Plan(g, "all_reduce", [tensor])
    _record(f"all_reduce[{_OP_KIND[op]}]", g, tensor)
    buf = plan.host(tensor)

    def finish():
        if op == ReduceOp.AVG:
            buf.div_(g.nranks)
        plan.back(tensor, buf)

    return _run(g, f"all_reduce(group={g.id})",
                lambda a: dist.all_reduce(buf, op=_torch_op(op), group=g.pg,
                                          async_op=a),
                finish, sync_op)


def all_gather(tensor_list: List, tensor: torch.Tensor,
               group: Optional[Group] = None, sync_op: bool = True):
    """Appends each rank's ``tensor`` to ``tensor_list``, in rank order."""
    g = _resolve(group)
    plan = _Plan(g, "all_gather", [tensor])
    _record("all_gather", g, tensor)
    src = plan.host(tensor)
    outs = [plan.empty_like(tensor) for _ in range(g.nranks)]

    def finish():
        tensor_list.extend(plan.result(o, tensor) for o in outs)

    return _run(g, f"all_gather(group={g.id})",
                lambda a: dist.all_gather(outs, src, group=g.pg, async_op=a),
                finish, sync_op)


def all_gather_object(obj_list: List, obj, group: Optional[Group] = None):
    """Appends every rank's picklable ``obj`` to ``obj_list``."""
    g = _resolve(group)
    _record("all_gather_object", g)
    out = [None] * g.nranks
    with watch(f"all_gather_object(group={g.id})"):
        dist.all_gather_object(out, obj, group=g.pg)
    obj_list.extend(out)


def all_gather_into_tensor(out: torch.Tensor, tensor: torch.Tensor,
                           group: Optional[Group] = None, axis: int = 0):
    """Writes every rank's ``tensor``, concatenated along ``axis``, into
    ``out``."""
    g = _resolve(group)
    plan = _Plan(g, "all_gather_into_tensor", [out, tensor])
    _record("all_gather_into_tensor", g, tensor, detail=f"axis={axis}")
    src = plan.host(tensor.contiguous())
    flat = plan.empty_like(tensor, (g.nranks * tensor.shape[0],
                                    *tensor.shape[1:]) if tensor.dim() else
                           (g.nranks,))
    with watch(f"all_gather_into_tensor(group={g.id})"):
        _all_gather_single(flat, src, group=g.pg)
    if axis % max(tensor.dim(), 1) != 0:
        flat = torch.cat(flat.chunk(g.nranks, 0), dim=axis)
    plan.back(out, flat.reshape(out.shape))


def reduce(tensor: torch.Tensor, dst: int = 0, op: int = ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True):
    """Reduces to ``dst``; every other rank keeps its input, as the
    reference's ranks do."""
    g = _resolve(group)
    _check_member(g, dst, "reduce")
    plan = _Plan(g, "reduce", [tensor])
    _record(f"reduce[{_OP_KIND[op]}]", g, tensor, detail=f"dst={dst}")
    buf = plan.host(tensor)
    if buf is tensor:
        buf = tensor.clone()  # a backend may write a non-root's buffer

    def finish():
        if g.rank == g.get_group_rank(dst):
            if op == ReduceOp.AVG:
                buf.div_(g.nranks)
            plan.back(tensor, buf)

    return _run(g, f"reduce(group={g.id})",
                lambda a: dist.reduce(buf, dst, op=_torch_op(op), group=g.pg,
                                      async_op=a),
                finish, sync_op)


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[Group] = None, sync_op: bool = True):
    """Broadcasts ``tensor`` from global rank ``src``, in place."""
    g = _resolve(group)
    _check_member(g, src, "broadcast")
    plan = _Plan(g, "broadcast", [tensor])
    _record("broadcast", g, tensor, detail=f"src={src}")
    buf = plan.host(tensor)
    return _run(g, f"broadcast(group={g.id})",
                lambda a: dist.broadcast(buf, src, group=g.pg, async_op=a),
                lambda: plan.back(tensor, buf), sync_op)


def reduce_scatter(tensor: torch.Tensor, tensor_or_tensor_list,
                   op: int = ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op: bool = True):
    """Reduces, then writes this rank's shard into ``tensor``: the input is
    a list of per-rank tensors, or one tensor whose leading dimension is
    split evenly (ref: communication/reduce_scatter.py)."""
    g = _resolve(group)
    if isinstance(tensor_or_tensor_list, (list, tuple)):
        parts = list(tensor_or_tensor_list)
    else:
        x = tensor_or_tensor_list
        if x.shape[0] % g.nranks:
            raise ValueError(f"reduce_scatter: leading dim {x.shape[0]} not "
                             f"divisible by {g.nranks} ranks")
        parts = list(x.chunk(g.nranks, 0))
    plan = _Plan(g, "reduce_scatter", [tensor, *parts])
    _record(f"reduce_scatter[{_OP_KIND[op]}]", g, parts[0])
    ins = [plan.host(p.contiguous()) for p in parts]
    buf = plan.empty_like(tensor)

    def finish():
        if op == ReduceOp.AVG:
            buf.div_(g.nranks)
        plan.back(tensor, buf)

    return _run(g, f"reduce_scatter(group={g.id})",
                lambda a: dist.reduce_scatter(buf, ins, op=_torch_op(op),
                                              group=g.pg, async_op=a),
                finish, sync_op)


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True):
    """Rank r receives ``tensor_list[r]`` of rank ``src`` into ``tensor``."""
    g = _resolve(group)
    _check_member(g, src, "scatter")
    me_src = g.rank == g.get_group_rank(src)
    if me_src and (tensor_list is None or len(tensor_list) != g.nranks):
        raise ValueError(f"scatter: the source rank needs {g.nranks} tensors "
                         "(one per rank)")
    plan = _Plan(g, "scatter", [tensor])
    _record("scatter", g, tensor, detail=f"src={src}")
    ins = [plan.host(t.contiguous()) for t in tensor_list] if me_src else None
    buf = plan.empty_like(tensor)
    return _run(g, f"scatter(group={g.id})",
                lambda a: dist.scatter(buf, ins, src, group=g.pg, async_op=a),
                lambda: plan.back(tensor, buf), sync_op)


def gather(tensor: torch.Tensor, gather_list=None, dst: int = 0,
           group: Optional[Group] = None, sync_op: bool = True):
    """Gathers every rank's tensor, as the reference's multi-controller
    gather does: every rank's ``gather_list`` is filled (or, without one,
    the stacked ``[nranks, ...]`` tensor returned)."""
    g = _resolve(group)
    _check_member(g, dst, "gather")
    rows: List[torch.Tensor] = []
    all_gather(rows, tensor, group=g)
    if gather_list is not None:
        gather_list.clear()
        gather_list.extend(rows)
        return None
    return torch.stack(rows)


def alltoall(out_tensor_list: List, in_tensor_list: List,
             group: Optional[Group] = None, sync_op: bool = True):
    """Rank r sends ``in_tensor_list[j]`` to rank j; appends what each rank
    sent it to ``out_tensor_list``, in rank order. The parts are stacked
    and exchanged as one tensor (``all_to_all_single``), as the reference
    stacks them: they share a shape and dtype (gloo has no list form)."""
    g = _resolve(group)
    if len(in_tensor_list) != g.nranks:
        raise ValueError(f"alltoall: need {g.nranks} tensors (one per rank), "
                         f"got {len(in_tensor_list)}")
    x = torch.stack([t.contiguous() for t in in_tensor_list])
    plan = _Plan(g, "alltoall", [x])
    _record("alltoall", g, in_tensor_list[0])
    src = plan.host(x)
    buf = plan.empty_like(x)
    return _run(g, f"alltoall(group={g.id})",
                lambda a: dist.all_to_all_single(buf, src, group=g.pg,
                                                 async_op=a),
                lambda: out_tensor_list.extend(plan.result(buf, x).unbind(0)),
                sync_op)


def alltoall_single(out: torch.Tensor, tensor: torch.Tensor,
                    in_split_sizes=None, out_split_sizes=None,
                    group: Optional[Group] = None, sync_op: bool = True):
    """The leading dimension split evenly over the ranks, exchanged, and
    concatenated into ``out``; uneven splits raise, as the reference's do."""
    g = _resolve(group)
    if in_split_sizes or out_split_sizes:
        raise NotImplementedError("uneven alltoall splits: pad to equal splits")
    if tensor.shape[0] % g.nranks:
        raise ValueError(f"alltoall_single: leading dim {tensor.shape[0]} not "
                         f"divisible by {g.nranks} ranks")
    plan = _Plan(g, "alltoall_single", [out, tensor])
    _record("alltoall_single", g, tensor)
    src = plan.host(tensor.contiguous())
    buf = plan.empty_like(tensor)
    return _run(g, f"alltoall_single(group={g.id})",
                lambda a: dist.all_to_all_single(buf, src, group=g.pg,
                                                 async_op=a),
                lambda: plan.back(out, buf), sync_op)


def send(tensor: torch.Tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    """Point-to-point send to global rank ``dst``; only the two endpoints
    take part."""
    g = _resolve(group)
    plan = _Plan(g, "send", [tensor])
    _record("send", g, tensor, peer=int(dst))
    src = plan.host(tensor.contiguous())
    return _run(g, f"send(dst={dst})",
                lambda a: dist.isend(src, dst, group=g.pg) if a else
                dist.send(src, dst, group=g.pg), None, sync_op)


def recv(tensor: torch.Tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True, deadline=None):
    """Point-to-point receive from global rank ``src`` into ``tensor``.
    ``deadline`` (seconds or a ``utils.retries.Deadline``) bounds the wait:
    the watchdog's ladder runs against it."""
    from ...utils.retries import Deadline

    g = _resolve(group)
    plan = _Plan(g, "recv", [tensor])
    _record("recv", g, tensor, peer=int(src))
    buf = plan.empty_like(tensor) if plan.stage else tensor
    if deadline is not None:
        work = dist.irecv(buf, src, group=g.pg)
        dl = Deadline.coerce(deadline)
        with watch(f"recv(src={src})", dl):
            work.wait()
        plan.back(tensor, buf)
        return None
    return _run(g, f"recv(src={src})",
                lambda a: dist.irecv(buf, src, group=g.pg) if a else
                dist.recv(buf, src, group=g.pg),
                lambda: plan.back(tensor, buf), sync_op)


def p2p_sendrecv(tensor: torch.Tensor, src: int, dst: int,
                 group: Optional[Group] = None) -> torch.Tensor:
    """One-hop transfer: rank ``dst`` gets rank ``src``'s tensor, every
    other rank (``src`` too, unless it is ``dst``) gets zeros: the
    reference's ``ppermute`` with one pair. Every rank of the group calls
    it."""
    return ppermute(tensor, [(src, dst)], group=group, _name="p2p_sendrecv")


def ppermute(tensor: torch.Tensor, perm: Sequence, group: Optional[Group] = None,
             _name: str = "ppermute") -> torch.Tensor:
    """``lax.ppermute``: for each ``(a, b)`` in ``perm`` (group ranks),
    rank b gets rank a's tensor; a rank no pair sends to gets zeros. Every
    rank of the group calls it with the same ``perm``, in the same order.

    Differentiable, as ``lax.ppermute`` is: the backward is the ppermute
    of the output's gradient with every pair reversed (:class:`_PPermute`),
    so each rank gets the gradient of what it sent. Every rank runs those
    backwards in the same order too: each exchange is one
    ``batch_isend_irecv``, never two blocking sends facing each other."""
    perm = [(int(a), int(b)) for a, b in perm]
    return _PPermute.apply(tensor, perm, _resolve(group), _name)


class _PPermute(torch.autograd.Function):
    """``ppermute`` forward; the reversed ``ppermute`` of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, perm, g, name):
        ctx.perm, ctx.g, ctx.name = perm, g, name
        return _ppermute(x, perm, g, name)

    @staticmethod
    def backward(ctx, dy):
        back = [(b, a) for a, b in ctx.perm]  # every pair reversed
        return _ppermute(dy, back, ctx.g, ctx.name), None, None, None


def _ppermute(tensor: torch.Tensor, perm: List, g: Group,
              _name: str) -> torch.Tensor:
    plan = _Plan(g, _name, [tensor])
    _record(_name, g, tensor, detail=f"perm={perm}")
    me = g.rank
    out = torch.zeros_like(tensor)
    x = tensor.contiguous()
    ops, landing = [], None
    for a, b in perm:
        if a == me and b == me:
            out.copy_(x)
        elif a == me:
            ops.append(dist.P2POp(dist.isend, plan.host(x), g.ranks[b],
                                  group=g.pg))
        elif b == me:
            landing = plan.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, landing, g.ranks[a],
                                  group=g.pg))
    if ops:
        with watch(f"{_name}(group={g.id})"):
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    if landing is not None:
        plan.back(out, landing)
    return out


def barrier(group: Optional[Group] = None):
    """Host barrier over the group, under the watchdog."""
    g = _resolve(group)
    _record("barrier", g)
    with watch(f"barrier(group={g.id})"):
        if g.backend == "nccl":
            dist.barrier(group=g.pg, device_ids=[g.device.index or 0])
        else:
            dist.barrier(group=g.pg)


def get_rank_in_trace(group: Optional[Group] = None) -> int:
    """This process's rank in the group: the port has no trace, and its
    SPMD rank is the process's."""
    return _resolve(group).rank
