"""Autograd (counterpart of ``paddle_tpu/autograd``): ``backward`` and
``grad`` over torch's autograd, ``PyLayer`` for user-defined backward
functions (``torch.autograd.Function``), ``saved_tensors_hooks``, and the
functional ``jacobian`` / ``hessian`` built, as in the reference, from one
backward per output element."""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import enable_grad, is_grad_enabled, no_grad, set_grad_enabled  # noqa: F401

from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext  # noqa: F401
from .saved_tensors_hooks import saved_tensors_hooks  # noqa: F401

__all__ = ["backward", "grad", "jacobian", "hessian", "PyLayer",
           "PyLayerContext", "LegacyPyLayer", "saved_tensors_hooks",
           "no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled"]


def backward(tensors: Union[torch.Tensor, Sequence[torch.Tensor]],
             grad_tensors=None, retain_graph: bool = False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``
    (``grad_tensors``: one cotangent per tensor, default ones)."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if grad_tensors is not None and isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    torch.autograd.backward(list(tensors), grad_tensors,
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None,
         retain_graph: Optional[bool] = None, create_graph: bool = False,
         only_inputs: bool = True, allow_unused: bool = False,
         no_grad_vars=None) -> List[Optional[torch.Tensor]]:
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs`` as a list (None for an unused input under
    ``allow_unused``); ``.grad`` is left as it is."""
    outputs = [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)
    inputs_list = ([inputs] if isinstance(inputs, torch.Tensor)
                   else list(inputs))
    if grad_outputs is not None and isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    if retain_graph is None:
        retain_graph = create_graph
    try:
        grads = torch.autograd.grad(outputs, inputs_list, grad_outputs,
                                    retain_graph=retain_graph,
                                    create_graph=create_graph,
                                    allow_unused=True)
    except RuntimeError as e:
        if "does not require grad" not in str(e) or not allow_unused:
            raise
        grads = (None,) * len(inputs_list)
    if not allow_unused:
        for i, g in enumerate(grads):
            if g is None:
                raise RuntimeError(
                    f"One of the differentiated tensors (input {i}) appears "
                    "unused in the graph; pass allow_unused=True to return "
                    "None for it.")
    return list(grads)


def jacobian(ys, xs, batch_axis=None):
    """Dense jacobian: for each element of each output, one backward
    (the reference's double-vjp form). ``[*y.shape, *x.shape]`` per (y, x);
    a single ``ys`` and ``xs`` give one tensor."""
    single_x = isinstance(xs, torch.Tensor)
    xs = [xs] if single_x else list(xs)
    single_y = isinstance(ys, torch.Tensor)
    ys_list = [ys] if single_y else list(ys)
    out = []
    for y in ys_list:
        n = y.numel()
        rows = []
        for k in range(n):
            seed = torch.zeros(n, dtype=y.dtype, device=y.device)
            seed[k] = 1.0
            gs = torch.autograd.grad([y], xs, [seed.reshape(y.shape)],
                                     retain_graph=True, allow_unused=True)
            rows.append([torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
                         if g is None else g.reshape(-1)
                         for g, x in zip(gs, xs)])
        per_x = [torch.stack([rows[k][i] for k in range(n)]).reshape(
                     tuple(y.shape) + tuple(x.shape))
                 for i, x in enumerate(xs)]
        out.append(per_x if len(per_x) > 1 else per_x[0])
    return out[0] if single_y else out


def hessian(ys, xs, batch_axis=None):
    """Hessian of a scalar ``ys`` with respect to one input: the jacobian
    of its gradient (taken with ``create_graph``)."""
    if not isinstance(ys, torch.Tensor) or ys.numel() != 1:
        raise ValueError("hessian expects a scalar output")
    single = isinstance(xs, torch.Tensor)
    xs = [xs] if single else list(xs)
    if len(xs) != 1:
        raise NotImplementedError("multi-input hessian: call per input")
    (g,) = grad(ys, xs[0:1], create_graph=True)
    h = jacobian(g, xs[0])
    return h if single else [h]
