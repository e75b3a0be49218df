"""``PyLayer`` — user-defined autograd functions (counterpart of
``paddle_tpu/autograd/py_layer.py``), over ``torch.autograd.Function``.

A ``PyLayer`` subclass names ``forward(ctx, *args)`` and
``backward(ctx, *grads)`` as paddle does; ``apply`` runs them through a
``torch.autograd.Function`` made once per subclass. ``backward`` may return
one gradient per tensor input, or one per input that requires grad (the
reference aligns the second form); None zero-fills. ``ctx.save_for_backward``
honours an active ``saved_tensors_hooks`` (pack now, unpack when read).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils import _pytree as pytree

__all__ = ["PyLayer", "PyLayerContext", "LegacyPyLayer"]


class PyLayerContext:
    """The ``ctx`` handed to ``forward`` and ``backward``."""

    def __init__(self):
        self._saved = ()
        self._unpack_hook = None
        self._packed_mask = ()
        self.materialize_grads = True
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        """Stash tensors for backward; an active ``saved_tensors_hooks``
        packs them now and unpacks them when read."""
        from .saved_tensors_hooks import current_hooks

        hooks = current_hooks()
        if hooks is not None:
            pack, self._unpack_hook = hooks
            self._packed_mask = tuple(isinstance(t, torch.Tensor)
                                      for t in tensors)
            self._saved = tuple(pack(t) if isinstance(t, torch.Tensor) else t
                                for t in tensors)
        else:
            self._unpack_hook = None
            self._saved = tuple(tensors)

    @property
    def saved_tensor(self):
        if self._unpack_hook is not None:
            unpack = self._unpack_hook
            return tuple(unpack(h) if packed else h
                         for h, packed in zip(self._saved, self._packed_mask))
        return self._saved

    # paddle exposes both names
    saved_tensors = saved_tensor

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)


_functions: Dict[type, type] = {}


def _function_of(cls) -> type:
    """The ``torch.autograd.Function`` running ``cls``'s forward and
    backward (made once per PyLayer subclass)."""
    fn = _functions.get(cls)
    if fn is not None:
        return fn

    def forward(fctx, treespec, *flat):
        args, kwargs = pytree.tree_unflatten(list(flat), treespec)
        ctx = PyLayerContext()
        fctx.pyctx = ctx
        fctx.inputs = [(i, x.requires_grad) for i, x in enumerate(flat)
                       if isinstance(x, torch.Tensor)]
        fctx.like = {i: (x.shape, x.dtype, x.device)
                     for i, x in enumerate(flat)
                     if isinstance(x, torch.Tensor) and x.requires_grad}
        fctx.n_flat = len(flat)
        outs = cls.forward(ctx, *args, **kwargs)
        fctx.single = isinstance(outs, torch.Tensor)
        return outs

    def backward(fctx, *cots):
        gin = cls.backward(fctx.pyctx, *cots)
        gin = ([gin] if isinstance(gin, torch.Tensor) or gin is None
               else list(gin))
        tensor_pos = [i for i, _ in fctx.inputs]
        diff_pos = [i for i, rg in fctx.inputs if rg]
        if len(gin) == len(tensor_pos):
            aligned = dict(zip(tensor_pos, gin))
        elif len(gin) == len(diff_pos):
            aligned = dict(zip(diff_pos, gin))
        else:
            raise RuntimeError(
                f"{cls.__name__}.backward returned {len(gin)} grads for "
                f"{len(tensor_pos)} tensor inputs")
        out = []
        for i in range(fctx.n_flat):
            g = aligned.get(i)
            if g is None and i in fctx.like:  # None zero-fills
                shape, dtype, device = fctx.like[i]
                g = torch.zeros(shape, dtype=dtype, device=device)
            out.append(g if i in fctx.like else None)
        return (None, *out)

    fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    _functions[cls] = fn
    return fn


class PyLayer:
    """Subclass with ``forward(ctx, *args)`` and ``backward(ctx, *grads)``
    static methods; call ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        flat, spec = pytree.tree_flatten((args, kwargs))
        return _function_of(cls).apply(spec, *flat)


class LegacyPyLayer(PyLayer):
    pass
