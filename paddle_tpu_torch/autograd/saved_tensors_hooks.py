"""``saved_tensors_hooks`` (counterpart of
``paddle_tpu/autograd/saved_tensors_hooks.py``).

Inside the block, every tensor torch's autograd saves for backward goes
through ``pack_hook`` when saved and ``unpack_hook`` when read
(``torch.autograd.graph.saved_tensors_hooks``), and so do the tensors a
``PyLayer`` saves with ``ctx.save_for_backward``. The hooks stack per
thread.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["saved_tensors_hooks", "current_hooks"]


class _HookState(threading.local):
    def __init__(self):
        self.stack = []


_state = _HookState()


class saved_tensors_hooks:
    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook
        self._torch = None

    def __enter__(self):
        _state.stack.append((self.pack_hook, self.unpack_hook))
        self._torch = torch.autograd.graph.saved_tensors_hooks(
            self.pack_hook, self.unpack_hook)
        self._torch.__enter__()
        return self

    def __exit__(self, *exc):
        self._torch.__exit__(*exc)
        _state.stack.pop()
        return False


def current_hooks():
    return _state.stack[-1] if _state.stack else None
