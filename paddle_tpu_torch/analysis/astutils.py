"""Shared AST helpers (counterpart of ``paddle_tpu/analysis/astutils.py``,
copied as it is: pure ``ast``, no torch).

Dotted-name resolution, receiver naming, literal extraction, and the
autograd-hazard scan that ``jit/dy2static.py``'s piecewise splitter
consumes, so the splitter and any later static rule share one definition
of "optimizer-shaped receiver".
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Optional, Sequence, Tuple

__all__ = [
    "OPTIMIZERISH",
    "autograd_hazard",
    "dotted_name",
    "receiver_name",
    "literal_int_tuple",
    "call_keyword",
    "walk_scope",
    "NEW_SCOPE",
]

# scopes whose bodies do not belong to the enclosing function
NEW_SCOPE = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
             ast.Lambda, ast.ListComp, ast.SetComp, ast.DictComp,
             ast.GeneratorExp)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def receiver_name(node: ast.AST) -> str:
    """The NAME a method receiver answers to: ``opt`` for both
    ``opt.step()`` and ``self.opt.step()`` (the final attribute before
    the method)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def literal_int_tuple(node: ast.AST) -> Optional[Tuple[int, ...]]:
    """A literal int / tuple-or-list-of-ints, else None (e.g. the value
    of a ``donate_argnums=`` / ``static_argnums=`` keyword)."""
    try:
        v = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return (v,)
    if isinstance(v, (tuple, list)) and all(
            isinstance(e, int) and not isinstance(e, bool) for e in v):
        return tuple(v)
    return None


def call_keyword(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def walk_scope(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk restricted to the CURRENT scope: descends every child
    except bodies of nested function/class/lambda/comprehension scopes
    (the nodes themselves are still yielded, so a nested def's NAME is
    visible to the caller)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if not isinstance(cur, NEW_SCOPE):
            stack.extend(ast.iter_child_nodes(cur))


# ---------------------------------------------------------------------------
# The autograd-hazard scan (shared with jit/dy2static's piecewise split)

OPTIMIZERISH = re.compile(
    r"(^|_)(opt|optim|optimizer|sgd|adam\w*|adagrad|rmsprop|lamb|lars|"
    r"momentum)(_?\d+)?$", re.IGNORECASE)


def autograd_hazard(stmts: Sequence[ast.stmt]) -> bool:
    """AST-level scan for autograd activity in a statement region
    (ADVICE r5: the old substring scan over unparsed source demoted on
    ANY ``.step(`` / ``.grad``-prefixed token, so a safe split with
    ``scheduler.step()`` / ``profiler.step()`` / ``.grad_fn`` after the
    break fell all the way back to whole-function eager). Hazards:

    - any ``*.backward(...)`` call;
    - any ``*.grad(...)`` call or bare ``.grad`` attribute read (the
      EXACT attribute — ``.grad_fn``/``.gradient`` don't match);
    - ``.step()``/``.minimize()``/``.clear_grad()`` calls whose
      receiver NAME looks like an optimizer (``opt``/``optimizer``/
      ``sgd``/``adamw``/... — scheduler.step()/profiler.step() pass).

    Deliberately name-based, not type-based (this is a static scan):
    an optimizer bound to an unrecognizable name slips through HERE,
    but the piecewise split's runtime backstop still catches it — a
    backward through a carried tensor, which a captured prefix hands
    over detached, raises and the caller demotes
    (``jit/__init__.py``)."""
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Attribute):
                if node.attr in ("backward", "grad"):
                    # covers x.backward()/loss.backward(), paddle.grad(
                    # ...) and p.grad reads in one arm: the call forms
                    # are Attribute nodes under a Call's func
                    return True
                if node.attr in ("step", "minimize", "clear_grad") \
                        and OPTIMIZERISH.search(receiver_name(node.value)):
                    return True
    return False
