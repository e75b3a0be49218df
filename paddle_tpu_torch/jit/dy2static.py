"""Dynamic-to-static control-flow conversion (counterpart of
``paddle_tpu/jit/dy2static.py``).

``to_static`` runs :func:`convert` on the function it is given. The AST
rewrite is the reference's, statement for statement: a Python ``if``
becomes :func:`convert_ifelse` over two branch closures, an early-return
``if`` (``if p: return a ... return b``) becomes :func:`convert_ret_ifelse`
over two continuations, a ``while`` becomes :func:`convert_while_loop`, and
``for <name> in range(...)`` becomes :func:`convert_for_range`. The
transform is conservative in the same places (``return``/``break``/
``continue`` escaping a region, ``del``, ``nonlocal``/``global``, source
that cannot be read) and leaves such code as it is.

The runtime rule is the reference's "traced value -> structured op, plain
value -> plain Python", read for CUDA graphs: **a device tensor inside a
capture -> a device op, anything else -> plain Python**. A capture
(``jit.StaticFunction``) turns the select path on (:func:`select_mode`);
outside one every predicate is read on the host, so eager semantics never
change.

- ``if`` on a tensor inside a capture: BOTH branches run and each result is
  merged with ``torch.where`` (the reference's ``jnp.where`` select), which
  a CUDA graph records and autograd differentiates.
- ``while`` on a tensor inside a capture cannot replay a data-dependent
  trip count. With ``FLAGS_dy2static_while_grad_bound = N`` it runs as the
  reference's bounded masked form: exactly N iterations, those past the
  loop's exit masked by ``torch.where`` (N must bound the true trip count;
  the body must have no side effects, and NaNs it makes in masked lanes
  can leak through the gradient of the select). Without the flag it raises
  :class:`GraphBreakError`, which ``to_static(full_graph=False)`` then
  splits at. (The reference runs an unbounded ``lax.while_loop`` there.)
- ``for i in range(...)`` with host bounds runs as a Python loop, which the
  capture unrolls (the reference scans it to keep XLA programs small; a
  CUDA graph records the unrolled launches either way). A tensor bound
  inside a capture becomes a converted ``while``.

:func:`split_at_break` is the reference's piecewise split: the function cut
at the top-level statement of a graph break into a prefix, the breaking
statement (run eagerly each call) and a suffix.
"""
from __future__ import annotations

import ast
import contextlib
import inspect
import sys
import textwrap
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["GraphBreakError", "convert", "convert_ifelse", "convert_ret_ifelse",
           "convert_while_loop", "convert_for_range", "graph_break_error",
           "split_at_break", "select_mode"]

# the name converted code reaches this module by, in the function's globals
# (the reference's is ``_paddle_tpu_jst``: a module may hold functions
# converted by both packages)
_RUNTIME_NAME = "_paddle_tpu_torch_jst"
_cache: Dict[Any, Callable] = {}

# the select path's switch: on inside a capture (and in the parity tests),
# with the device type whose tensors take it ("" for any)
_select = [None]


@contextlib.contextmanager
def select_mode(on: bool = True, device_type: str = ""):
    """Inside the block a tensor predicate (on ``device_type``, or any
    device) takes the device path (select / bounded loop) instead of a host
    read. ``jit.StaticFunction`` turns it on for a capture on its device:
    a CPU tensor read inside a CUDA capture stays a host read."""
    prev = _select[0]
    _select[0] = device_type if on else None
    try:
        yield
    finally:
        _select[0] = prev


class GraphBreakError(RuntimeError):
    """A construct that cannot live inside one captured graph was reached.

    Under ``to_static(full_graph=True)`` (default) this propagates to the
    user with rewrite options; under ``full_graph=False`` StaticFunction
    catches it and splits the function at the breaking statement (the SOT
    graph-break behavior the reference follows)."""


class _Undef:
    """Sentinel for a variable unbound before a converted region; any
    use raises with the variable's name (mirrors UnboundLocalError)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def _raise(self, *a, **k):
        raise UnboundLocalError(
            f"variable '{self.name}' is used inside converted control flow "
            "before being assigned on every path"
        )

    __bool__ = __call__ = __getattr__ = __add__ = __radd__ = _raise
    __mul__ = __rmul__ = __sub__ = __iter__ = __getitem__ = _raise


def _device_pred(x):
    """``x`` when the select path takes it (a tensor of the capture's
    device while the switch is on), else None: the reference's
    ``_tracer_of``."""
    want = _select[0]
    if want is None or not isinstance(x, torch.Tensor):
        return None
    return x if not want or x.device.type == want else None


def _as_bool(x):
    return bool(x)


def _is_undef(x):
    return isinstance(x, _Undef)


def _epilogue(loc: dict, names: Tuple[str, ...]):
    """Collect converted-region outputs from a branch/body's locals();
    names unbound on this path (never assigned, or deleted by a nested
    region's cleanup) come back as _Undef sentinels."""
    return tuple(loc.get(n, _Undef(n)) for n in names)


def _cond(pred: torch.Tensor) -> torch.Tensor:
    """The predicate as the bool condition ``torch.where`` takes (a
    number's truth is ``!= 0``, as ``jnp.where`` reads it)."""
    return pred if pred.dtype == torch.bool else pred != 0


def _select_leaf(pred, a, b):
    if a is b:
        return a
    a_undef, b_undef = isinstance(a, _Undef), isinstance(b, _Undef)
    if a_undef or b_undef:
        # a variable bound in only one branch with NO incoming binding:
        # defer the error to USE (the reference's UndefinedVar
        # semantics) — the region's undef-cleanup deletes it, so touching
        # it later raises UnboundLocalError, and code that never touches
        # it is unaffected
        return a if a_undef else b
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.where(_cond(pred), a, b)
    if a == b:
        return a
    raise GraphBreakError(
        f"non-tensor value differs between the branches of a "
        f"tensor-dependent `if` ({a!r} vs {b!r}); only tensor results can "
        "be selected under trace"
    )


def convert_ret_ifelse(pred, true_fn, false_fn):
    """Runtime dispatch for a converted EARLY-RETURN ``if`` (the guard
    pattern ``if p: return a ... return b``; the tail of the function is
    the false continuation): a host predicate picks a branch; a device
    predicate inside a capture runs BOTH continuations and selects their
    results leaf by leaf."""
    if _device_pred(pred) is None:
        return true_fn() if _as_bool(pred) else false_fn()
    t_out = true_fn()
    f_out = false_fn()
    t_leaves, t_def = pytree.tree_flatten(t_out)
    f_leaves, f_def = pytree.tree_flatten(f_out)
    if t_def != f_def:
        raise GraphBreakError(
            "a tensor-dependent early-return `if` must return the same "
            f"STRUCTURE on both paths (got {t_def} vs {f_def}); restructure "
            "the returns or mark the function @paddle.jit.not_to_static"
        )
    out = [_select_leaf(pred, a, b) for a, b in zip(t_leaves, f_leaves)]
    return pytree.tree_unflatten(out, t_def)


def convert_ifelse(pred, true_fn, false_fn, init_args: Tuple):
    """Runtime dispatch for a converted ``if``: Python semantics for a
    host predicate, both branches + select for a device one."""
    if _device_pred(pred) is None:
        return true_fn(*init_args) if _as_bool(pred) else false_fn(*init_args)
    t_out = true_fn(*init_args)
    f_out = false_fn(*init_args)
    return tuple(_select_leaf(pred, a, b) for a, b in zip(t_out, f_out))


def _carry_tensors(init_args, var_names, what, device):
    """Validate loop carries; numbers become tensors on ``device``."""
    out = []
    for i, v in enumerate(init_args):
        name = var_names[i] if i < len(var_names) else f"#{i}"
        if isinstance(v, _Undef):
            raise GraphBreakError(
                f"loop variable '{v.name}' must be initialized before a "
                f"tensor-dependent `{what}`"
            )
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (int, float, bool)):
            out.append(torch.as_tensor(v, device=device))
        else:
            raise GraphBreakError(
                f"loop variable '{name}' has type {type(v).__name__}, which "
                f"cannot be carried through a traced `{what}` (tensors and "
                "numbers only)"
            )
    return out


def convert_while_loop(cond_fn, body_fn, init_args: Tuple, var_names: Sequence[str] = ()):
    """Runtime dispatch for a converted ``while``: a Python loop for a host
    predicate; for a device predicate inside a capture, the bounded masked
    form of ``FLAGS_dy2static_while_grad_bound`` iterations (differentiable
    through ``torch.where``), or :class:`GraphBreakError` without the flag.

    Bounded semantics: exactly ``bound`` iterations run; those past the
    loop's true exit are masked no-ops (the body still runs on the
    converged values — it must not have side effects, and NaNs it makes in
    masked lanes can leak through the select's gradient). The bound must
    be >= the true trip count: iterations beyond it are silently dropped."""
    from ..base.flags import flag

    first = cond_fn(*init_args)
    pred = _device_pred(first)
    if pred is None:
        vars_t = tuple(init_args)
        cur = first
        while _as_bool(cur):
            vars_t = body_fn(*vars_t)
            cur = cond_fn(*vars_t)
        return vars_t
    bound = int(flag("dy2static_while_grad_bound") or 0)
    if bound <= 0:
        raise GraphBreakError(
            "a tensor-dependent `while` cannot run inside a CUDA graph: its "
            "trip count depends on the data. Set "
            "FLAGS_dy2static_while_grad_bound = N (an upper bound of the "
            "trip count) to run it as N masked iterations, or capture with "
            "full_graph=False to split the function at the loop")
    vals = tuple(_carry_tensors(init_args, var_names, "while", pred.device))
    done = torch.zeros((), dtype=torch.bool, device=pred.device)
    for _ in range(bound):
        active = torch.logical_and(~done, _cond(cond_fn(*vals)).reshape(()))
        new_vals = body_fn(*vals)
        vals = tuple(torch.where(active, torch.as_tensor(n, device=v.device), v)
                     for n, v in zip(new_vals, vals))
        done = ~active
    return vals


def convert_for_range(range_args: Tuple, body_fn, init_args: Tuple,
                      var_names: Sequence[str] = ()):
    """Runtime dispatch for a converted ``for <i> in range(...)``: host
    bounds run the Python loop (a capture records it unrolled); a device
    bound inside a capture becomes a converted ``while`` over ``(i,
    *vars)`` (same rules as :func:`convert_while_loop`)."""
    dev_bound = [a for a in range_args if _device_pred(a) is not None]
    if dev_bound:
        if len(range_args) == 1:
            start, stop, step_ = 0, range_args[0], 1
        elif len(range_args) == 2:
            start, stop, step_ = range_args[0], range_args[1], 1
        else:
            start, stop, step_ = range_args
        if not isinstance(step_, int) or step_ == 0:
            raise GraphBreakError(
                "a traced range() bound requires a concrete nonzero int "
                "step"
            )
        device = dev_bound[0].device
        i0 = torch.as_tensor(start, device=device).to(torch.int32)
        args = list(init_args)
        if args and isinstance(args[0], _Undef):
            # the loop target is usually unbound before the loop: seed it;
            # the body's prologue overwrites it with the real index
            args[0] = torch.zeros((), dtype=torch.int32, device=device)

        def cond(i, *vars_):
            return (i < stop) if step_ > 0 else (i > stop)

        def body(i, *vars_):
            out = body_fn(i, *vars_)
            return (i + step_,) + tuple(out)

        res = convert_while_loop(
            cond, body, (i0,) + tuple(args),
            ("<range index>",) + tuple(var_names),
        )
        return res[1:]
    vars_t = tuple(init_args)
    for i in range(*[int(a) for a in range_args]):
        vars_t = body_fn(i, *vars_t)
    return vars_t


# ---------------------------------------------------------------------------
# AST transform
# ---------------------------------------------------------------------------

_NEW_SCOPE = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda,
              ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _assigned_names(stmts: Sequence[ast.stmt]) -> Tuple[List[str], bool]:
    """Names bound by ``stmts`` in the current scope (ordered, no dups),
    plus whether the region contains a ``del`` (which blocks conversion:
    a deleted name cannot appear in the generated epilogue)."""
    out: List[str] = []
    has_del = False

    def add(name):
        # skip this transform's own generated helpers from inner rewrites
        if not name.startswith("_pt_") and name not in out:
            out.append(name)

    class V(ast.NodeVisitor):
        def visit_If(self, node):
            if getattr(node, "_pt_cleanup", False):
                return  # generated undef-cleanup; its del is not user code
            self.generic_visit(node)

        def visit_Name(self, node):
            nonlocal has_del
            if isinstance(node.ctx, ast.Del):
                has_del = True
            elif isinstance(node.ctx, ast.Store):
                add(node.id)

        def visit_FunctionDef(self, node):
            add(node.name)

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            add(node.name)

        def visit_Lambda(self, node):
            pass

        def _comp(self, node):  # comprehensions: own scope in py3
            pass

        visit_ListComp = visit_SetComp = visit_DictComp = visit_GeneratorExp = _comp

        def visit_alias(self, node):
            add(node.asname or node.name.split(".")[0])

    v = V()
    for s in stmts:
        v.visit(s)
    return out, has_del


def _has_abrupt_exit(stmts: Sequence[ast.stmt]) -> bool:
    """True if the region contains flow that escapes it: return/yield
    anywhere in this scope, or break/continue not enclosed in a loop
    nested inside the region (for an `if`-region they target an outer
    loop; for a `while`-region the converted loop itself — either way
    the generated closure cannot express them)."""
    found = False

    def walk(node, loop_depth):
        nonlocal found
        if found or isinstance(node, _NEW_SCOPE):
            return
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            found = True
            return
        if isinstance(node, (ast.Break, ast.Continue)) and loop_depth == 0:
            found = True
            return
        inc = 1 if isinstance(node, (ast.For, ast.While, ast.AsyncFor)) else 0
        for child in ast.iter_child_nodes(node):
            walk(child, loop_depth + inc)

    for s in stmts:
        walk(s, 0)
    return found


def _name(n, ctx=None):
    return ast.Name(id=n, ctx=ctx or ast.Load())


def _tuple_of(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx or ast.Load()) for n in names], ctx=ctx or ast.Load())


def _epilogue_return(names):
    """``return _paddle_tpu_jst._epilogue(locals(), ('a', 'b'))`` —
    tolerates names left unbound on this path (returned as _Undef)."""
    return ast.Return(value=ast.Call(
        func=ast.Attribute(value=_name(_RUNTIME_NAME), attr="_epilogue", ctx=ast.Load()),
        args=[
            ast.Call(func=_name("locals"), args=[], keywords=[]),
            ast.Tuple(elts=[ast.Constant(value=n) for n in names], ctx=ast.Load()),
        ],
        keywords=[],
    ))


def _fn_args(names):
    return ast.arguments(
        posonlyargs=[], args=[ast.arg(arg=n) for n in names], vararg=None,
        kwonlyargs=[], kw_defaults=[], kwarg=None, defaults=[],
    )


def _init_stmts(names, uid):
    """try: _pt_init_v = v / except NameError: _pt_init_v = UNDEF('v')"""
    stmts = []
    for v in names:
        tmp = f"_pt_init_{uid}_{v}"
        undef = ast.Call(
            func=ast.Attribute(value=_name(_RUNTIME_NAME), attr="_Undef", ctx=ast.Load()),
            args=[ast.Constant(value=v)], keywords=[],
        )
        stmts.append(ast.Try(
            body=[ast.Assign(targets=[_name(tmp, ast.Store())], value=_name(v))],
            handlers=[ast.ExceptHandler(
                type=_name("NameError"), name=None,
                body=[ast.Assign(targets=[_name(tmp, ast.Store())], value=undef)],
            )],
            orelse=[], finalbody=[],
        ))
    return stmts, [f"_pt_init_{uid}_{v}" for v in names]


def _undef_cleanup_stmts(names):
    """``if _is_undef(v): del v`` for each converted var, so a variable
    left unbound on the taken path raises UnboundLocalError on later use
    exactly as un-transformed Python would."""
    out = []
    for v in names:
        test = ast.Call(
            func=ast.Attribute(value=_name(_RUNTIME_NAME), attr="_is_undef", ctx=ast.Load()),
            args=[_name(v)], keywords=[],
        )
        node = ast.If(
            test=test,
            body=[ast.Delete(targets=[_name(v, ast.Del())])],
            orelse=[],
        )
        node._pt_cleanup = True  # outer passes must ignore this del
        out.append(node)
    return out


_MUTATOR_METHODS = {
    "append", "extend", "insert", "add", "update", "pop", "remove",
    "clear", "setdefault", "popleft", "appendleft", "write", "discard",
}


def _mutates_outer_state(stmts: Sequence[ast.stmt]) -> bool:
    """Conservative guard for `for` conversion: a body that mutates a
    container/tensor through a bare name (x.append(...), buf[i] = v)
    stays unconverted (the reference's rule: its scanned body would run
    the mutation once). The port runs every host-bounded loop in Python,
    so this only keeps the rewrite the reference's."""
    found = False

    class V(ast.NodeVisitor):
        def visit_Call(self, node):
            nonlocal found
            f = node.func
            # any receiver: x.append(...), self.outs.append(...), ...
            if isinstance(f, ast.Attribute) and f.attr in _MUTATOR_METHODS:
                found = True
            self.generic_visit(node)

        def visit_Subscript(self, node):
            nonlocal found
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                found = True
            self.generic_visit(node)

        def visit_Attribute(self, node):
            nonlocal found
            # attribute stores (self.h = h) mutate an outer object
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                found = True
            self.generic_visit(node)

    v = V()
    for s in stmts:
        v.visit(s)
    return found


def _contains(node_or_stmts, types) -> bool:
    stmts = node_or_stmts if isinstance(node_or_stmts, list) else [node_or_stmts]
    for s in stmts:
        for sub in ast.walk(s):
            if isinstance(sub, types):
                return True
    return False


def _rewrite_return_ifs(stmts):
    """Early-return ``if`` -> continuation closures (the SOT guard
    pattern, ref jit/sot opcode_executor.py:305,1594 — the bytecode
    tracer splits at the branch and resumes after it; here the split is
    at statement level: the if-body becomes the true continuation and
    everything AFTER the if — else-branch plus the function tail —
    becomes the false continuation, selected by convert_ret_ifelse).

    Applied only where control flow is total: the if-body's last
    statement is ``return <expr>``, and the remainder also ends in
    ``return <expr>``. Recurses into both continuations, so chains of
    guards convert. Statements after a converted if are consumed by its
    false continuation."""
    out = []
    for i, node in enumerate(stmts):
        if (
            isinstance(node, ast.If)
            and node.body
            and isinstance(node.body[-1], ast.Return)
            and node.body[-1].value is not None
            and not _contains(node.body + node.orelse + stmts[i + 1:],
                              (ast.Yield, ast.YieldFrom, ast.Await,
                               ast.AsyncFor, ast.AsyncWith))
        ):
            rest = node.orelse + stmts[i + 1:]
            if not (rest and isinstance(rest[-1], ast.Return)
                    and rest[-1].value is not None):
                out.append(node)
                continue
            t_body, _ = _rewrite_return_ifs(list(node.body))
            f_body, _ = _rewrite_return_ifs(list(rest))
            uid = next(_ret_uid)
            tname, fname = f"_pt_rt_true_{uid}", f"_pt_rt_false_{uid}"

            def mk(nm, body, uid_tag):
                # names a continuation ASSIGNS become parameters seeded
                # by default args (evaluated at def time, after the init
                # try/excepts below): a continuation that reads-then-
                # shadows a pre-if binding (y = y + 1) would otherwise
                # hit UnboundLocalError — the same hazard visit_If
                # solves with explicit init args
                assigned, has_del = _assigned_names(body)
                if has_del:
                    return None, []
                inits, init_names = _init_stmts(assigned, uid_tag)
                args = ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=n) for n in assigned],
                    vararg=None, kwonlyargs=[], kw_defaults=[],
                    kwarg=None,
                    defaults=[_name(n) for n in init_names],
                )
                fn = ast.FunctionDef(
                    name=nm, args=args, body=body,
                    decorator_list=[], returns=None, type_comment=None,
                    type_params=[],
                )
                return fn, inits

            t_fn, t_inits = mk(tname, t_body, f"{uid}t")
            f_fn, f_inits = mk(fname, f_body, f"{uid}f")
            if t_fn is None or f_fn is None:  # del inside: leave as-is
                out.append(node)
                continue
            call = ast.Return(value=ast.Call(
                func=ast.Attribute(value=_name(_RUNTIME_NAME),
                                   attr="convert_ret_ifelse", ctx=ast.Load()),
                args=[node.test, _name(tname), _name(fname)], keywords=[],
            ))
            out.extend([*t_inits, *f_inits, t_fn, f_fn, call])
            return out, True
        out.append(node)
    return out, False


_ret_uid = iter(range(1, 1 << 30))


class _Transformer(ast.NodeTransformer):
    def __init__(self):
        self.changed = False
        self._uid = 0
        self._blocked = False  # nonlocal/global present

    def _next(self):
        self._uid += 1
        return self._uid

    def visit_Nonlocal(self, node):
        self._blocked = True
        return node

    def visit_Global(self, node):
        self._blocked = True
        return node

    def visit_If(self, node):
        if getattr(node, "_pt_cleanup", False):
            return node
        self.generic_visit(node)
        if self._blocked:
            return node
        assigned, has_del = _assigned_names(node.body + node.orelse)
        if not assigned or has_del:
            return node
        if _has_abrupt_exit(node.body) or _has_abrupt_exit(node.orelse):
            return node
        uid = self._next()
        tname, fname = f"_pt_true_{uid}", f"_pt_false_{uid}"
        true_def = ast.FunctionDef(
            name=tname, args=_fn_args(assigned),
            body=list(node.body) + [_epilogue_return(assigned)],
            decorator_list=[], returns=None, type_comment=None, type_params=[],
        )
        false_body = list(node.orelse) if node.orelse else [ast.Pass()]
        false_def = ast.FunctionDef(
            name=fname, args=_fn_args(assigned),
            body=false_body + [_epilogue_return(assigned)],
            decorator_list=[], returns=None, type_comment=None, type_params=[],
        )
        inits, init_names = _init_stmts(assigned, uid)
        call = ast.Assign(
            targets=[_tuple_of(assigned, ast.Store())],
            value=ast.Call(
                func=ast.Attribute(value=_name(_RUNTIME_NAME), attr="convert_ifelse", ctx=ast.Load()),
                args=[node.test, _name(tname), _name(fname),
                      ast.Tuple(elts=[_name(n) for n in init_names], ctx=ast.Load())],
                keywords=[],
            ),
        )
        self.changed = True
        return [true_def, false_def, *inits, call, *_undef_cleanup_stmts(assigned)]

    def visit_While(self, node):
        self.generic_visit(node)
        if self._blocked or node.orelse:
            return node
        assigned, has_del = _assigned_names(node.body)
        if not assigned or has_del:
            return node
        if _has_abrupt_exit(node.body):
            return node
        uid = self._next()
        cname, bname = f"_pt_cond_{uid}", f"_pt_body_{uid}"
        cond_def = ast.FunctionDef(
            name=cname, args=_fn_args(assigned),
            body=[ast.Return(value=node.test)],
            decorator_list=[], returns=None, type_comment=None, type_params=[],
        )
        body_def = ast.FunctionDef(
            name=bname, args=_fn_args(assigned),
            body=list(node.body) + [_epilogue_return(assigned)],
            decorator_list=[], returns=None, type_comment=None, type_params=[],
        )
        inits, init_names = _init_stmts(assigned, uid)
        call = ast.Assign(
            targets=[_tuple_of(assigned, ast.Store())],
            value=ast.Call(
                func=ast.Attribute(value=_name(_RUNTIME_NAME), attr="convert_while_loop", ctx=ast.Load()),
                args=[_name(cname), _name(bname),
                      ast.Tuple(elts=[_name(n) for n in init_names], ctx=ast.Load()),
                      ast.Tuple(elts=[ast.Constant(value=n) for n in assigned], ctx=ast.Load())],
                keywords=[],
            ),
        )
        self.changed = True
        return [cond_def, body_def, *inits, call, *_undef_cleanup_stmts(assigned)]

    def visit_For(self, node):
        self.generic_visit(node)
        if self._blocked or node.orelse:
            return node
        # only `for <name> in range(...)` with 1-3 plain args
        if not (
            isinstance(node.target, ast.Name)
            and isinstance(node.iter, ast.Call)
            and isinstance(node.iter.func, ast.Name)
            and node.iter.func.id == "range"
            and not node.iter.keywords
            and 1 <= len(node.iter.args) <= 3
            and not any(isinstance(a, ast.Starred) for a in node.iter.args)
        ):
            return node
        if _has_abrupt_exit(node.body) or _mutates_outer_state(node.body):
            return node
        body_assigned, has_del = _assigned_names(node.body)
        if has_del:
            return node
        target = node.target.id
        # the target is carried too: a prologue `target = <idx>` feeds it
        # each iteration, and the final carry keeps Python's after-loop
        # binding (last index, or the body's reassignment)
        assigned = [target] + [n for n in body_assigned if n != target]
        uid = self._next()
        bname, iname = f"_pt_forbody_{uid}", f"_pt_i_{uid}"
        body_def = ast.FunctionDef(
            name=bname, args=_fn_args([iname] + assigned),
            body=[ast.Assign(targets=[_name(target, ast.Store())],
                             value=_name(iname))]
            + list(node.body) + [_epilogue_return(assigned)],
            decorator_list=[], returns=None, type_comment=None, type_params=[],
        )
        inits, init_names = _init_stmts(assigned, uid)
        call = ast.Assign(
            targets=[_tuple_of(assigned, ast.Store())],
            value=ast.Call(
                func=ast.Attribute(value=_name(_RUNTIME_NAME),
                                   attr="convert_for_range", ctx=ast.Load()),
                args=[
                    ast.Tuple(elts=list(node.iter.args), ctx=ast.Load()),
                    _name(bname),
                    ast.Tuple(elts=[_name(n) for n in init_names], ctx=ast.Load()),
                    ast.Tuple(elts=[ast.Constant(value=n) for n in assigned], ctx=ast.Load()),
                ],
                keywords=[],
            ),
        )
        self.changed = True
        return [body_def, *inits, call, *_undef_cleanup_stmts(assigned)]


def convert(fn: Callable) -> Callable:
    """AST-convert tensor-dependent ``if``/``while``/``for`` in ``fn``.

    Returns ``fn`` unchanged when nothing needs converting or the source
    is unavailable/unsupported. Safe on any callable; cached per code
    object. The converted function dispatches at runtime, so Python
    semantics for host predicates are preserved exactly.
    """
    if getattr(fn, "_not_to_static", False):
        return fn
    if inspect.ismethod(fn):
        conv = convert(fn.__func__)
        return conv.__get__(fn.__self__) if conv is not fn.__func__ else fn
    if getattr(fn, "__wrapped__", None) is not None:
        # functools.wraps wrappers: inspect.getsource would follow
        # __wrapped__ and return the INNER function's body while the code
        # object is the wrapper's — source and cache key would disagree.
        # Leave wrappers alone; the wrapped function can be converted
        # explicitly if needed.
        return fn
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn
    # cache the template FUNCTION CODE per original code object; the
    # function object is rebuilt per call so each closure keeps its own
    # live cells and the live module globals (late binding preserved)
    if code not in _cache:
        _cache[code] = _compile_transform(fn)
    new_code = _cache[code]
    if new_code is None:
        return fn
    try:
        if new_code.co_freevars != code.co_freevars:
            return fn  # closure layout diverged; don't risk misbinding
        import sys
        import types

        fn.__globals__.setdefault(_RUNTIME_NAME, sys.modules[__name__])
        new_fn = types.FunctionType(
            new_code, fn.__globals__, fn.__name__, fn.__defaults__, fn.__closure__
        )
        new_fn.__kwdefaults__ = fn.__kwdefaults__
        new_fn.__wrapped_original__ = fn
        return new_fn
    except Exception:
        return fn


def _compile_transform(fn):
    """AST-transform ``fn`` and return the new function CODE object (with
    co_freevars preserved via a factory wrapper); None when unchanged or
    unsupported."""
    try:
        code = fn.__code__
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
        fndef = tree.body[0]
        if not isinstance(fndef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        fndef.decorator_list = []
        # pass 1: early-return ifs -> continuation closures (must run
        # before the main transformer so loops/ifs inside the generated
        # continuations get converted too)
        fndef.body, ret_changed = _rewrite_return_ifs(list(fndef.body))
        tr = _Transformer()
        tree = tr.visit(tree)
        if (not tr.changed and not ret_changed) or tr._blocked:
            return None
        ast.fix_missing_locations(tree)
        filename = f"<dy2static:{inspect.getsourcefile(fn) or '?'}>"
        if code.co_freevars:
            # wrap in a factory whose params are the freevars so the
            # compiled inner function has matching co_freevars; the code
            # object is then rebound to the ORIGINAL closure cells
            factory = ast.FunctionDef(
                name="_pt_factory", args=_fn_args(list(code.co_freevars)),
                body=[tree.body[0], ast.Return(value=_name(fndef.name))],
                decorator_list=[], returns=None, type_comment=None, type_params=[],
            )
            mod = ast.Module(body=[factory], type_ignores=[])
            ast.fix_missing_locations(mod)
            ns: Dict[str, Any] = {}
            exec(compile(mod, filename, "exec"), {}, ns)
            template = ns["_pt_factory"](*[None] * len(code.co_freevars))
        else:
            ns = {}
            exec(compile(tree, filename, "exec"), {}, ns)
            template = ns[fndef.name]
        return template.__code__
    except Exception:
        return None


def graph_break_error(exc: BaseException) -> "GraphBreakError":
    """Actionable error for a host read of a device value reached inside a
    capture, naming the user source line. The returned error carries
    ``frames`` — the user-code (file, line) candidates, deepest first —
    for the piecewise split."""
    import traceback

    loc = None
    frames = []
    for frame in reversed(traceback.extract_tb(exc.__traceback__)):
        f = frame.filename.replace("\\", "/")
        if "/torch/" in f or "/paddle_tpu_torch/" in f:
            continue
        if f.startswith("<dy2static"):
            # converted code: linenos are RELATIVE to the function start
            # (the AST was parsed from dedented source); the piecewise
            # split translates them via co_firstlineno
            frames.append((f, frame.lineno))
            continue
        frames.append((f, frame.lineno))
        if loc is None:
            loc = f"{f}:{frame.lineno} ({frame.line})"
    where = f" at {loc}" if loc else ""
    err = GraphBreakError(
        "to_static: tensor-dependent Python control flow (or another "
        f"bool()/int()/numpy() concretization) reached under trace{where}. "
        "`if`/`while`/`for range()` and early-return `if` chains in the "
        "entry function are converted automatically; this one could not "
        "be (helper function, break/continue escaping a converted "
        "region, or mixed return/fallthrough paths). Options: apply "
        "paddle_tpu_torch.jit.dy2static.convert to the helper; rewrite with "
        "paddle.where / a converted-friendly loop; or mark the function "
        "@paddle.jit.not_to_static to run it eagerly."
    )
    err.frames = frames
    return err


# -- piecewise capture: split a function at a graph-break statement ----------

def _carry_get(carry: dict, name: str):
    """Runtime unpacker for split-function carries: missing names become
    _Undef sentinels (use raises, mirroring UnboundLocalError)."""
    return carry[name] if name in carry else _Undef(name)


def _stmt_names(stmts, ctx_type):
    """Name identifiers with the given ctx in ``stmts``.

    Load: descends everywhere (over-collection only widens the carry —
    safe). Store: stops at nested function/class/lambda/comprehension
    scopes, whose bindings are not locals of the split function (a
    leaked nested-scope Store would generate an _Undef unpack shadowing
    a real global in the suffix); a nested def/class still BINDS its
    own name in the enclosing scope, as do import aliases and
    ``except ... as`` names."""
    out = set()
    if ctx_type is ast.Load:
        for stmt in stmts:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and isinstance(
                        node.ctx, (ast.Load, ast.Del)):
                    out.add(node.id)
                elif (isinstance(node, ast.AugAssign)
                        and isinstance(node.target, ast.Name)):
                    # read-modify-write: the target must be carried even
                    # though its ctx is Store
                    out.add(node.target.id)
        return out

    class _Stores(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, ast.Store):
                out.add(node.id)

        def visit_FunctionDef(self, node):
            out.add(node.name)  # don't descend: its body is another scope

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            out.add(node.name)

        def visit_Lambda(self, node):
            pass

        def _comp(self, node):
            pass  # comprehension targets live in their own scope

        visit_ListComp = visit_SetComp = visit_DictComp = _comp
        visit_GeneratorExp = _comp

        def visit_Import(self, node):
            for a in node.names:
                out.add(a.asname or a.name.split(".")[0])

        visit_ImportFrom = visit_Import

        def visit_ExceptHandler(self, node):
            if node.name:
                out.add(node.name)
            self.generic_visit(node)

    v = _Stores()
    for stmt in stmts:
        v.visit(stmt)
    return out


def _autograd_hazard(stmts) -> bool:
    """AST-level scan for autograd activity in the break/suffix of a
    piecewise split; the scan lives in ``analysis/astutils.py``."""
    from ..analysis.astutils import autograd_hazard

    return autograd_hazard(stmts)


def _differentiates(stmts) -> bool:
    """Whether ``stmts`` differentiate: a ``*.backward(...)`` or
    ``*.grad(...)`` call. The port's piecewise rule needs only these: a
    captured prefix hands its carries over detached, while gradients and
    optimizer state live on the parameters across the split, so an
    optimizer step after the break is safe where a backward through a
    carried tensor is not."""
    for stmt in stmts:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("backward", "grad")):
                return True
    return False


def split_at_break(fn: Callable, break_line: int):
    """Split ``fn`` into (prefix_fn, break_fn, suffix_fn, info) at the
    TOP-LEVEL statement containing absolute source line ``break_line``.

    The piecewise-capture core (reference: SOT's graph-break + resume
    functions, jit/sot/opcode_translator/executor/opcode_executor.py:305,
    1594 — there at bytecode level, here at statement level):

    - ``prefix_fn``: original signature, runs statements before the
      break, returns ``{name: value}`` for every local the rest needs;
    - ``break_fn(carry) -> carry2``: the breaking statement, to run
      EAGERLY each call (host control flow and side effects preserved);
    - ``suffix_fn(carry2)``: the remaining statements (original returns
      included).

    Returns None when the function cannot be split safely: source
    unavailable, the break line is not inside a top-level statement, a
    ``return`` occurs at or before the breaking statement, or
    global/nonlocal declarations are present. Free variables are bound
    by VALUE at split time (late rebinding of closure cells is not
    reflected — same trade as jit constant capture).
    """
    try:
        code = fn.__code__
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
        fndef = tree.body[0]
        if not isinstance(fndef, ast.FunctionDef):
            return None
        rel = break_line - code.co_firstlineno + 1
        idx = None
        for i, stmt in enumerate(fndef.body):
            if stmt.lineno <= rel <= (stmt.end_lineno or stmt.lineno):
                idx = i
                break
        if idx is None:
            return None
        body = fndef.body
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    return None
        # a return at/before the break would have to skip the suffix
        # (returns inside nested function scopes don't count)
        class _ReturnFinder(ast.NodeVisitor):
            found = False

            def visit_Return(self, node):
                self.found = True

            def visit_FunctionDef(self, node):
                pass

            def visit_AsyncFunctionDef(self, node):
                pass

            def visit_Lambda(self, node):
                pass

        rf = _ReturnFinder()
        for stmt in body[: idx + 1]:
            rf.visit(stmt)
        if rf.found:
            return None

        params = {a.arg for a in (
            *fndef.args.posonlyargs, *fndef.args.args,
            *fndef.args.kwonlyargs)}
        if fndef.args.vararg:
            params.add(fndef.args.vararg.arg)
        if fndef.args.kwarg:
            params.add(fndef.args.kwarg.arg)

        avail1 = params | _stmt_names(body[:idx], ast.Store)
        used_after = _stmt_names(body[idx:], ast.Load)
        carry1 = sorted(avail1 & used_after)
        avail2 = avail1 | _stmt_names([body[idx]], ast.Store)
        used_suffix = _stmt_names(body[idx + 1:], ast.Load)
        carry2 = sorted(avail2 & used_suffix)

        sig = ast.unparse(fndef.args)
        rt = _RUNTIME_NAME

        def _block(stmts, extra_indent="    "):
            if not stmts:
                return ""
            return textwrap.indent(
                "\n".join(ast.unparse(s) for s in stmts), extra_indent) + "\n"

        def _ret_carry(names):
            keys = ", ".join(repr(n) for n in names)
            return (f"    __pt_l = dict(locals())\n"
                    f"    return {{k: __pt_l[k] for k in ({keys},)"
                    f" if k in __pt_l}}\n")

        def _unpack(names):
            return "".join(
                f"    {n} = {rt}._carry_get(__pt_carry, {n!r})\n"
                for n in names)

        name = fndef.name
        parts = [
            f"def __pt_prefix({sig}):\n"
            + _block(body[:idx]) + _ret_carry(carry1),
            f"def __pt_break(__pt_carry):\n"
            + _unpack(carry1) + _block([body[idx]]) + _ret_carry(carry2),
            f"def __pt_suffix(__pt_carry):\n"
            + _unpack(carry2) + (_block(body[idx + 1:]) or "    pass\n"),
        ]
        module_src = "\n".join(parts)
        # LIVE globals (the function's own module dict) + the original
        # closure CELLS rebound onto the generated code — module-global
        # or closure rebinding between calls stays visible, same as
        # eager execution (the earlier by-value snapshot silently froze
        # them). Same factory pattern as _compile_transform.
        import types

        gl = fn.__globals__
        gl.setdefault(rt, sys.modules[__name__])
        ns: Dict[str, Any] = {}
        filename = f"<piecewise:{inspect.getsourcefile(fn) or '?'}:{name}>"
        if code.co_freevars and fn.__closure__:
            factory_src = (
                "def __pt_factory(" + ", ".join(code.co_freevars) + "):\n"
                + textwrap.indent(module_src, "    ")
                + "\n    return __pt_prefix, __pt_break, __pt_suffix\n")
            exec(compile(factory_src, filename, "exec"), gl, ns)
            templates = ns["__pt_factory"](*[None] * len(code.co_freevars))
            cellmap = dict(zip(code.co_freevars, fn.__closure__))

            def _rebind(tmpl):
                cells = tuple(
                    cellmap[n] for n in tmpl.__code__.co_freevars)
                f2 = types.FunctionType(
                    tmpl.__code__, gl, tmpl.__name__, tmpl.__defaults__,
                    cells)
                f2.__kwdefaults__ = tmpl.__kwdefaults__
                return f2

            ns["__pt_prefix"], ns["__pt_break"], ns["__pt_suffix"] = (
                _rebind(t) for t in templates)
        else:
            exec(compile(module_src, filename, "exec"), gl, ns)
        info = {
            "stmt": ast.unparse(body[idx]).splitlines()[0][:80],
            "line": break_line,
            "carry1": carry1,
            "carry2": carry2,
            # the reference's static hazard scan (its demotion rule)
            "grad_hazard": _autograd_hazard(body[idx:]),
            # the port's rule (see _differentiates): the caller demotes
            # when this is set and a carried tensor requires grad
            "differentiates": _differentiates(body[idx:]),
        }
        pre, brk, suf = ns["__pt_prefix"], ns["__pt_break"], ns["__pt_suffix"]
        pre.__name__ = f"{name}__prefix"
        suf.__name__ = f"{name}__suffix"
        for f_ in (pre, brk, suf):
            f_.__globals__[rt] = sys.modules[__name__]
        return pre, brk, suf, info
    except Exception:
        return None
