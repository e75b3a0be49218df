"""Port parity: control-flow conversion and the piecewise split of
``paddle_tpu_torch.jit`` against ``paddle_tpu.jit`` (the reference's
``tests/test_dy2static.py`` cases, on the port).

Each case builds one function per package (``J``: the JAX package, whose
``to_static`` traces it; ``T``: the port) from the same source and feeds both
the same numpy inputs. The port's converted code runs with the select path on:
``testing.capture.cpu_capture()`` makes a ``StaticFunction`` over CPU tensors
follow a capture's rules from its second call on (the first is the warm-up,
as on the card), and ``dy2static.select_mode()`` does the same for a
converted function called directly. Tolerances: values 1e-6 (f32), gradients 1e-5, training
trajectories 1e-5.

Deliberate differences, each asserted here: a tensor ``while`` inside a capture
raises ``GraphBreakError`` unless ``FLAGS_dy2static_while_grad_bound`` is set
(the reference runs an unbounded ``lax.while_loop`` without gradients); a
host-bounded ``for`` runs as a Python loop (the reference scans it); an
optimizer step after a graph break stays piecewise (gradients live on the
parameters across the split), where the reference demotes.
"""
import ast
import functools
import inspect
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as pjit
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import dy2static as jd2s
from paddle_tpu_torch import autograd as tautograd
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.base import flags as tflags
from paddle_tpu_torch.jit import dy2static as td2s
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.testing.capture import cpu_capture
from paddle_tpu_torch.utils import load_jax_params

VAL = 1e-6
GRAD = 1e-5
TRAIN = 1e-5


class J:
    """The JAX package's side."""
    name = "jax"
    jit, d2s = pjit, jd2s
    GraphBreakError = jd2s.GraphBreakError

    @staticmethod
    def t(a):
        return paddle.to_tensor(np.asarray(a))

    @staticmethod
    def req(x):
        x.stop_gradient = False
        return x

    @staticmethod
    def npy(x):
        return np.asarray(x.numpy())

    @staticmethod
    def grad(outputs, inputs, allow_unused=False):
        return paddle.grad(outputs=outputs, inputs=inputs,
                           allow_unused=allow_unused)

    @staticmethod
    def set_bound(n):
        paddle.set_flags({"dy2static_while_grad_bound": n})

    @staticmethod
    def static(f, **kw):
        return pjit.to_static(f, **kw)

    @staticmethod
    def run_converted(conv, *xs):
        """A converted function under trace (the select path)."""
        import jax

        wrapped = lambda *vs: conv(*[paddle.to_tensor(v) for v in vs])  # noqa: E731
        out = jax.jit(lambda *vs: jax.tree_util.tree_map(
            lambda t: t._data + 0, wrapped(*vs),
            is_leaf=lambda t: hasattr(t, "_data")))(*xs)
        return jax.tree_util.tree_map(np.asarray, out)

    @staticmethod
    def linear(seed):
        paddle.seed(seed)
        return jnn.Linear(4, 3)

    F = JF


class T:
    """The port's side."""
    name = "torch"
    jit, d2s = tjit, td2s
    GraphBreakError = td2s.GraphBreakError

    @staticmethod
    def t(a):
        return torch.tensor(np.asarray(a))

    @staticmethod
    def req(x):
        return x.requires_grad_(True)

    @staticmethod
    def npy(x):
        return x.detach().numpy()

    @staticmethod
    def grad(outputs, inputs, allow_unused=False):
        return tautograd.grad(outputs, inputs, allow_unused=allow_unused)

    @staticmethod
    def set_bound(n):
        tflags.set_flags({"dy2static_while_grad_bound": n})

    @staticmethod
    def static(f, **kw):
        return tjit.to_static(f, **kw)

    @staticmethod
    def run_converted(conv, *xs):
        with td2s.select_mode():
            out = conv(*[torch.tensor(v) for v in xs])
        return [o.detach().numpy() for o in out] if isinstance(
            out, (tuple, list)) else out.detach().numpy()

    @staticmethod
    def linear(seed):
        jl = J.linear(seed)
        tl = tnn.Linear(4, 3, device="cpu", dtype=torch.float32)
        load_jax_params(tl, {n: np.asarray(p._data)
                             for n, p in jl.named_parameters()})
        return tl

    F = TF


@pytest.fixture(autouse=True)
def _capture_on_cpu():
    with cpu_capture():
        yield
    J.set_bound(0)
    T.set_bound(0)


def _warm(sf, *args):
    """The port's warm-up call (eager, as on the card); later calls follow
    the capture's rules."""
    sf(*args)
    return sf


def _both(make, *inputs, warm=None):
    """``make(P)`` -> a function; each package's ``to_static`` of it on the
    same inputs (the port warmed up first). Returns [(jax out, torch out)]
    per input tuple."""
    jf, tf = make(J), make(T)
    js, ts = J.static(jf), T.static(tf)
    _warm(ts, *[T.t(a) for a in (warm or inputs[0])])
    return [(js(*[J.t(a) for a in ins]), ts(*[T.t(a) for a in ins]))
            for ins in inputs]


def _close(a, b, tol=VAL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


# -- tensor if -----------------------------------------------------------------

class TestTensorIf:
    def test_if_matches_eager(self):
        def make(P):
            def f(x):
                if x.sum() > 0:
                    y = x * 2.0
                else:
                    y = x - 1.0
                return y
            return f

        pos, neg = [np.array([1.0, 2.0], np.float32)], [np.array([-3.0, 1.0], np.float32)]
        for (jo, to), ins in zip(_both(make, pos, neg), (pos, neg)):
            _close(T.npy(to), J.npy(jo))
            _close(T.npy(to), T.npy(make(T)(T.t(ins[0]))))

    def test_if_without_else(self):
        def make(P):
            def f(x):
                y = x + 1.0
                if x.mean() > 0:
                    y = y * 10.0
                return y
            return f

        for jo, to in _both(make, [np.array([0.5, 0.5], np.float32)],
                            [np.array([-0.5, -0.5], np.float32)]):
            _close(T.npy(to), J.npy(jo))

    def test_grad_flows_through_if(self):
        def make(P):
            def step(x):
                P.req(x)
                if x.sum() > 0:
                    y = (x * 3.0).sum()
                else:
                    y = (x * 5.0).sum()
                y.backward()
                return y, x.grad
            return step

        res = _both(make, [np.array([1.0, 1.0], np.float32)],
                    [np.array([-1.0, -1.0], np.float32)])
        for (jo, to), want in zip(res, ([3.0, 3.0], [5.0, 5.0])):
            _close(T.npy(to[1]), J.npy(jo[1]), GRAD)
            _close(T.npy(to[1]), want, GRAD)

    def test_python_if_untouched(self):
        def make(P, mode):
            def f(x):
                if mode == "double":   # plain python predicate
                    y = x * 2.0
                else:
                    y = x * 3.0
                return y
            return f

        for mode, want in (("double", 2.0), ("triple", 3.0)):
            x = np.array([1.0], np.float32)
            ts = _warm(T.static(make(T, mode)), T.t(x))
            _close(T.npy(ts(T.t(x))), J.npy(J.static(make(J, mode))(J.t(x))))
            _close(T.npy(ts(T.t(x))), [want])

    def test_nested_if(self):
        def make(P):
            def f(x):
                if x.sum() > 0:
                    if x.max() > 10:
                        y = x * 100.0
                    else:
                        y = x * 2.0
                else:
                    y = -x
                return y
            return f

        ins = [[np.array(a, np.float32)] for a in ([20.0, 1.0], [1.0, 1.0], [-5.0, 1.0])]
        for jo, to in _both(make, *ins):
            _close(T.npy(to), J.npy(jo))


# -- tensor while ---------------------------------------------------------------

class TestTensorWhile:
    def test_while_matches_eager(self):
        def make(P):
            def f(x):
                s = P.t(np.float32(0.0))
                i = P.t(np.float32(0.0))
                while i < 5.0:
                    s = s + x.sum() * 0.0 + i
                    i = i + 1.0
                return s
            return f

        x = np.array([1.0], np.float32)
        want = float(J.static(make(J))(J.t(x)))
        assert want == 10.0
        T.set_bound(8)  # the port's capturable form
        ts = _warm(T.static(make(T)), T.t(x))
        _close(float(ts(T.t(x))), want)

    def test_data_dependent_trip_count(self):
        def make(P):
            def f(x):
                n = P.t(np.float32(0.0))
                v = x.sum()
                while v > 1.0:
                    v = v / 2.0
                    n = n + 1.0
                return n
            return f

        js = J.static(make(J))
        T.set_bound(16)
        ts = _warm(T.static(make(T)), T.t(np.array([2.0], np.float32)))
        for v, want in ((8.0, 3.0), (32.0, 5.0)):
            x = np.array([v], np.float32)
            assert float(js(J.t(x))) == want
            assert float(ts(T.t(x))) == want

    def test_while_without_bound_is_a_graph_break_in_the_port(self):
        """The deliberate difference: no data-dependent trip count inside a
        CUDA graph; ``full_graph=True`` raises the graph break."""
        def f(x):
            n = torch.tensor(0.0)
            v = x.sum()
            while v > 1.0:
                v = v / 2.0
                n = n + 1.0
            return n

        x = torch.tensor([8.0])
        ts = _warm(T.static(f), x)
        with pytest.raises(td2s.GraphBreakError, match="while_grad_bound"):
            ts(x)


# -- graph-break errors ---------------------------------------------------------

class TestGraphBreakError:
    def test_helper_function_gets_actionable_error(self):
        def make(P):
            def helper(x):
                if x.sum() > 0:
                    return x * 2.0
                return x * 3.0

            def f(x):
                return helper(x) + 1.0
            return f

        x = np.array([1.0], np.float32)
        with pytest.raises(RuntimeError, match="tensor-dependent Python control flow"):
            J.static(make(J))(J.t(x))
        ts = _warm(T.static(make(T)), T.t(x))
        with pytest.raises(RuntimeError, match="tensor-dependent Python control flow"):
            ts(T.t(x))

    def test_error_names_options(self):
        def make(P):
            def f(x):
                while x.sum() > 0:
                    x = x - 1.0
                    if x.max() > 100:
                        break
                return x
            return f

        x = np.array([1.0], np.float32)
        with pytest.raises(RuntimeError, match="not_to_static"):
            J.static(make(J))(J.t(x))
        ts = _warm(T.static(make(T)), T.t(x))
        with pytest.raises(RuntimeError, match="not_to_static"):
            ts(T.t(x))

    def test_message_equals_the_reference(self):
        """``graph_break_error`` on the same host read gives the
        reference's message (package names aside) and frames naming this
        file."""
        def read(x):
            return bool(x)

        errs = []
        for exc_of in (lambda: read(np.zeros(2)),):
            try:
                exc_of()
            except ValueError as e:
                errs.append((jd2s.graph_break_error(e), td2s.graph_break_error(e)))
        (je, te), = errs
        norm = lambda s: s.replace("paddle_tpu_torch", "paddle_tpu")  # noqa: E731
        assert norm(str(te)) == norm(str(je))
        assert te.frames and te.frames[0][0] == __file__
        assert [f for f in te.frames if f[0] == __file__] == \
            [f for f in je.frames if f[0] == __file__]


def _module_level_helper(x):
    return x * 7.0


# -- convert(): edge cases --------------------------------------------------------

class TestConvertEdgeCases:
    def test_wrapped_functions_left_alone(self):
        def deco(g):
            @functools.wraps(g)
            def inner(*a):
                return g(*a)
            return inner

        def add_one(x):
            if x.sum() > 0:
                y = x + 1.0
            else:
                y = x
            return y

        def mul_ten(x):
            if x.sum() > 0:
                y = x * 10.0
            else:
                y = x
            return y

        for P in (J, T):
            f1, f2 = P.d2s.convert(deco(add_one)), P.d2s.convert(deco(mul_ten))
            x = P.t(np.array([3.0], np.float32))
            _close(P.npy(f1(x)), [4.0])
            _close(P.npy(f2(x)), [30.0])

    def test_late_binding_globals(self):
        def f(x):
            if x.sum() > 0:
                y = _module_level_helper(x)
            else:
                y = x
            return y

        x = np.array([2.0], np.float32)
        _close(T.run_converted(T.d2s.convert(f), x),
               J.run_converted(J.d2s.convert(f), x))
        _close(T.run_converted(T.d2s.convert(f), x), [14.0])

    def test_concrete_counter_loop_keeps_grads(self):
        def make(P):
            def step(x):
                P.req(x)
                i = 0
                y = x
                while i < 3:
                    y = y * 2.0
                    i += 1
                loss = y.sum()
                loss.backward()
                return loss, x.grad
            return step

        (jo, to), = _both(make, [np.array([1.0, 2.0], np.float32)])
        _close(T.npy(to[1]), J.npy(jo[1]), GRAD)
        _close(T.npy(to[1]), [8.0, 8.0], GRAD)

    def test_del_in_branch_blocks_conversion(self):
        def f(x):
            if True:
                tmp = x + 1.0
                y = tmp * 2.0
                del tmp
            return y

        for P in (J, T):
            conv = P.d2s.convert(f)
            assert conv is f
            _close(P.npy(conv(P.t(np.array([3.0], np.float32)))), [8.0])

    def test_unbound_after_untaken_branch_raises_like_eager(self):
        def f(x, flag):
            if flag:
                y = x * 2.0
            return y

        for P in (J, T):
            conv = P.d2s.convert(f)
            x = P.t(np.array([1.0], np.float32))
            _close(P.npy(conv(x, True)), [2.0])
            with pytest.raises(UnboundLocalError):
                conv(x, False)

    def test_closure_cells_stay_live(self):
        def make(P):
            scale = P.t(np.array([2.0], np.float32))

            def f(x):
                if x.sum() > 0:
                    y = x * scale
                else:
                    y = x
                return y
            return f

        x = np.array([3.0], np.float32)
        got = T.run_converted(T.d2s.convert(make(T)), x)
        _close(got, J.run_converted(J.d2s.convert(make(J)), x))
        _close(got, [6.0])


class TestConvertDirect:
    def test_convert_is_cached_and_identity_safe(self):
        def plain(x):
            return x + 1

        for P in (J, T):
            assert P.d2s.convert(plain) is plain
            assert P.d2s.convert(plain) is plain

    def test_single_branch_assignment_defers_error_to_use(self):
        def f(x):
            if x.sum() > 0:
                z = x * 2.0  # noqa: F841 -- deliberately one-branch
            else:
                w = x * 3.0  # noqa: F841 -- different name on purpose
            return x

        x = np.array([1.0], np.float32)
        _close(T.run_converted(T.d2s.convert(f), x),
               J.run_converted(J.d2s.convert(f), x))

        def g(x):
            if x.sum() > 0:
                z = x * 2.0
            return z

        for P in (J, T):
            with pytest.raises((UnboundLocalError, NameError)):
                P.run_converted(P.d2s.convert(g), x)

    def test_single_branch_with_incoming_binding_selects(self):
        def f(x):
            y = x
            if x.sum() > 0:
                y = x * 2.0
            return y

        for v, want in ((2.0, 4.0), (-2.0, -2.0)):
            x = np.array([v], np.float32)
            got = T.run_converted(T.d2s.convert(f), x)
            _close(got, J.run_converted(J.d2s.convert(f), x))
            _close(got, [want])


# -- for range ------------------------------------------------------------------

class TestForRangeConversion:
    def test_scan_matches_unrolled_values_and_grads(self):
        def make(P):
            def step(x):
                P.req(x)
                h = x
                for i in range(5):
                    h = h * 0.5 + x * 0.1  # tensor-carried body
                loss = h.sum()
                loss.backward()
                return loss, x.grad
            return step

        (jo, to), = _both(make, [np.array([1.0, -2.0, 3.0], np.float32)])
        _close(float(to[0]), float(jo[0]))
        _close(T.npy(to[1]), J.npy(jo[1]), GRAD)

    def test_long_range_runs_as_a_python_loop(self):
        """The reference scans a long range (one XLA body); the port runs
        the Python loop, which a capture records unrolled. Same values."""
        def f(x):
            h = x
            for i in range(64):
                h = h * 0.99 + 0.01
            return h

        x = np.ones((2,), np.float32)
        _close(T.run_converted(T.d2s.convert(f), x),
               J.run_converted(J.d2s.convert(f), x), 1e-5)

    def test_target_binding_after_loop(self):
        def f(x):
            acc = x
            for i in range(4):
                acc = acc + i
            return acc, i

        for P in (J, T):
            acc, i = P.d2s.convert(f)(P.t(np.zeros((1,), np.float32)))
            assert float(acc[0]) == 6.0
            assert int(i) == 3

    def test_zero_trip_loop(self):
        def f(x):
            acc = x
            for i in range(0):
                acc = acc + 100.0
            return acc

        for P in (J, T):
            assert float(P.d2s.convert(f)(P.t(np.ones((1,), np.float32)))[0]) == 1.0

    def test_mutating_body_left_unrolled(self):
        def f(x):
            outs = []
            h = x
            for i in range(3):
                h = h + 1.0
                outs.append(h)
            return outs

        for P in (J, T):
            outs = P.d2s.convert(f)(P.t(np.zeros((1,), np.float32)))
            assert [float(o[0]) for o in outs] == [1.0, 2.0, 3.0]

    def test_traced_bound_runs_as_while(self):
        def make(P):
            def f(x, n):
                acc = x * 0.0
                for i in range(n.astype("int32") if P is J else n.to(torch.int32)):
                    acc = acc + x
                return acc.sum()
            return f

        js = J.static(make(J))
        T.set_bound(8)
        ts = _warm(T.static(make(T)), T.t(np.array([2.0], np.float32)),
                   T.t(np.asarray(1)))
        for n, want in ((3, 6.0), (5, 10.0)):
            x = np.array([2.0], np.float32)
            assert float(js(J.t(x), J.t(np.asarray(n)))) == want
            assert float(ts(T.t(x), T.t(np.asarray(n)))) == want

    def test_rewrite_is_the_references(self):
        """The AST rewrite is the reference's, statement for statement:
        the same generated helpers, in the same order."""
        def f(x, n):
            acc = x
            for i in range(3):
                acc = acc + i
            while acc.sum() > n:
                acc = acc - 1.0
            if acc.sum() > 0:
                y = acc
            else:
                y = -acc
            return y

        src = ast.parse(textwrap.dedent(inspect.getsource(f)))
        outs = []
        for mod in (jd2s, td2s):
            tree = ast.parse(textwrap.dedent(inspect.getsource(f)))
            tree = ast.fix_missing_locations(mod._Transformer().visit(tree))
            outs.append(ast.unparse(tree).replace(mod._RUNTIME_NAME, "RT"))
        assert outs[0] == outs[1]
        assert ast.unparse(src) != outs[0]


# -- while gradients ------------------------------------------------------------------

class TestWhileGrad:
    def test_bounded_scan_grad_matches_eager(self):
        def make(P):
            def step(x):
                P.req(x)
                h = x
                while h.sum() < 20.0:
                    h = h * 2.0
                loss = h.sum()
                loss.backward()
                return loss, x.grad
            return step

        x = np.array([1.0, 2.0], np.float32)
        le, ge = make(T)(T.t(x))
        assert float(le) == 24.0
        for P in (J, T):
            P.set_bound(8)
        (jo, to), = _both(make, [x])
        _close(float(to[0]), 24.0)
        _close(T.npy(to[1]), J.npy(jo[1]), GRAD)
        _close(T.npy(to[1]), T.npy(ge), GRAD)

    def test_without_flag_reference_stops_gradient_port_breaks(self):
        def make(P):
            def step(x):
                P.req(x)
                h = x
                while h.sum() < 20.0:
                    h = h * 2.0
                loss = h.sum()
                g = P.grad([loss], [x], allow_unused=True)[0]
                return loss, g
            return step

        x = np.array([1.0, 2.0], np.float32)
        loss, g = J.static(make(J))(J.t(x))
        assert float(loss) == 24.0 and g is None
        ts = _warm(T.static(make(T)), T.t(x))
        with pytest.raises(td2s.GraphBreakError):
            ts(T.t(x))

    def test_grad_finite_difference(self):
        def make(P):
            def step(x):
                P.req(x)
                h = x
                while (h * h).sum() < 50.0:
                    h = h * 1.5 + 0.1
                loss = (h * h).sum()
                loss.backward()
                return loss, x.grad
            return step

        for P in (J, T):
            P.set_bound(16)
        js = J.static(make(J))
        ts = _warm(T.static(make(T)), T.t(np.array([1.0, 0.5], np.float32)))
        x0 = np.array([1.0, 0.5], np.float64)
        for P, sf in ((J, js), (T, ts)):
            def val(v):
                loss, g = sf(P.t(v.astype(np.float32)))
                return float(loss), g

            g = P.npy(val(x0)[1])
            eps = 1e-3
            for k in range(2):
                xp, xm = x0.copy(), x0.copy()
                xp[k] += eps
                xm[k] -= eps
                fd = (val(xp)[0] - val(xm)[0]) / (2 * eps)
                np.testing.assert_allclose(g[k], fd, rtol=2e-2, atol=1e-3)
        _close(T.npy(ts(T.t(x0.astype(np.float32)))[1]),
               J.npy(js(J.t(x0.astype(np.float32)))[1]), GRAD)


class TestReviewEdgeCases:
    def test_attribute_mutation_left_unrolled(self):
        class M(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.outs = []

            def forward(self, x):
                h = x
                for i in range(3):
                    h = h + 1.0
                    self.outs.append(h)
                return h

        m = M()
        conv = td2s.convert(M.forward)
        with td2s.select_mode():
            out = conv(m, torch.zeros(1))
        assert float(out[0]) == 3.0
        assert [float(o[0]) for o in m.outs] == [1.0, 2.0, 3.0]

    def test_traced_bound_closure_grads_flow(self):
        def make(P):
            def step(x, n):
                P.req(x)
                h = x * 0.0
                for i in range(n.astype("int32") if P is J else n.to(torch.int32)):
                    h = h * 0.5 + x * 0.1
                loss = h.sum()
                loss.backward()
                return loss, x.grad
            return step

        for P in (J, T):
            P.set_bound(8)
        x, n = np.array([2.0], np.float32), np.asarray(3)
        (jo, to), = _both(make, [x, n])
        _close(T.npy(to[1]), [0.175], GRAD)
        _close(T.npy(to[1]), J.npy(jo[1]), GRAD)

    def test_check_numerics_inside_a_capture_skips(self):
        from paddle_tpu_torch.amp import debugging as tdbg

        def f(x):
            nan, inf, numel = tdbg.check_numerics(x)
            return x * 1.0

        ts = _warm(T.static(f), torch.ones(2))
        assert float(ts(torch.ones(2)).sum()) == 2.0


# -- early-return if ----------------------------------------------------------------

class TestEarlyReturnIf:
    def test_guard_pattern_converts(self):
        def make(P):
            def f(x):
                if x.sum() > 0:
                    return x * 2.0
                return x * 3.0
            return f

        res = _both(make, [np.array([1.0], np.float32)], [np.array([-1.0], np.float32)])
        for (jo, to), want in zip(res, ([2.0], [-3.0])):
            _close(T.npy(to), J.npy(jo))
            _close(T.npy(to), want)

    def test_chained_guards(self):
        def make(P):
            def f(x):
                if x.sum() > 10:
                    return x * 100.0
                if x.sum() > 0:
                    y = x + 1.0
                    return y * 2.0
                return -x
            return f

        ins = [[np.array([v], np.float32)] for v in (20.0, 1.0, -5.0)]
        for (jo, to), want in zip(_both(make, *ins), (2000.0, 4.0, 5.0)):
            _close(T.npy(to), J.npy(jo))
            _close(float(to[0]), want)

    def test_tuple_returns_and_else(self):
        def make(P):
            def f(x):
                if x.sum() > 0:
                    return x * 2.0, x + 1.0
                else:
                    return x * 3.0, x - 1.0
            return f

        (jo, to), = _both(make, [np.array([2.0], np.float32)])
        _close(T.npy(to[0]), [4.0])
        _close(T.npy(to[1]), [3.0])
        _close(T.npy(to[0]), J.npy(jo[0]))

    def test_structure_mismatch_raises(self):
        def f(x):
            if x.sum() > 0:
                return x, x
            return x

        for P in (J, T):
            with pytest.raises(Exception, match="STRUCTURE|structure"):
                P.run_converted(P.d2s.convert(f), np.array([1.0], np.float32))

    def test_concrete_predicate_unchanged(self):
        def f(x, flag):
            if flag:
                return x * 2.0
            return x * 5.0

        for P in (J, T):
            conv = P.d2s.convert(f)
            x = P.t(np.array([1.0], np.float32))
            _close(P.npy(conv(x, True)), [2.0])
            _close(P.npy(conv(x, False)), [5.0])

    def test_shadowing_continuation_reads_pre_if_binding(self):
        def make(P):
            def f(x):
                y = x * 2.0
                if x.sum() > 0:
                    y = y + 1.0
                    return y
                y = y - 1.0
                return y
            return f

        res = _both(make, [np.array([1.0], np.float32)], [np.array([-1.0], np.float32)])
        for (jo, to), want in zip(res, ([3.0], [-3.0])):
            _close(T.npy(to), J.npy(jo))
            _close(T.npy(to), want)

    def test_generator_functions_left_alone(self):
        def g(x):
            if x > 0:
                return x
            yield x

        for P in (J, T):
            assert inspect.isgeneratorfunction(P.d2s.convert(g))


# -- full_graph=False -------------------------------------------------------------------

def _breaking_fn(P):
    def helper(x):
        # helpers are not converted; a tensor-if with returns inside is the
        # canonical graph-break site
        if x.sum() > 0:
            return x * 2.0
        return x * 3.0

    def f(x):
        return helper(x) + 1.0

    return f


class TestFullGraphFallback:
    def test_fallback_matches_eager(self):
        xp, xn = np.array([1.0, 2.0], np.float32), np.array([-1.0, -2.0], np.float32)
        js = J.static(_breaking_fn(J), full_graph=False)
        with pytest.warns(UserWarning, match="graph break"):
            jp = js(J.t(xp))
        ts = _warm(T.static(_breaking_fn(T), full_graph=False), T.t(xp))
        with pytest.warns(UserWarning, match="graph break"):
            tp = ts(T.t(xp))
        _close(T.npy(tp), J.npy(jp))
        _close(T.npy(ts(T.t(xn))), J.npy(js(J.t(xn))))
        assert ts._fallback_eager and js._fallback_eager

    def test_default_full_graph_still_raises(self):
        x = np.array([1.0], np.float32)
        ts = _warm(T.static(_breaking_fn(T)), T.t(x))
        with pytest.raises(RuntimeError, match="tensor-dependent"):
            ts(T.t(x))
        with pytest.raises(RuntimeError, match="tensor-dependent"):
            J.static(_breaking_fn(J))(J.t(x))

    def test_training_state_rolls_back_and_continues(self):
        def make(P, model, o):
            def step(x, y):
                logits = model(x)
                if float(logits.sum()) > -1e30:  # host read -> break
                    loss = P.F.cross_entropy(logits, y)
                loss.backward()
                o.step()
                o.clear_grad()
                return loss
            return step

        xs, ys = _data(0, 4)
        m1 = T.linear(0)
        o1 = topt.AdamW(learning_rate=0.01, parameters=m1.parameters())
        eager = make(T, m1, o1)
        want = [float(eager(T.t(x), T.t(y))) for x, y in zip(xs, ys)]
        got, jgot, sf, jsf, o2, jo = _train_pair(
            lambda P, m, o: make(P, m, o), xs, ys, popt="AdamW")
        _close(got, want, TRAIN)
        _close(got, jgot, TRAIN)
        assert o2._global_step == o1._global_step == jo._global_step
        assert sf._fallback_eager

    def test_multi_step_refused_after_fallback(self):
        x = np.array([1.0], np.float32)
        ts = _warm(T.static(_breaking_fn(T), full_graph=False), T.t(x))
        with pytest.warns(UserWarning, match="graph break"):
            ts(T.t(x))
        with pytest.raises(RuntimeError, match="full-graph"):
            ts.multi_step(T.t(np.array([[1.0]], np.float32)))

    def test_convertible_fn_stays_captured(self):
        def make(P):
            def f(x):
                if x.sum() > 0:
                    y = x * 2.0
                else:
                    y = x - 1.0
                return y
            return f

        x = np.array([1.0, 2.0], np.float32)
        ts = _warm(T.static(make(T), full_graph=False), T.t(x))
        _close(T.npy(ts(T.t(x))), J.npy(J.static(make(J), full_graph=False)(J.t(x))))
        assert not ts._fallback_eager and ts._graphs


def _data(seed, n):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(8, 4).astype(np.float32) for _ in range(n)]
    ys = [rng.randint(0, 3, (8,)).astype(np.int64) for _ in range(n)]
    return xs, ys


def _train_pair(make, xs, ys, popt="AdamW", seed=0, lr=0.01, warn=True):
    """The same training step, ``to_static(full_graph=False)`` in both
    packages from one initial state; the port's first call is its warm-up
    (counted like any other step). Returns the port's and the reference's
    losses, both StaticFunctions and both optimizers."""
    jm = J.linear(seed)
    tm = T.linear(seed)
    jo = getattr(jopt, popt)(learning_rate=lr, parameters=jm.parameters())
    to = getattr(topt, popt)(learning_rate=lr, parameters=tm.parameters())
    jsf = J.static(make(J, jm, jo), layers=[jm], optimizers=[jo], full_graph=False)
    tsf = T.static(make(T, tm, to), layers=[tm], optimizers=[to], full_graph=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jgot = [float(jsf(J.t(x), J.t(y))) for x, y in zip(xs, ys)]
        got = [float(tsf(T.t(x), T.t(y))) for x, y in zip(xs, ys)]
    for pj, pt in zip(jm.parameters(), tm.parameters()):
        _close(T.npy(pt), np.asarray(pj._data), TRAIN)
    return got, jgot, tsf, jsf, to, jo


# -- the piecewise split ---------------------------------------------------------------

class TestPiecewiseCapture:
    @staticmethod
    def _make(P, model, o, log):
        def step(x, y):
            logits = model(x)
            loss = P.F.cross_entropy(logits, y)
            loss.backward()
            o.step()
            o.clear_grad()
            if float(loss) > -1e30:  # host read -> graph break
                log.append(1)
            metric = loss * 2.0 + 1.0
            return metric
        return step

    def test_prefix_and_suffix_run_captured(self):
        xs, ys = _data(0, 5)
        log, jlog = [], []
        tm, o = T.linear(0), None
        o = topt.AdamW(learning_rate=0.01, parameters=tm.parameters())
        sf = T.static(self._make(T, tm, o, log), layers=[tm], optimizers=[o],
                      full_graph=False)
        got = [float(sf(T.t(xs[0]), T.t(ys[0])))]  # warm-up
        with pytest.warns(UserWarning, match="piecewise capture"):
            got.append(float(sf(T.t(xs[1]), T.t(ys[1]))))
        assert sf._piecewise is not None and not sf._fallback_eager
        pre, suf = sf._piecewise._prefix_sf, sf._piecewise._suffix_sf
        got += [float(sf(T.t(x), T.t(y))) for x, y in zip(xs[2:], ys[2:])]
        assert pre._graphs and suf._graphs  # each its own capture
        assert len(pre._graphs) == len(suf._graphs) == 1
        assert log == [1] * 5  # the breaking statement ran on every call
        jm = J.linear(0)
        jo = jopt.AdamW(learning_rate=0.01, parameters=jm.parameters())
        jsf = J.static(self._make(J, jm, jo, jlog), layers=[jm], optimizers=[jo],
                       full_graph=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = [float(jsf(J.t(x), J.t(y))) for x, y in zip(xs, ys)]
        _close(got, want, TRAIN)
        assert o._global_step == jo._global_step == 5

    def test_optimizer_step_after_the_break_stays_piecewise(self):
        """The port's rule: gradients live on the parameters across the
        split, so a host read between backward and ``opt.step()`` keeps
        the split (the reference demotes: its grads do not cross)."""
        def make(P, model, opt, log):
            def step(x, y):
                loss = P.F.cross_entropy(model(x), y)
                loss.backward()
                log.append(float(loss))  # host read -> graph break
                opt.step()
                opt.clear_grad()
                return loss
            return step

        xs, ys = _data(5, 5)
        log = []
        tm = T.linear(3)
        o = topt.AdamW(learning_rate=0.01, parameters=tm.parameters())
        sf = T.static(make(T, tm, o, log), layers=[tm], optimizers=[o],
                      full_graph=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = [float(sf(T.t(x), T.t(y))) for x, y in zip(xs, ys)]
        assert sf._piecewise is not None and not sf._fallback_eager
        assert sf._piecewise._info["grad_hazard"]  # the reference's scan
        assert not sf._piecewise._info["differentiates"]
        m2 = T.linear(3)
        o2 = topt.AdamW(learning_rate=0.01, parameters=m2.parameters())
        eager = make(T, m2, o2, [])
        want = [float(eager(T.t(x), T.t(y))) for x, y in zip(xs, ys)]
        _close(got, want, TRAIN)
        _close(log, want, TRAIN)
        assert o._global_step == o2._global_step == 5
        for a, b in zip(tm.parameters(), m2.parameters()):
            _close(T.npy(a), T.npy(b), TRAIN)

    def test_branch_flip_reexecutes_host_control_flow(self):
        def make(P, m, taken):
            def f(x, thresh):
                y = m(x) * 2.0
                if float(y.sum()) > thresh:  # break
                    taken.append(True)
                else:
                    taken.append(False)
                return y + 1.0
            return f

        taken = []
        tm = T.linear(1)
        sf = T.static(make(T, tm, taken), layers=[tm], full_graph=False)
        x = T.t(np.ones((2, 4), np.float32))
        sf(x, -1e9)  # warm-up
        with pytest.warns(UserWarning, match="piecewise"):
            out1 = sf(x, -1e9)
        out2 = sf(x, 1e9)
        _close(T.npy(out1), T.npy(out2))
        jm = J.linear(1)
        _close(T.npy(out1), J.npy(jm(J.t(np.ones((2, 4), np.float32))) * 2.0 + 1.0))
        assert taken == [True, True, False]

    def test_autograd_across_split_demotes_to_eager(self):
        def make(P, m, o):
            def step(x, y):
                logits = m(x)
                loss = P.F.cross_entropy(logits, y)
                if float(loss) > -1e30:  # break BEFORE backward
                    pass
                loss.backward()
                o.step()
                o.clear_grad()
                return loss
            return step

        xs, ys = _data(1, 4)
        got, jgot, sf, jsf, to, jo = _train_pair(make, xs, ys, popt="SGD", seed=2,
                                                 lr=0.05)
        assert sf._fallback_eager and jsf._fallback_eager
        _close(got, jgot, TRAIN)
        assert to._global_step == jo._global_step

    def test_unsafe_trial_does_not_double_step(self):
        def make(P, m, o):
            def step(x, y):
                loss = P.F.cross_entropy(m(x), y)
                loss.backward()
                o.step()
                o.clear_grad()
                stats = {"loss": float(loss)}  # dict local -> unsafe carry
                if float(loss) > -1e30:  # break
                    pass
                return stats["loss"]
            return step

        xs, ys = _data(2, 4)
        got, jgot, sf, jsf, to, jo = _train_pair(make, xs, ys, popt="SGD", seed=4,
                                                 lr=0.05)
        assert sf._fallback_eager and jsf._fallback_eager
        _close(got, jgot, TRAIN)
        assert to._global_step == jo._global_step == 4  # no double step

    def test_scheduler_step_after_break_stays_piecewise(self):
        class _Sched:
            def __init__(self):
                self.n = 0

            def step(self):
                self.n += 1

        def make(P, m, sched):
            def f(x):
                y = m(x) * 2.0
                if float(y.sum()) > -1e30:  # break; y is a CARRIED tensor
                    pass
                sched.step()
                stats = y.grad_fn if False else None  # .grad_fn must not trip
                return y + 1.0 if stats is None else y
            return f

        sched = _Sched()
        tm = T.linear(6)
        sf = T.static(make(T, tm, sched), layers=[tm], full_graph=False)
        x = T.t(np.ones((2, 4), np.float32))
        sf(x)
        with pytest.warns(UserWarning, match="piecewise"):
            out1 = sf(x)
        assert sf._piecewise is not None and not sf._fallback_eager
        assert not sf._piecewise._info["grad_hazard"]
        out2 = sf(x)
        assert sf._piecewise is not None and not sf._fallback_eager
        assert sched.n >= 1
        jm = J.linear(6)
        _close(T.npy(out1), J.npy(jm(J.t(np.ones((2, 4), np.float32))) * 2.0 + 1.0))
        _close(T.npy(out1), T.npy(out2))

    def test_optimizer_step_after_break_still_hazards(self):
        def haz(mod, src):
            return mod._autograd_hazard(ast.parse(textwrap.dedent(src)).body)

        cases = {"optimizer.step()": True, "opt.step()": True,
                 "self.optim.step()": True, "adamw.step()": True,
                 "loss.backward()": True, "g = paddle.grad(loss, xs)": True,
                 "print(p.grad)": True, "opt_2.clear_grad()": True,
                 "scheduler.step()": False, "profiler.step()": False,
                 "lr_sched.step()": False, "node = y.grad_fn": False,
                 "x = gradient_norm * 2": False}
        for src, want in cases.items():
            assert haz(td2s, src) == haz(jd2s, src) == want, src
        assert td2s._differentiates(ast.parse("loss.backward()").body)
        assert td2s._differentiates(ast.parse("g = paddle.grad(l, x)").body)
        assert not td2s._differentiates(ast.parse("opt.step()").body)

    def test_later_call_unsafe_demotes_instead_of_raising(self):
        def make(P, m):
            def f(x, flag):
                y = m(x) * 2.0
                if float(y.sum()) > flag:  # break
                    extra = None
                else:
                    extra = {"bad": 1}
                z = y + 1.0
                return z if extra is None else z + 0.0
            return f

        tm = T.linear(5)
        f = make(T, tm)
        sf = T.static(f, layers=[tm], full_graph=False)
        x = T.t(np.ones((2, 4), np.float32))
        sf(x, -1e9)
        with pytest.warns(UserWarning, match="piecewise"):
            out1 = sf(x, -1e9)
        assert sf._piecewise is not None
        with pytest.warns(UserWarning, match="became unsafe"):
            out2 = sf(x, 1e9)
        assert sf._fallback_eager and sf._piecewise is None
        _close(T.npy(out1), T.npy(f(x, -1e9)))
        _close(T.npy(out2), T.npy(f(x, 1e9)))

    def test_later_calls_take_no_snapshot(self, monkeypatch):
        """Only the split's trial copies the training state; the calls after
        it run the pieces with no copy of parameters, gradients or
        accumulators."""
        xs, ys = _data(7, 5)
        tm = T.linear(7)
        o = topt.AdamW(learning_rate=0.01, parameters=tm.parameters())
        sf = T.static(self._make(T, tm, o, []), layers=[tm], optimizers=[o],
                      full_graph=False)
        snaps = []
        take = tjit.StaticFunction._snapshot_host_state
        monkeypatch.setattr(tjit.StaticFunction, "_snapshot_host_state",
                            lambda self: snaps.append(self) or take(self))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sf(T.t(xs[0]), T.t(ys[0]))  # warm-up
            sf(T.t(xs[1]), T.t(ys[1]))  # the capture breaks; the trial
        assert sf._piecewise is not None
        n_trial = len(snaps)
        assert sf in snaps
        for x, y in zip(xs[2:], ys[2:]):
            sf(T.t(x), T.t(y))
        assert sf not in snaps[n_trial:]
        assert o._global_step == 5

    def test_later_call_grad_carry_raises(self):
        """A later call whose break binds a tensor that requires grad while
        the suffix differentiates cannot finish (the captured prefix handed
        its carry over without history): it raises, the prefix's effects
        stand, and the function runs eagerly from the next call on."""
        def make(P, m):
            def f(x, flag):
                y = m(x) * 2.0
                if float(y.sum()) > flag:  # break
                    w = None
                else:
                    w = m.weight * 1.0  # requires grad
                loss = m(x).sum() * (1.0 if w is None else w.sum()) + y.sum()
                loss.backward()
                return loss
            return f

        tm = T.linear(4)
        f = make(T, tm)
        sf = T.static(f, layers=[tm], full_graph=False)
        x = T.t(np.ones((2, 4), np.float32))
        sf(x, -1e9)
        with pytest.warns(UserWarning, match="piecewise"):
            sf(x, -1e9)
        assert sf._piecewise is not None
        assert sf._piecewise._info["differentiates"]
        with pytest.raises(RuntimeError, match="later call"):
            sf(x, 1e9)
        assert sf._fallback_eager and sf._piecewise is None
        tm.weight.grad = None
        _close(T.npy(sf(x, 1e9)), T.npy(f(x, 1e9)))

    def test_break_inside_same_file_helper_splits_at_call_site(self):
        def make(P, m):
            def helper(t):
                return float(t.sum()) > 0  # host read in the helper

            def f(x):
                y = m(x) + 1.0
                flag = helper(y)  # break at THIS call site
                z = y * 3.0
                return z, flag
            return f

        tm = T.linear(6)
        f = make(T, tm)
        sf = T.static(f, layers=[tm], full_graph=False)
        x = T.t(np.ones((2, 4), np.float32))
        sf(x)
        with pytest.warns(UserWarning, match="piecewise capture"):
            z, flag = sf(x)
        assert sf._piecewise is not None and not sf._fallback_eager
        sf(x)
        ze, fe = f(x)
        _close(T.npy(z), T.npy(ze))
        assert flag == fe
        assert sf._piecewise._prefix_sf._graphs
        assert sf._piecewise._suffix_sf._graphs

    def test_indirect_autograd_in_helper_demotes(self):
        def make(P, m, o):
            def apply_update(loss):  # autograd hidden in a helper
                loss.backward()
                o.step()
                o.clear_grad()

            def step(x, y):
                loss = P.F.cross_entropy(m(x), y)
                if float(loss) > -1e30:  # break BEFORE the update helper
                    pass
                apply_update(loss)
                return loss
            return step

        xs, ys = _data(3, 4)
        got, jgot, sf, jsf, to, jo = _train_pair(make, xs, ys, popt="SGD", seed=8,
                                                 lr=0.05)
        assert sf._fallback_eager and jsf._fallback_eager
        _close(got, jgot, TRAIN)
        assert to._global_step == jo._global_step

    def test_augassign_after_break_is_carried(self):
        def make(P, m):
            def f(x):
                y = m(x) * 2.0
                patience = 3
                if float(y.sum()) > -1e30:  # break
                    patience -= 1
                z = y + float(patience)
                return z, patience
            return f

        tm = T.linear(9)
        f = make(T, tm)
        sf = T.static(f, layers=[tm], full_graph=False)
        x = T.t(np.ones((2, 4), np.float32))
        sf(x)
        with pytest.warns(UserWarning):
            z, patience = sf(x)
        ze, pe = f(x)
        _close(T.npy(z), T.npy(ze))
        assert int(patience) == pe == 2

    def test_break_statement_sees_live_globals(self):
        mod = sys.modules[__name__]
        mod._pw_knob = 1.0
        try:
            tm = T.linear(10)

            def f(x):
                y = tm(x) * 2.0
                if float(y.sum()) > -1e30:  # break reads the knob
                    flag = float(_pw_knob)  # noqa: F821
                return y + 1.0, flag

            sf = T.static(f, layers=[tm], full_graph=False)
            x = T.t(np.ones((2, 4), np.float32))
            sf(x)
            with pytest.warns(UserWarning, match="piecewise"):
                _, flag1 = sf(x)
            assert sf._piecewise is not None
            mod._pw_knob = 100.0
            _, flag2 = sf(x)
            assert float(flag1) == 1.0 and float(flag2) == 100.0
        finally:
            del mod._pw_knob


class TestSplitAtBreak:
    @staticmethod
    def _step(x, y):
        a = x * 2.0
        b = a + y
        if float(b.sum()) > 0:
            c = b * 3.0
        else:
            c = b
        d = c - a
        return d

    def test_same_pieces_as_the_reference(self):
        """Same prefix, break and suffix statements and the same carries as
        the reference's ``split_at_break`` at each top-level statement."""
        src_lines, start = inspect.getsourcelines(self._step)
        for off in range(1, len(src_lines)):
            line = start + off
            jp, tp = (jd2s.split_at_break(self._step, line),
                      td2s.split_at_break(self._step, line))
            assert (jp is None) == (tp is None)
            if jp is None:
                continue
            ji, ti = jp[3], tp[3]
            for k in ("stmt", "line", "carry1", "carry2", "grad_hazard"):
                assert ji[k] == ti[k], (line, k)

    def test_pieces_run_like_the_function(self):
        lines, start = inspect.getsourcelines(self._step)
        line = start + next(i for i, ln in enumerate(lines) if "if float" in ln)
        pre, brk, suf, info = td2s.split_at_break(self._step, line)
        x, y = torch.tensor([1.0, -2.0]), torch.tensor([0.5, 0.5])
        out = suf(brk(pre(x, y)))
        _close(T.npy(out), T.npy(self._step(x, y)))
        assert info["carry1"] == ["a", "b"] and info["carry2"] == ["a", "c"]
