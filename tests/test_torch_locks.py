"""Port parity: the lock-order sanitizer (``utils/locks.py``) against the
JAX package's.

The runtime cases of the reference's ``tests/test_race.py`` run in both
packages: ``TracedLock``'s inversion check naming both stacks, its order
edges, held-lock and hold-time records, trylock, lock classes, the
factory patch and its undo, the seeded two-lock deadlock fixture caught at
runtime, the hang dump's per-thread held locks, and the ``thread.preempt``
chaos site. Each scenario returns plain data and both packages' must be
equal. Every test that instruments uninstruments in a ``finally`` (the
autouse fixture too): a leaked patch would reach other tests of the worker.
The port's worker processes run under ``PADDLE_LOCK_SANITIZER``.
"""
import _thread
import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from types import SimpleNamespace

import pytest

from paddle_tpu.distributed.communication import flight_recorder as jfr
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.utils import locks as jlocks
from paddle_tpu_torch.analysis import sanitizers as tsan
from paddle_tpu_torch.distributed.communication import flight_recorder as tfr
from paddle_tpu_torch.testing import chaos as tchaos
from paddle_tpu_torch.utils import locks as tlocks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": SimpleNamespace(locks=tlocks, chaos=tchaos, fr=tfr),
        "reference": SimpleNamespace(locks=jlocks, chaos=jchaos, fr=jfr)}


@pytest.fixture(autouse=True)
def _fresh_sanitizers():
    for lk in (tlocks, jlocks):
        lk.uninstrument_locks()
        lk.reset()
    yield
    for lk in (tlocks, jlocks):
        lk.uninstrument_locks()
        lk.reset()
    tchaos.uninstall()
    jchaos.uninstall()


def _both(scenario):
    got = {name: scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


class TestTracedLock:
    def test_inversion_raises_naming_both_stacks(self):
        def scen(P):
            a = P.locks.TracedLock(name="alpha_mu")
            b = P.locks.TracedLock(name="beta_mu")
            with a:
                with b:
                    pass
            with b:
                with pytest.raises(P.locks.LockOrderViolation) as ei:
                    a.acquire()
            msg = str(ei.value)
            return (msg.split("\n")[0], "established order" in msg,
                    "this thread" in msg, msg.count("test_torch_locks.py") >= 2,
                    P.locks.violation_count())

        first, established, this, stacks, n = _both(scen)
        assert "alpha_mu" in first and "beta_mu" in first
        assert established and this and stacks and n == 1

    def test_order_edges_record_first_stack(self):
        def scen(P):
            a = P.locks.TracedLock(name="first_mu")
            b = P.locks.TracedLock(name="second_mu")
            with a:
                with b:
                    pass
            edges = P.locks.lock_order_edges()
            return (sorted(edges),
                    "test_torch_locks.py" in edges[("first_mu", "second_mu")])

        assert _both(scen) == ([("first_mu", "second_mu")], True)

    def test_held_locks_and_max_hold_times(self):
        def scen(P):
            mu = P.locks.TracedLock(name="obs_mu")
            with mu:
                mine = P.locks.held_locks()[threading.current_thread().name]
                time.sleep(0.02)
            return ([(n, "test_torch_locks" in site) for n, site, _ in mine],
                    P.locks.held_locks(), P.locks.max_hold_times()["obs_mu"]
                    >= 0.02)

        assert _both(scen) == ([("obs_mu", True)], {}, True)

    def test_trylock_timeout_and_locked(self):
        def scen(P):
            mu = P.locks.TracedLock(name="try_mu")
            out = [mu.acquire(False), mu.locked()]
            got = []
            t = threading.Thread(
                target=lambda: got.append(mu.acquire(True, 0.05)))
            t.start()
            t.join(5)
            mu.release()
            return out + got + [mu.locked()]

        assert _both(scen) == [True, True, False, False]

    def test_same_class_instances_share_order_but_not_exclusion(self):
        def scen(P):
            a = P.locks.TracedLock(name="shard_mu")
            b = P.locks.TracedLock(name="shard_mu")
            with a:
                with b:
                    pass
            return sorted(P.locks.lock_order_edges()), \
                P.locks.violation_count()

        assert _both(scen) == ([], 0)

    def test_instrumentation_patches_and_restores_factories(self):
        def scen(P):
            before = threading.Lock is _thread.allocate_lock
            assert P.locks.instrument_locks() is True
            try:
                out = [isinstance(threading.Lock(), P.locks.TracedLock),
                       isinstance(threading.RLock(), P.locks.TracedLock),
                       P.locks.instrument_locks()]
            finally:
                P.locks.uninstrument_locks()
            return [before] + out + [
                threading.Lock is _thread.allocate_lock,
                threading.RLock is P.locks._REAL_RLOCK]

        assert _both(scen) == [True, True, True, False, True, True]

    def test_reentrant_rlock_and_condition_survive_instrumentation(self):
        def scen(P):
            P.locks.instrument_locks()
            try:
                r = threading.RLock()
                with r:
                    with r:
                        pass
                cv = threading.Condition()
                results = []

                def waiter():
                    with cv:
                        results.append(cv.wait(timeout=5))

                t = threading.Thread(target=waiter)
                t.start()
                t.join(0.05)
                while t.is_alive():
                    with cv:
                        cv.notify()
                    t.join(0.05)
                return results, P.locks.violation_count()
            finally:
                P.locks.uninstrument_locks()

        assert _both(scen) == ([True], 0)

    def test_analysis_reexports_the_sanitizers(self):
        from paddle_tpu_torch.utils import resources

        assert tsan.TracedLock is tlocks.TracedLock
        assert tsan.LockOrderViolation is tlocks.LockOrderViolation
        assert tsan.instrument_locks is tlocks.instrument_locks
        assert tsan.uninstrument_locks is tlocks.uninstrument_locks
        assert tsan.ResourceLedger is resources.ResourceLedger
        with pytest.raises(AttributeError):
            tsan.no_such_sanitizer  # noqa: B018


# the reference test's seeded two-lock deadlock fixture
DEADLOCK_SRC = '''
import threading
import time


class Supervisor:
    def __init__(self):
        self._state_lock = threading.Lock()
        self._sched_lock = threading.Lock()
        self.paused = False
        self.queue = []

    def pause(self):
        with self._state_lock:
            self.paused = True
            with self._sched_lock:     # state -> sched
                self.queue.clear()

    def requeue(self, item):
        with self._sched_lock:
            self.queue.append(item)
            with self._state_lock:     # sched -> state: the inversion
                self.paused = False


def worker(sup, errors):
    try:
        for i in range(3):
            sup.requeue(i)
            time.sleep(0.001)
    except Exception as e:   # noqa: BLE001 — relayed to the test
        errors.append(e)
'''


class TestSeededDeadlockProof:
    def test_runtime_catches_the_inversion_naming_both_stacks(self):
        def scen(P):
            assert P.locks.instrument_locks()
            try:
                sched = P.chaos.ChaosSchedule().every("thread.preempt", 2,
                                                      "slow", 0.002)
                with P.chaos.active(sched):
                    ns = {}
                    exec(compile(textwrap.dedent(DEADLOCK_SRC),
                                 "deadlock_fixture.py", "exec"), ns)
                    sup = ns["Supervisor"]()
                    errors = []
                    t = threading.Thread(target=ns["worker"],
                                         args=(sup, errors),
                                         name="requeue-worker")
                    t.start()
                    t.join(30)
                    alive = t.is_alive()
                    with pytest.raises(P.locks.LockOrderViolation) as ei:
                        sup.pause()
            finally:
                P.locks.uninstrument_locks()
            msg = str(ei.value)
            return (alive, errors, "in requeue" in msg, "in pause" in msg,
                    "deadlock_fixture.py" in msg, P.locks.violation_count())

        assert _both(scen) == (False, [], True, True, True, 1)

    def test_forced_hang_dump_prints_per_thread_held_locks(self):
        def scen(P):
            P.locks.instrument_locks()  # registers the dump extra
            try:
                inner = P.locks.TracedLock(name="inner_mu")
                outer = P.locks.TracedLock(name="outer_mu")
                inner.acquire()
                entered = threading.Event()

                def victim():
                    with outer:
                        entered.set()
                        with inner:
                            pass

                t = threading.Thread(target=victim, name="victim",
                                     daemon=True)
                t.start()
                assert entered.wait(5)
                text = ""
                for _ in range(250):
                    buf = io.StringIO()
                    P.fr.dump_on_watchdog(buf)
                    text = buf.getvalue()
                    if "WAITING for `inner_mu`" in text:
                        break
                    time.sleep(0.02)
                inner.release()
                t.join(5)
                return [s in text for s in (
                    "-- graft-race: per-thread held locks --",
                    "thread victim:", "holds `outer_mu` for",
                    "WAITING for `inner_mu`", "holds `inner_mu` for")] + [
                    t.is_alive()]
            finally:
                P.locks.uninstrument_locks()

        assert _both(scen) == [True] * 5 + [False]


class TestThreadPreemptChaos:
    def test_seeded_slow_stretches_the_release(self):
        def scen(P):
            lk = P.locks.TracedLock(name="preempt_mu")
            sched = P.chaos.ChaosSchedule().at("thread.preempt", 1, "slow",
                                               0.15)
            with P.chaos.active(sched) as mk:
                t0 = time.perf_counter()
                with lk:
                    pass
                dt = time.perf_counter() - t0
            return (dt >= 0.14, ("thread.preempt", 1, "slow") in mk.events,
                    lk.locked())

        assert _both(scen) == (True, True, False)

    def test_error_fault_still_releases_the_lock(self):
        def scen(P):
            lk = P.locks.TracedLock(name="chaos_err_mu")
            sched = P.chaos.ChaosSchedule().at("thread.preempt", 1, "error")
            with P.chaos.active(sched):
                with pytest.raises(RuntimeError, match="chaos"):
                    with lk:
                        pass
            return lk.locked()

        assert _both(scen) is False


class TestWorkers:
    def test_supervisor_worker_runs_clean_under_the_sanitizer(self, tmp_path):
        env = dict(os.environ, SUP_DEVICE="cpu", SUP_DIR=str(tmp_path),
                   SUP_NREQ="2", PADDLE_LOCK_SANITIZER="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.testing.supervisor_worker"],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        lines = r.stdout.strip().splitlines()
        assert lines[-1] == "lock-sanitizer: clean"
        res = json.loads(lines[-2])["results"]
        assert sorted(res) == ["r0", "r1"]
        assert all(v["status"] == "ok" for v in res.values())
