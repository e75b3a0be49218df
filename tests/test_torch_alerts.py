"""Port parity: the alert engine (``obs/alerts.py``) and the regression
sentinel (``obs/regress.py``) against the JAX package's.

The cases of the reference's ``tests/test_alerts.py`` run in both
packages on the same samples with explicit evaluation clocks, and the
results must be equal as plain data: alert states, annotations, events,
journals, ``summary()``, regression verdicts, and the health envelopes'
alert summaries. The end-to-end case serves a tiny two-replica fleet in
each package (the reference's weights carried into the port) under a
burn rule whose target, an exact bucket bound below any TTFT, makes every
request count against the budget, so the lifecycle does not depend on
timing.
"""
import json
import os
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import obs as jobs
from paddle_tpu.distributed import store as jstore
from paddle_tpu.inference import cluster as jcl
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.obs import agg as jagg
from paddle_tpu.obs import alerts as jal
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import regress as jrg
from paddle_tpu.obs import slo as jslo
from paddle_tpu.obs import trace as jtrace
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import seed as pt_seed
from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.inference import cluster as tcl
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.obs import agg as tagg
from paddle_tpu_torch.obs import alerts as tal
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import regress as trg
from paddle_tpu_torch.obs import slo as tslo
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.utils import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "port": SimpleNamespace(al=tal, rg=trg, obs=tobs, agg=tagg, m=tmetrics,
                            slo=tslo, store=tstore, trace=ttrace, cl=tcl),
    "reference": SimpleNamespace(al=jal, rg=jrg, obs=jobs, agg=jagg,
                                 m=jmetrics, slo=jslo, store=jstore,
                                 trace=jtrace, cl=jcl),
}


def _both(scenario):
    got = {name: scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _mgr(P, rules=(), **kw):
    kw.setdefault("emit_trace", False)
    kw.setdefault("emit_metrics", False)
    return P.al.AlertManager(rules, **kw)


def _view(m):
    """Everything a manager shows, as plain data."""
    return {"statuses": m.statuses(), "events": list(m.events),
            "summary": m.summary()}


# ---------------------------------------------------------------------------
# error-budget arithmetic


class TestBudgetMath:
    def test_burn_rate_and_budget_hand_computed(self):
        cases = [(5, 100, 0.99), (0, 100, 0.99), (3, 0, 0.99), (1, 10, 1.0),
                 (0, 10, 1.0), (1, 100, 0.99), (2, 100, 0.99), (0, 0, 0.99)]
        out = _both(lambda P: [(P.al.burn_rate(*c),
                                P.al.budget_remaining_frac(*c))
                               for c in cases])
        assert out[0][0] == pytest.approx(5.0)
        assert out[3][0] == float("inf")
        assert out[6][1] == pytest.approx(-1.0)
        assert out[7] == (0.0, 1.0)

    def test_count_over_exact_at_bucket_bounds(self):
        def scen(P):
            h = P.m.Histogram()
            for v in (0.5, 0.5, 1.0, 2.0, 4.0):
                h.observe(v)
            return [h.count_over(t) for t in (0.5, 1.0, 4.0, -1.0)]

        assert _both(scen) == [3, 2, 0, 5]

    def test_windowed_burn_hand_computed(self):
        def scen(P):
            reg = P.m.MetricsRegistry()
            h = reg.histogram("serving_ttft_seconds", {"tenant": "t0"})
            for v in [0.25] * 8 + [4.0] * 2:
                h.observe(v)
            m = _mgr(P, [P.al.BurnRateRule(
                "burn", "serving_ttft_seconds", objective=0.9,
                threshold_s=1.0, windows=((5.0, 1.0),))])
            m.evaluate(registry=reg, now=0.0)
            first = _view(m)
            for v in [0.25] * 5 + [4.0] * 5:
                h.observe(v)
            m.evaluate(registry=reg, now=10.0)
            return first, _view(m)

        first, second = _both(scen)
        assert first["statuses"][0]["state"] == "inactive"
        st = second["statuses"][0]
        assert st["state"] == "firing"
        assert st["annotations"]["burn"] == {"5s": pytest.approx(5.0)}
        assert st["annotations"]["bad_total"] == 7
        assert st["annotations"]["budget_remaining_frac"] == pytest.approx(
            1.0 - (7 / 20) / 0.1, abs=1e-6)

    def test_multi_window_needs_every_window_hot(self):
        def scen(P):
            reg = P.m.MetricsRegistry()
            h = reg.histogram("serving_ttft_seconds", {"tenant": "t0"})
            m = _mgr(P, [P.al.BurnRateRule(
                "burn", "serving_ttft_seconds", objective=0.9,
                threshold_s=1.0, windows=((30.0, 1.0), (5.0, 1.0)))])
            m.evaluate(registry=reg, now=0.0)
            for _ in range(10):
                h.observe(4.0)
            out = []
            for now in (10.0, 20.0):
                m.evaluate(registry=reg, now=now)
                out.append(_view(m))
            return out

        fire, quiet = _both(scen)
        assert fire["statuses"][0]["state"] == "firing"
        ann = quiet["statuses"][0]["annotations"]
        assert ann["burn"]["30s"] > 1.0 and ann["burn"]["5s"] == 0.0
        assert quiet["statuses"][0]["value"] == 0.0

    def test_per_tenant_targets_resolve_from_slo_spec(self):
        def scen(P):
            spec = P.slo.SLOSpec(
                default=P.slo.SLOClass(ttft_s=2.0),
                per_tenant={"gold": P.slo.SLOClass(ttft_s=0.5)})
            rules = P.al.burn_rules_from_slo(spec, objective=0.9,
                                             windows=((5.0, 1.0),))
            rule = {r.metric: r for r in rules}["serving_ttft_seconds"]
            reg = P.m.MetricsRegistry()
            hists = [reg.histogram("serving_ttft_seconds", {"tenant": t})
                     for t in ("gold", "bronze")]
            m = _mgr(P, [rule])
            m.evaluate(registry=reg, now=0.0)
            for h in hists:
                for _ in range(10):
                    h.observe(1.0)
            m.evaluate(registry=reg, now=10.0)
            return ([r.to_dict() for r in rules], rule.target_for("gold"),
                    rule.target_for("other"), _view(m))

        rules, gold, other, view = _both(scen)
        assert (gold, other) == (0.5, 2.0)
        by_tenant = {s["labels"]["tenant"]: s["state"]
                     for s in view["statuses"]}
        assert by_tenant == {"gold": "firing", "bronze": "inactive"}


# ---------------------------------------------------------------------------
# lifecycle determinism


def _queue_rule(P, threshold=0.95, **kw):
    kw.setdefault("stat", "value")
    return P.al.ThresholdRule("queue_saturated", "serving_queue_frac",
                              threshold, **kw)


def _gauge_run(P, rule_kw, ticks, **mgr_kw):
    """A manager over one queue-fraction gauge, fed ``(now, value)``
    ticks; the views after every tick."""
    reg = P.m.MetricsRegistry()
    g = reg.gauge("serving_queue_frac", {"engine": "e0"})
    m = _mgr(P, [_queue_rule(P, **rule_kw)], **mgr_kw)
    views = []
    for now, v in ticks:
        if v is not None:
            g.set(v)
        m.evaluate(registry=reg, now=now)
        views.append(_view(m))
    return views


class TestLifecycle:
    def test_pending_firing_resolved_explicit_clock(self):
        views = _both(lambda P: _gauge_run(
            P, dict(for_s=2.0, resolve_for_s=2.0),
            [(0.0, 0.99), (3.0, None), (4.0, 0.5), (6.5, None)]))
        assert [v["statuses"][0]["state"] for v in views] == \
            ["pending", "firing", "firing", "resolved"]
        assert views[0]["events"] == []
        assert [e["event"] for e in views[-1]["events"]] == \
            ["firing", "resolved"]

    def test_pending_flap_returns_to_inactive_without_event(self):
        views = _both(lambda P: _gauge_run(
            P, dict(for_s=5.0), [(0.0, 0.99), (1.0, 0.1)]))
        assert [v["statuses"][0]["state"] for v in views] == \
            ["pending", "inactive"]
        assert views[-1]["events"] == []

    def test_resolve_threshold_widens_the_clear_band(self):
        views = _both(lambda P: _gauge_run(
            P, dict(resolve_threshold=0.8, resolve_for_s=1.0),
            [(0.0, 0.99), (5.0, 0.9), (10.0, None), (11.0, 0.5),
             (12.5, None)]))
        assert [v["statuses"][0]["state"] for v in views] == \
            ["firing", "firing", "firing", "firing", "resolved"]

    def test_refire_after_resolve(self):
        views = _both(lambda P: _gauge_run(
            P, {}, [(0.0, 0.99), (1.0, 0.1), (2.0, 0.99)]))
        assert [e["event"] for e in views[-1]["events"]] == \
            ["firing", "resolved", "firing"]

    def test_seeded_flapping_journals_byte_identical(self, tmp_path):
        rnd = random.Random(0)
        values = [rnd.random() for _ in range(60)]

        def scen(P):
            path = tmp_path / f"{P.al.__name__}.jsonl"
            views = _gauge_run(
                P, dict(threshold=0.5, for_s=2.0, resolve_for_s=2.0),
                [(float(i), v) for i, v in enumerate(values)],
                journal_path=str(path))
            return views[-1], path.read_bytes()

        view, journal = _both(scen)
        assert len(view["events"]) > 0
        assert all(json.loads(line)["schema"] == jal.ALERT_SCHEMA
                   for line in journal.decode().splitlines())

    def test_clock_never_runs_backwards(self):
        views = _both(lambda P: _gauge_run(
            P, dict(for_s=2.0), [(10.0, 0.99), (5.0, None), (12.0, None)]))
        assert [v["statuses"][0]["state"] for v in views] == \
            ["pending", "pending", "firing"]

    def test_emission_counts_and_instants(self):
        # firing/resolved emit into the package's own registry and ring
        def scen(P):
            P.obs.registry().reset()
            P.trace.ring().clear()
            _gauge_run(P, {}, [(0.0, 0.99), (1.0, 0.1)],
                       emit_trace=True, emit_metrics=True)
            names = [e.get("name") for e in P.trace.ring().dump()]
            return (P.obs.registry().total("obs_alerts_fired_total"),
                    P.obs.registry().total("obs_alerts_resolved_total"),
                    [n for n in names if str(n).startswith("alert_")])

        assert _both(scen) == (1.0, 1.0, ["alert_firing", "alert_resolved"])


# ---------------------------------------------------------------------------
# absence: a silent publisher is an alert


class TestAbsence:
    def _run(self, P, ticks):
        m = _mgr(P, [P.al.AbsenceRule("replica_silent", max_age_s=5.0)])
        for now, ages in ticks:
            m.evaluate(registry=P.m.MetricsRegistry(), now=now, ages=ages)
        return _view(m)

    def test_stale_source_fires_and_fresh_source_does_not(self):
        v = _both(lambda P: self._run(
            P, [(0.0, {"rep-0": 0.2, "rep-1": 9.0})]))
        assert {s["labels"]["source"]: s["state"] for s in v["statuses"]} \
            == {"rep-0": "inactive", "rep-1": "firing"}

    def test_vanished_source_keeps_alerting(self):
        v = _both(lambda P: self._run(
            P, [(0.0, {"rep-0": 0.1, "rep-1": 0.1}),
                (10.0, {"rep-0": 0.1})]))
        by_src = {s["labels"]["source"]: s for s in v["statuses"]}
        assert by_src["rep-1"]["state"] == "firing"
        assert by_src["rep-1"]["annotations"] == {"vanished": True}

    def test_without_ages_absence_is_skipped_not_cleared(self):
        v = _both(lambda P: self._run(P, [(0.0, {"rep-0": 9.0}),
                                          (20.0, None)]))
        assert v["statuses"][0]["state"] == "firing"

    def test_fleet_path_grades_published_unix(self):
        # one store, written by the port: both packages' managers read it
        store = tstore.MemKVStore()
        reg = tmetrics.MetricsRegistry()
        tagg.publish(store, "rep-0", registry=reg)
        state = reg.dump_state()
        state["source"] = "rep-1"
        state["published_unix"] = time.time() - 60.0
        store.put_bytes("obs/rep-1/metrics",
                        json.dumps(state, sort_keys=True).encode())

        def scen(P):
            m = _mgr(P, [P.al.AbsenceRule("replica_silent", max_age_s=5.0)])
            m.evaluate_fleet(store, now=100.0)
            return {s["labels"]["source"]: s["state"]
                    for s in m.statuses()}

        assert _both(scen) == {"rep-0": "inactive", "rep-1": "firing"}


# ---------------------------------------------------------------------------
# the regression sentinel


def _ledger(P, path, values, metric="bench_tokens_per_sec", **fields):
    for v in values:
        P.rg.bench_record("synthetic", metric, v, "tok/s",
                          ledger_path=str(path), emit=False, **fields)
    return str(path)


def _verdicts(P, paths):
    return P.rg.detect_regressions(P.rg.load_ledger(paths))


class TestRegress:
    BASE = [1000.0 + random.Random(7).uniform(-15, 15) for _ in range(10)]

    def _cases(self, P, tmp_path):
        tag = P.rg.__name__.split(".")[0]
        out = {}
        for name, values, metric in (
                ("regression", self.BASE + [700.0], "bench_tokens_per_sec"),
                ("noise", self.BASE + [self.BASE[0] * 0.99],
                 "bench_tokens_per_sec"),
                ("latency_up", [0.100, 0.101, 0.099, 0.100, 0.300],
                 "recovery_ram_tier_s"),
                ("latency_down", [0.100, 0.101, 0.099, 0.100, 0.030],
                 "recovery_ram_tier_s"),
                ("short", [1000.0, 400.0], "bench_tokens_per_sec")):
            path = _ledger(P, tmp_path / f"{tag}-{name}.jsonl", values,
                           metric)
            out[name] = _verdicts(P, [path])
        cfg = str(tmp_path / f"{tag}-cfg.jsonl")
        for v in (1000.0, 1001.0, 999.0, 1000.0):
            P.rg.bench_record("b", "tps", v, "", ledger_path=cfg,
                              emit=False, config={"batch": 8})
        P.rg.bench_record("b", "tps", 500.0, "", ledger_path=cfg,
                          emit=False, config={"batch": 32})
        out["config"] = _verdicts(P, [cfg])
        for v in out.values():
            for d in v:
                d.pop("host")  # the same machine: equal, but not data
        return out

    def test_verdicts_equal_on_synthetic_ledgers(self, tmp_path):
        out = _both(lambda P: self._cases(P, tmp_path))
        assert [v["verdict"] for v in out["regression"]] == ["regression"]
        assert [v["verdict"] for v in out["noise"]] == ["ok"]
        assert [v["verdict"] for v in out["latency_up"]] == ["regression"]
        assert out["latency_up"][0]["polarity"] == "down"
        assert [v["verdict"] for v in out["latency_down"]] == \
            ["improvement"]
        assert [v["verdict"] for v in out["short"]] == ["insufficient_data"]
        assert sorted(v["verdict"] for v in out["config"]) == \
            ["insufficient_data", "ok"]

    def test_each_package_reads_the_others_ledger(self, tmp_path):
        paths = {name: _ledger(P, tmp_path / f"{name}.jsonl",
                               self.BASE + [700.0])
                 for name, P in PKGS.items()}
        got = [_verdicts(P, [paths[other]])
               for (name, P), other in zip(PKGS.items(),
                                           ("reference", "port"))]
        assert [v["verdict"] for v in got[0]] == ["regression"]
        assert [v["candidate"] for v in got[0]] == \
            [v["candidate"] for v in got[1]]

    def test_verdicts_equal_on_the_repos_bench_rounds(self):
        paths = sorted(os.path.join(REPO, f) for f in os.listdir(REPO)
                       if f.startswith("BENCH_r0") and f.endswith(".json"))
        assert paths

        def scen(P):
            recs = P.rg.load_ledger(paths)
            return (recs, P.rg.detect_regressions(recs),
                    P.rg.format_verdicts(P.rg.detect_regressions(recs)))

        recs, verdicts, text = _both(scen)
        assert all("metric" in r and "bench" in r for r in recs)
        assert not any(v["verdict"] == "regression" for v in verdicts)

    def test_polarity_and_trimmed_statistics(self):
        names = ["llama_train_tokens_per_sec_per_chip",
                 "trainfault_recovery_ram_tier_s", "tokens_per_sec_window_s",
                 "loadgen_goodput_under_slo", "decode_itl_p99", "mystery"]
        xs = [5.0, 1.0, 9.0, 2.0, 100.0, 3.0, 4.0]

        def scen(P):
            return ([P.rg.polarity_of(n) for n in names],
                    P.rg.polarity_of("tokens_per_sec", {"polarity": "down"}),
                    P.rg.trimmed_mean(xs), P.rg.mad(xs))

        pol, override, tm, md = _both(scen)
        assert pol[:3] == ["up", "down", "up"] and override == "down"

    def test_bench_record_stdout_and_ledger_contract(self, tmp_path, capsys):
        def scen(P):
            path = str(tmp_path / f"{P.rg.__name__}.jsonl")
            P.rg.bench_record("b", "m", 1.5, "s", ledger_path=path,
                              extra={"rows": 3})
            line = json.loads(capsys.readouterr().out.strip())
            P.rg.bench_record("b", "m", 2.5, "s", ledger_path=path,
                              emit=False, line_prefix="BENCH_ROW ")
            for k in ("host", "recorded_unix"):
                line.pop(k)
            return line, [(r["value"], r["schema"])
                          for r in P.rg.load_ledger([path])]

        line, loaded = _both(scen)
        assert line["metric"] == "m" and line["extra"] == {"rows": 3}
        assert loaded == [(1.5, jrg.BENCH_SCHEMA), (2.5, jrg.BENCH_SCHEMA)]


# ---------------------------------------------------------------------------
# health surfaces


class TestHealthSurfaces:
    def test_envelope_reports_empty_summary_without_manager(self):
        def scen(P):
            old = P.al.set_default_manager(None)
            try:
                return P.obs.health_envelope("kindx", {})["alerts"]
            finally:
                P.al.set_default_manager(old)

        assert _both(scen) == {"rules": 0, "pending": 0, "firing": 0,
                               "resolved": 0, "active": []}

    def test_envelope_carries_the_default_managers_firing(self):
        def scen(P):
            reg = P.m.MetricsRegistry()
            reg.gauge("serving_queue_frac", {"engine": "e0"}).set(0.99)
            m = _mgr(P, [_queue_rule(P)])
            m.evaluate(registry=reg, now=time.time())
            old = P.al.set_default_manager(m)
            try:
                h = P.obs.health_envelope("kindx", {"legacy": 1})
                return h["legacy"], h["alerts"]
            finally:
                P.al.set_default_manager(old)

        legacy, alerts = _both(scen)
        assert legacy == 1 and alerts["firing"] == 1
        assert alerts["active"][0]["rule"] == "queue_saturated"

    def test_stock_rule_sets_equal(self):
        def scen(P):
            spec = P.slo.SLOSpec(default=P.slo.SLOClass(ttft_s=2.0,
                                                        itl_p95_s=0.2))
            return ([r.to_dict() for r in P.al.default_serving_rules(
                        slo=spec)],
                    [r.to_dict() for r in P.al.default_training_rules()])

        serving, training = _both(scen)
        assert sorted(d["kind"] for d in serving) == \
            ["absence", "burn_rate", "burn_rate", "threshold"]
        assert len(training) == 3


# ---------------------------------------------------------------------------
# the end-to-end proof: a burn alert through its lifecycle over a fleet


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    pt_seed(0)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    tm.eval()
    return {"port": (tm, ContinuousBatchingEngine),
            "reference": (jm, JEngine)}


class TestE2EFleet:
    def test_burn_alert_full_lifecycle_over_a_fleet(self, tmp_path, models):
        # 2**-10 s is an exact bucket bound below any TTFT either package
        # reaches, so every request is bad and the windows' counts are
        # the requests served, whatever the host's speed
        def scen(P):
            model, Engine = models["port" if P.al is tal else "reference"]
            P.obs.registry().reset()
            P.trace.ring().clear()

            def factory():
                return Engine(model, max_batch=4, max_len=48, block_size=8,
                              num_blocks=28, prompt_pad=24)

            router = P.cl.ClusterRouter(
                [P.cl.InProcessReplica(f"rep{i}", factory) for i in range(2)],
                block_size=8)
            rng = np.random.RandomState(3)
            results = {}

            def drive(n, tag):
                for i in range(n):
                    router.submit(f"{tag}{i}",
                                  rng.randint(0, 50, (8,)).astype(np.int32),
                                  max_new_tokens=3, tenant="t0")
                results.update(router.run(deadline=120.0))

            journal = tmp_path / f"{P.al.__name__}.jsonl"
            mgr = P.al.AlertManager(
                [P.al.BurnRateRule(
                    "slo_burn_serving_ttft_seconds", "serving_ttft_seconds",
                    objective=0.9, threshold_s=2.0 ** -10,
                    windows=((30.0, 1.0), (5.0, 1.0)), for_s=5.0,
                    resolve_for_s=5.0)],
                journal_path=str(journal))
            old = P.al.set_default_manager(mgr)
            views = []
            try:
                drive(2, "clean")
                mgr.evaluate(now=1000.0)  # the baseline sample
                views.append(_view(mgr))
                drive(3, "burn_a")
                mgr.evaluate(now=1010.0)
                views.append(_view(mgr))
                drive(3, "burn_b")
                mgr.evaluate(now=1020.0)
                views.append(_view(mgr))
                health = router.health()["alerts"]
                store = P.store.MemKVStore()
                P.agg.publish(store, "rep-0")
                fired_series = "obs_alerts_fired_total" in \
                    P.agg.fleet_snapshot(store)["metrics"]
                for now in (1040.0, 1050.0):
                    mgr.evaluate(now=now)
                    views.append(_view(mgr))
                names = [e.get("name") for e in P.trace.ring().dump()]
            finally:
                P.al.set_default_manager(old)
                router.stop(deadline=30.0)
            return ({k: (v["status"], v["out"]) for k, v in results.items()},
                    views, health, fired_series,
                    [n for n in names if str(n).startswith("alert_")],
                    journal.read_bytes())

        results, views, health, fired_series, instants, journal = _both(scen)
        assert all(st == "ok" for st, _ in results.values())
        states = [{s["labels"]["tenant"]: s["state"] for s in v["statuses"]
                   if s["labels"]["tenant"] == "t0"} for v in views]
        # 1000: the baseline (its own reference); 1010: burning (pending,
        # for_s 5); 1020: firing; 1040: clearing (hold); 1050: resolved
        assert [st["t0"] for st in states] == \
            ["inactive", "pending", "firing", "firing", "resolved"]
        assert health["firing"] == 1
        assert health["active"][0]["rule"] == "slo_burn_serving_ttft_seconds"
        assert fired_series
        assert instants == ["alert_firing", "alert_resolved"]
        assert [json.loads(s)["event"] for s in
                journal.decode().splitlines()] == ["firing", "resolved"]
