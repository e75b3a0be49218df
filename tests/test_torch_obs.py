"""Port parity: observability — the metrics registry, histograms,
``MetricAttr`` and the trace ring — and the serving engine's counters, SLO
histograms and per-request span trees, against the JAX package's ``obs``.

Span and trace ids are random, so span trees are compared by name, parent
name, track and kind; counters that measure time are left out.
"""
import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import obs as jobs
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import LlamaConfig as JConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.utils import load_jax_params

# counters and gauges that measure wall time differ between the packages
TIMED = {"serving_host_blocked_seconds_total", "serving_busy_seconds_total",
         "serving_host_blocked_frac", "serving_ewma_step_seconds",
         "serving_est_queue_delay_s"}
# the reference's disaggregation counters (its ``role=``, a later slice)
DISAGG = {"serving_kv_imported_total", "serving_kv_handed_off_total"}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JLlama(JConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_params(tm, {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()})
    return jm, tm


@pytest.fixture(autouse=True)
def _tracing_on():
    for o in (tobs, jobs):
        o.set_enabled(True)
        o.ring().clear()
    yield
    for o in (tobs, jobs):
        o.set_enabled(True)


@pytest.mark.parametrize("values", [
    (0.001, 0.01, 0.1, 1.0, 10.0) * 20,
    (0.0, -1.0, 0.5, 3e-7, 2e5, 0.25, 0.25),
    (),
], ids=["decades", "edges", "empty"])
def test_histogram_matches_reference(values):
    th, jh = tmetrics.Histogram(), jmetrics.Histogram()
    for v in values:
        th.observe(v)
        jh.observe(v)
    assert th.to_dict() == jh.to_dict()
    assert th.bounds_counts() == jh.bounds_counts()
    for p in (1, 50, 90, 99, 100):
        assert th.percentile(p) == jh.percentile(p)
    assert th.count_over(0.3) == jh.count_over(0.3)
    assert th.state_dict() == jh.state_dict()
    m = tmetrics.Histogram.from_state(jh.state_dict())
    m.merge(th)
    r = jmetrics.Histogram.from_state(jh.state_dict())
    r.merge(jh)
    assert m.to_dict() == r.to_dict()


def _exercise(reg):
    handles = [reg.counter("t_cap_total", {"k": str(i)}) for i in range(8)]
    for i, h in enumerate(handles):
        h.inc(2.0 + i)
    reg.counter("t_req_total", {"engine": "e1", "z": "1"},
                help="requests").inc(5)
    reg.gauge("t_unset").set(None)
    reg.gauge("t_g", {"a": "x"}).set(1.5)
    reg.gauge("t_g", {"a": "x"}).inc(0.5)
    h = reg.histogram("t_lat_seconds", {"tenant": "a"})
    for v in (0.1, 0.2, 5.0):
        h.observe(v)
    with pytest.raises(ValueError, match="counter"):
        reg.gauge("t_req_total")
    return [h.value for h in handles]


def test_registry_snapshot_and_exposition_match_reference():
    treg = tmetrics.MetricsRegistry(max_series=4)
    jreg = jmetrics.MetricsRegistry(max_series=4)
    assert _exercise(treg) == _exercise(jreg)
    for fn in (lambda r: json.dumps(r.snapshot(), sort_keys=True),
               lambda r: json.dumps(r.dump_state(), sort_keys=True),
               lambda r: r.expose_text(), lambda r: r.names(),
               lambda r: r.series_count("t_cap_total"),
               lambda r: r.total("t_cap_total"),
               lambda r: r.value("t_g", {"a": "x"})):
        assert fn(treg) == fn(jreg)
    assert tmetrics.labels_of({"b": 1, "a": "2"}) == jmetrics.labels_of(
        {"b": 1, "a": "2"})


def test_metric_attr_matches_reference():
    def make(m):
        class Stats:
            hits = m.MetricAttr("t_attr_hits_total", as_int=True)
            lat = m.MetricAttr("t_attr_lat", kind="gauge")

            def __init__(self, name):
                self._obs_labels = {"obj": name}

        return Stats

    vals = []
    for m in (tmetrics, jmetrics):
        s = make(m)("o1")
        s.hits += 3
        s.hits += 1
        a = (s.hits, type(s.hits), s.lat)
        s.lat = 0.25
        b = s.lat
        s.lat = None
        vals.append((a, b, s.lat, m.registry().value(
            "t_attr_hits_total", {"obj": "o1"})))
    assert vals[0] == vals[1]
    with pytest.raises(ValueError, match="counter|gauge"):
        tmetrics.MetricAttr("x", kind="summary")


def _engines(models, **kw):
    """One engine of each package over fresh registries. The registries are
    process-global and cap each metric at 512 series; engines of earlier
    tests in the same worker process fill them, and a new engine's series
    past the cap are not exported — in one package and not the other, as
    the two packages' earlier engines differ in number."""
    jm, tm = models
    for m in (tmetrics, jmetrics):
        m.registry().reset()
    args = dict(max_batch=2, max_len=32, block_size=8, num_blocks=8,
                prompt_pad=16)
    args.update(kw)
    return JEngine(jm, **args), ContinuousBatchingEngine(tm, **args)


def _series(reg, labels):
    """The engine's registry series: {(name, other labels): value}; the
    SLO histograms by count."""
    out = {}
    for name, m in reg._metrics.items():
        if name in TIMED or name in DISAGG:
            continue
        for lab, h in m.series.items():
            d = dict(lab)
            if d.get("engine") != labels["engine"]:
                continue
            d.pop("engine")
            key = (name, tuple(sorted(d.items())))
            out[key] = h.count if m.kind == "histogram" else h.value
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(prefill_chunk=4, max_num_batched_tokens=6, overlap=True),
    dict(decode_chunk=3, spec_decode_k=2),
], ids=["sync", "chunked_overlap", "chunk_spec"])
def test_engine_registry_series_match_reference(models, kw):
    j, t = _engines(models, **kw)
    rng = np.random.RandomState(1)
    for eng in (j, t):
        for i in range(3):
            p = np.tile(rng.randint(0, 250, (3,)), 3) if i == 2 else \
                np.random.RandomState(i).randint(0, 250, (5 + i,))
            eng.add_request(f"p{i}", p, 6, tenant="ab"[i % 2])
        eng.run()
        eng.load()  # refreshes the load gauges
    js = _series(jmetrics.registry(), j._obs_labels)
    ts = _series(tmetrics.registry(), t._obs_labels)
    # a dirty-row upload is one byte shorter in the port: the row index
    # rides no upload and ``finished`` is packed as int32
    for name in ("serving_h2d_bytes_total", "serving_h2d_decode_bytes_total"):
        ts[(name, ())] += t._rows_flushed
    assert ts == js
    assert isinstance(t.decode_tokens, int) and isinstance(t.steps, int)
    assert t.n_shed == {"interactive": 0, "batch": 0}
    t.ewma_step_s = None  # outside writes reach the registry
    assert tmetrics.registry().value("serving_ewma_step_seconds",
                                     t._obs_labels) is None
    s = tobs.slo_summary()
    assert s["serving_ttft_seconds"]["count"] >= 3
    assert set(s) == set(jobs.slo_summary()) - {"tenants"}


def _trees(o, rids):
    """Per request: the sorted (name, parent name, track, kind) of every
    span of its trace."""
    events = [e for e in o.ring().dump() if e.get("ph") == "X"]
    out = {}
    for rid in rids:
        adm = [e for e in events if e["name"] == "admission"
               and e["args"].get("req") == str(rid)]
        assert len(adm) == 1, (rid, len(adm))
        tid = adm[0]["trace_id"]
        mine = [e for e in events if e["trace_id"] == tid]
        names = {e["span_id"]: e["name"] for e in mine}
        assert all(not e.get("parent_id") or e["parent_id"] in names
                   for e in mine)  # no orphans
        out[rid] = sorted(
            (e["name"], names.get(e.get("parent_id")), e["tid"],
             str(e["args"].get("kind")), str(e["args"].get("verdict")))
            for e in mine)
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(overlap=True),
    dict(prefill_chunk=4, max_num_batched_tokens=6),
    dict(spec_decode_k=2, overlap=True),
], ids=["sync", "overlap", "chunked", "spec_overlap"])
def test_span_trees_match_reference(models, kw):
    """Each request's trace: an admission root, its prefill and decode
    spans under it, and the dispatch spans of the rounds it led, each
    with its harvest — the same tree as the reference's."""
    j, t = _engines(models, **kw)
    rng = np.random.RandomState(2)
    prompts = [np.tile(rng.randint(0, 250, (3,)), 3) if i % 2 else
               rng.randint(0, 250, (4 + i,)) for i in range(4)]
    for eng in (j, t):
        for i, p in enumerate(prompts):
            eng.add_request(i, p, 5, trace={"trace_id": f"{i:016x}"}
                            if i == 3 else None)
        eng.run()
    jt, tt = _trees(jobs, range(4)), _trees(tobs, range(4))
    assert tt == jt
    names = {n for tree in tt.values() for n, *_ in tree}
    assert {"admission", "prefill", "decode", "dispatch", "harvest"} <= names
    # an upstream context is adopted: the request joins that trace
    assert any(e["trace_id"] == f"{3:016x}" for e in tobs.ring().dump())


def test_tracing_off_records_nothing_and_keeps_ids(models):
    _, tm = models
    tobs.set_enabled(False)
    eng = ContinuousBatchingEngine(tm, max_batch=2, max_len=32, block_size=8,
                                   num_blocks=8, prompt_pad=8, overlap=True)
    r = eng.add_request("x", np.arange(5), 4)
    eng.run()
    assert len(tobs.ring()) == 0 and r.trace_id and len(r.out) == 4


def test_chrome_trace_export_shape_matches_reference(models, tmp_path):
    j, t = _engines(models)
    docs = []
    for eng, o in ((j, jobs), (t, tobs)):
        eng.add_request("c", np.arange(6), 3)
        eng.run()
        o.instant("marker", trace_id=eng._completed["c"].trace_id)
        events = o.stitch_traces([o.ring().dump()],
                                 trace_id=eng._completed["c"].trace_id)
        path = str(tmp_path / f"{len(docs)}.json")
        o.export_chrome_trace(events, path=path)
        with open(path, encoding="utf-8") as fh:
            docs.append(json.load(fh))
    shape = [(set(d), d["displayTimeUnit"],
              sorted((e["ph"], e["name"], tuple(sorted(e)))
                     for e in d["traceEvents"] if e["ph"] != "M"))
             for d in docs]
    assert shape[0] == shape[1]
