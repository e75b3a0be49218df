"""Port parity: the ``obs`` CLI (``python -m paddle_tpu_torch.obs``), the
capture events (``obs/compile.py``, the counterpart of the reference's XLA
compile events) and ``utils/log.py``.

Each CLI subcommand runs in both packages over the same files and the same
fleet store, whose sources carry publication stamps set explicitly, an
hour either side of the absence threshold (never a few seconds of wall
time): exit codes and output must be equal, the ``top`` frame's header and
age column aside. One subprocess per package proves the ``-m`` entry point.
"""
import json
import logging
import os
import random
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu.base import flags as jflags
from paddle_tpu.obs import __main__ as jmain
from paddle_tpu.obs import regress as jrg
from paddle_tpu.utils import log as jlog
from paddle_tpu_torch import jit, obs
from paddle_tpu_torch.base import flags as tflags
from paddle_tpu_torch.distributed.store import FileKVStore
from paddle_tpu_torch.obs import __main__ as tmain
from paddle_tpu_torch.obs import compile as tcompile
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.utils import log as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"port": tmain, "reference": jmain}
HOUR = 3600.0


def _run(main, argv, capsys):
    rc = main.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, normalize=None):
    got = {}
    for name, main in MAINS.items():
        rc, out, err = _run(main, argv, capsys)
        if normalize is not None:
            out = normalize(out)
        got[name] = (rc, out, err)
    assert got["port"] == got["reference"]
    return got["port"]


def _fleet(root, stale: bool):
    """A FileKVStore fleet: ``rep-0`` published just now, and with
    ``stale`` a ``rep-1`` whose last publication is two hours old; the
    registry holds counters and a per-tenant TTFT histogram."""
    store = FileKVStore(str(root))
    reg = MetricsRegistry()
    reg.counter("serving_requests_total", {"engine": "e0"}).inc(7)
    h = reg.histogram("serving_ttft_seconds", {"engine": "e0",
                                               "tenant": "t0"})
    for v in (0.125, 0.25, 0.5, 1.0):
        h.observe(v)
    now = time.time()
    for sid, pub in (("rep-0", now), ("rep-1", now - 2 * HOUR)):
        if sid == "rep-1" and not stale:
            continue
        state = reg.dump_state()
        state["source"] = sid
        state["published_unix"] = pub
        store.put_bytes(f"obs/{sid}/metrics",
                        json.dumps(state, sort_keys=True).encode())
        store.put_bytes(f"obs/{sid}/trace", b"[]")
    return str(root)


def _ages_out(text):
    """An alerts document with what wall time decides masked: each
    source's age and the evaluation's stamps."""
    doc = json.loads(text)
    for d in doc:
        if d["rule"] == "replica_silent" and d["value"] not in (None, -1.0):
            d["value"] = "AGE"
        for k in ("pending_since", "fired_at", "resolved_at"):
            if d[k] is not None:
                d[k] = "NOW"
    return json.dumps(doc, indent=2, sort_keys=True)


class TestAlertsAndTop:
    def test_alerts_rc0_on_healthy_fleet_rc1_on_silent(self, tmp_path,
                                                       capsys):
        argv = ["--absence-age", str(HOUR), "--state"]
        rc, out, _ = _both(["alerts", _fleet(tmp_path / "a", False), *argv],
                           capsys, _ages_out)
        assert rc == 0
        assert [d["state"] for d in json.loads(out)] == ["inactive"]
        rc, out, _ = _both(["alerts", _fleet(tmp_path / "b", True), *argv],
                           capsys, _ages_out)
        assert rc == 1
        firing = [d for d in json.loads(out) if d["state"] == "firing"]
        assert [(d["rule"], d["labels"]) for d in firing] == \
            [("replica_silent", {"source": "rep-1"})]

    def test_alerts_burn_rule_over_the_fleet(self, tmp_path, capsys):
        # one evaluation: the burn windows' first sample is its own
        # reference, so the rule is graded (annotated) but cannot breach
        rc, out, _ = _both(["alerts", _fleet(tmp_path / "f", False),
                            "--ttft-slo", "0.3", "--absence-age", str(HOUR),
                            "--state"], capsys, _ages_out)
        assert rc == 0
        burn = [d for d in json.loads(out)
                if d["rule"] == "slo_burn_serving_ttft_seconds"]
        assert burn and burn[0]["annotations"]["bad_total"] == 2

    def test_alerts_rules_lists_the_rule_set(self, capsys):
        rc, out, _ = _both(["alerts", "--rules", "--ttft-slo", "2.0",
                            "unused"], capsys)
        assert rc == 0
        assert sorted(d["kind"] for d in json.loads(out)) == \
            ["absence", "burn_rate", "threshold"]

    def test_top_once_renders_the_same_frame(self, tmp_path, capsys):
        def normalize(text):
            lines = text.splitlines()[1:]  # the header names the package
            return "\n".join(re.sub(r"^(rep-\d)\s+[0-9.]+$", r"\1 AGE", ln)
                             for ln in lines)

        rc, out, _ = _both(["top", _fleet(tmp_path / "t", True), "--once",
                            "--ttft-slo", "0.3"], capsys, normalize)
        assert rc == 0
        for want in ("rep-0 AGE", "rep-1 AGE", "FLEET TOTALS", "TENANT",
                     "ALERTS (1 active)", "replica_silent"):
            assert want in out
        rc, out, _ = _run(tmain, ["top", str(tmp_path / "t"), "--once"],
                          capsys)
        assert "paddle_tpu_torch.obs top" in out.splitlines()[0]


def _ledger(path, values, metric="bench_tokens_per_sec"):
    for v in values:
        jrg.bench_record("synthetic", metric, v, "tok/s",
                         ledger_path=str(path), emit=False)
    return str(path)


class TestRegressCLI:
    BASE = [1000.0 + random.Random(7).uniform(-15, 15) for _ in range(10)]

    def test_regress_flags_synthetic_regression(self, tmp_path, capsys):
        path = _ledger(tmp_path / "led.jsonl", self.BASE + [700.0])
        rc, out, err = _both(["regress", "--ledger", path], capsys)
        assert rc == 1 and "REGRESSION" in out
        assert "regression(s) detected" in err
        rc, out, _ = _both(["regress", "--ledger", path, "--json"], capsys)
        assert rc == 1
        assert [v["verdict"] for v in json.loads(out)] == ["regression"]

    def test_regress_quiet_on_stable_ledger(self, tmp_path, capsys):
        path = _ledger(tmp_path / "led.jsonl", self.BASE + [self.BASE[-1]])
        assert _both(["regress", "--ledger", path], capsys)[0] == 0

    def test_regress_quiet_on_the_repos_bench_rounds(self, capsys):
        paths = sorted(os.path.join(REPO, f) for f in os.listdir(REPO)
                       if f.startswith("BENCH_r0") and f.endswith(".json"))
        rc, out, _ = _both(["regress", "--ledger", *paths, "--window", "4"],
                           capsys)
        assert rc == 0 and out


class TestDumpPromTraceAgg:
    def test_file_forms_render_equal(self, tmp_path, capsys):
        reg = MetricsRegistry()
        reg.counter("c_total", {"k": "a"}).inc(3)
        reg.gauge("g").set(1.5)
        h = reg.histogram("h_seconds")
        for v in (0.1, 0.2, 0.4):
            h.observe(v)
        snap = tmp_path / "snap.jsonl"
        reg.snapshot_jsonl(str(snap))
        reg.counter("c_total", {"k": "a"}).inc(1)
        reg.snapshot_jsonl(str(snap))  # the CLI renders the last line
        rc, out, _ = _both(["dump", str(snap)], capsys)
        assert rc == 0
        assert json.loads(out)["metrics"]["c_total"]["series"][0]["value"] \
            == 4.0
        rc, out, _ = _both(["prom", str(snap)], capsys)
        assert rc == 0 and 'c_total{k="a"} 4.0' in out

    def test_trace_stitch_and_agg_render_equal(self, tmp_path, capsys):
        ring = ttrace.TraceRing(64)
        tid = ttrace.new_trace_id()
        dumps = []
        for i in range(2):
            ring.clear()
            ring.record({"name": f"s{i}", "ph": "X", "ts": 10.0 * i,
                      "dur": 5.0, "pid": i, "tid": "t",
                      "args": {"trace_id": tid}})
            path = tmp_path / f"ring{i}.json"
            path.write_text(json.dumps(ring.dump()))
            dumps.append(str(path))
        rc, out, _ = _both(["trace", "--stitch", *dumps], capsys)
        assert rc == 0 and len(json.loads(out)["traceEvents"]) >= 2
        root = _fleet(tmp_path / "agg", True)
        rc, out, _ = _both(["agg", root, "--summary"], capsys)
        assert rc == 0
        assert json.loads(out)["totals"]["serving_requests_total"] == 14.0

    def test_module_entry_points(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        got = {}
        for pkg in ("paddle_tpu_torch", "paddle_tpu"):
            r = subprocess.run(
                [sys.executable, "-m", f"{pkg}.obs", "alerts", "--rules",
                 "--ttft-slo", "2.0", "unused"], env=env, cwd=REPO,
                capture_output=True, text=True, timeout=180)
            got[pkg] = (r.returncode, r.stdout)
        assert got["paddle_tpu_torch"] == got["paddle_tpu"]
        assert got["paddle_tpu"][0] == 0


# ---------------------------------------------------------------------------
# capture events


@pytest.fixture
def fresh_obs():
    tcompile.uninstall_compile_events()
    obs.registry().reset()
    ttrace.ring().clear()
    yield
    tcompile.uninstall_compile_events()


class TestCaptureEvents:
    def test_install_and_uninstall_are_idempotent(self, fresh_obs):
        assert not obs.compile_events_installed()
        obs.install_compile_events()
        obs.install_compile_events()
        assert obs.compile_events_installed()
        assert jit._capture_listeners.count(tcompile.on_capture) == 1
        obs.uninstall_compile_events()
        obs.uninstall_compile_events()
        assert not obs.compile_events_installed()
        assert tcompile.on_capture not in jit._capture_listeners

    def test_a_capture_counts_and_emits_instants(self, fresh_obs):
        obs.install_compile_events()
        jit._notify_capture("eng9:_decode_program", 0.25)
        jit._notify_capture("eng9:_decode_program", 0.5)
        jit._notify_capture("eng9:_prefill_program", 0.125)
        reg = obs.registry()
        assert reg.value("graph_captures_total",
                         {"program": "eng9:_decode_program"}) == 2.0
        assert reg.total("graph_captures_total") == 3.0
        h = reg._metrics["graph_capture_seconds"].series[
            (("program", "eng9:_decode_program"),)]
        assert h.count == 2 and h.sum == 0.75
        names = [(e["name"], e.get("tid")) for e in ttrace.ring().dump()]
        assert names.count(("graph_capture", "compile")) == 3
        assert names.count(("graph_capture_done", "compile")) == 3
        obs.uninstall_compile_events()
        jit._notify_capture("eng9:_decode_program", 1.0)
        assert reg.total("graph_captures_total") == 3.0

    def test_programs_are_named_after_their_engine(self, fresh_obs):
        import torch

        from paddle_tpu_torch.inference.serving import \
            ContinuousBatchingEngine
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

        obs.install_compile_events()
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        eng = ContinuousBatchingEngine(model, max_batch=2, max_len=32,
                                       block_size=8, num_blocks=8,
                                       prompt_pad=8)
        assert [f.name for f in (eng._prefill_fn, eng._decode_fn,
                                 eng._chunk_fn, eng._verify_fn)] == [
            f"{eng._obs_id}:_{k}_program"
            for k in ("prefill", "decode", "chunk", "verify")]
        eng.add_request("a", np.arange(5), max_new_tokens=3)
        eng.run()
        # CPU tensors run eagerly: nothing is captured, nothing counted
        assert obs.registry().total("graph_captures_total") == 0.0
        sf = jit.to_static(lambda x: x * 2)
        assert sf.name.endswith("<lambda>")
        assert torch.equal(sf(torch.ones(2)), torch.full((2,), 2.0))


# ---------------------------------------------------------------------------
# utils.log


class _ListHandler(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append((record.levelname, record.getMessage()))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_vlog_gates_on_the_log_level_flag_like_reference(level):
    got = {}
    for name, log, flags in (("port", tlog, tflags),
                             ("reference", jlog, jflags)):
        lg = log.get_logger()
        assert log.get_logger() is lg  # cached
        h = _ListHandler()
        lg.addHandler(h)
        old = flags.flag("log_level")
        flags.set_flags({"log_level": level})
        try:
            log.vlog(1, "one %d", 1)
            log.vlog(2, "two")
            log.warning("warn %s", "w")
            log.error("err")
        finally:
            flags.set_flags({"log_level": old})
            lg.removeHandler(h)
        got[name] = h.records
    assert got["port"] == got["reference"]
    assert len(got["port"]) == 2 + (level >= 1) + (level >= 2)
    assert tlog.get_logger().name == "paddle_tpu_torch"
