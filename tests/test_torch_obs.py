"""The port's observability (`kubegpu_tpu_torch/obs/`) against the JAX
package's: the trace-file check agrees with JAX's on good and corrupted
files, the flight recorder dumps once per anomaly key, the profiler names
threads whether or not it samples, the metrics time-series windows and the
watchdog's rules equal JAX's on the same snapshots, and the binaries'
health server (`cmd/common.serve_health`) serves the debug routes."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import pytest

pytest.importorskip("torch")

from kubegpu_tpu import metrics as jax_metrics  # noqa: E402
from kubegpu_tpu.obs import profile as jax_profile  # noqa: E402
from kubegpu_tpu.obs import timeseries as jax_timeseries  # noqa: E402
from kubegpu_tpu.obs import validate as jax_validate  # noqa: E402
from kubegpu_tpu_torch import metrics, obs  # noqa: E402
from kubegpu_tpu_torch.cmd import common  # noqa: E402
from kubegpu_tpu_torch.obs import flight, profile, timeseries, trace  # noqa: E402
from kubegpu_tpu_torch.obs import validate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traced(proc: str = "scheduler") -> trace.SpanRecorder:
    """A ring holding one pod's scheduling cycle as the engine records it:
    a cycle span, its filter child and a bind committed under it."""
    rec = trace.SpanRecorder(proc=proc)
    with trace.span("schedule_cycle", pod="p0", recorder=rec):
        with trace.span("filter", pod="p0", recorder=rec):
            pass
        trace.event("assume", pod="p0", recorder=rec, node="host0")
    trace.record_span("bind_commit", trace.wall_now(), 0.001, pod="p0",
                      recorder=rec, outcome="committed", node="host0")
    return rec


def _corrupt(doc: dict, how: str) -> dict:
    doc = json.loads(json.dumps(doc))
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    if how == "orphan":
        parent = next(e for e in spans if e["name"] == "schedule_cycle")
        doc["traceEvents"].remove(parent)
    elif how == "early-child":
        child = next(e for e in spans if e["name"] == "filter")
        child["ts"] -= 1e6
    elif how == "duplicate-id":
        doc["traceEvents"].append(dict(spans[0]))
    elif how == "no-spans":
        doc["traceEvents"] = [e for e in doc["traceEvents"]
                              if e.get("ph") != "X"]
    elif how == "not-a-trace":
        doc = {"events": []}
    return doc


@pytest.mark.parametrize("how", ["good", "orphan", "early-child",
                                 "duplicate-id", "no-spans", "not-a-trace"])
def test_the_trace_check_agrees_with_jax(tmp_path, how, capsys):
    doc = trace.chrome_trace(recorder=_traced())
    if how != "good":
        doc = _corrupt(doc, how)
    problems = validate.validate_chrome_trace(doc)
    assert problems == jax_validate.validate_chrome_trace(doc)
    assert (problems == []) == (how == "good")
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    rc = validate.main([str(path)])
    ours = capsys.readouterr().out
    assert rc == jax_validate.main([str(path)])
    assert ours == capsys.readouterr().out
    assert rc == (0 if how == "good" else 1)


def test_the_trace_check_runs_as_a_module(tmp_path):
    path = tmp_path / "trace.json"
    assert trace.write_trace(str(path), recorder=_traced()) == 4
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for target, want in ((path, 0), (bad, 1)):
        r = subprocess.run([sys.executable, "-m",
                            "kubegpu_tpu_torch.obs.validate", str(target)],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=60)
        assert r.returncode == want, r.stdout + r.stderr
    assert "ok (4 spans" in subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.obs.validate", str(path)],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=60).stdout


def test_the_flight_recorder_dumps_once_per_key(tmp_path):
    rec = _traced()
    fr = flight.FlightRecorder(recorder=rec)
    assert fr.trigger("conflict_streak", key="p0", pod="p0") is None
    fr.configure(str(tmp_path))
    before = metrics.FLIGHT_DUMPS.value
    path = fr.trigger("conflict_streak", key="p0", pod="p0", streak=4)
    assert fr.trigger("conflict_streak", key="p0", pod="p0", streak=5) is None
    other = fr.trigger("internal_error", key="p0", pod="p0", error="x")
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (path, other))
    assert metrics.FLIGHT_DUMPS.value == before + 2 and fr.dumps == 2
    doc = json.loads(open(path).read())
    assert doc["kind"] == "conflict_streak" and doc["detail"] == {"streak": 4}
    assert doc["explain"]["pod"] == "p0"
    assert validate.validate_chrome_trace(doc["trace"]) == []


def test_register_thread_names_a_thread_with_the_profiler_off():
    assert profile.active_profiler() is None
    seen = {}

    def run():
        obs.register_thread("binder")
        seen["role"] = profile._classify(threading.get_ident(), "x")

    t = threading.Thread(target=run, name="anything")
    t.start()
    t.join()
    assert seen["role"] == "binder"
    assert profile._classify(-1, "api-watch") == "informer"
    assert profile._classify(-1, "elector-kgtpu-scheduler") == "elector"
    assert profile.profile_status()["active"] is False


def test_the_sampler_attributes_like_jax():
    sampler = profile.Sampler(hz=200.0).start()
    stop = threading.Event()

    def busy():
        obs.register_thread("fit-pool")
        while not stop.is_set():
            sum(range(200))

    t = threading.Thread(target=busy, name="fit_0")
    t.start()
    try:
        before = metrics.PROFILE_SAMPLES.value
        deadline = threading.Event()
        while sampler.attribution()["ticks"] < 10:
            deadline.wait(0.02)
        assert metrics.PROFILE_SAMPLES.value > before
    finally:
        stop.set()
        t.join()
        att = sampler.stop()
    ref = jax_profile.Sampler(hz=200.0).stop()
    assert set(att) == set(ref)
    assert set(att["sched_cpu_share"]) == set(ref["sched_cpu_share"])
    assert att["roles"]["fit-pool"]["samples"] > 0
    assert "fit-pool" in sampler.collapsed()


def _snaps(module, values: list) -> list:
    """Synthetic snapshots of ``module``'s metric types: a queue gauge, a
    conflict counter and a phase histogram family moving as ``values``
    says."""
    out = []
    hist = module.LabeledHistogram("sched_phase_ms", "phase", start_us=0.01)
    conflicts = module.Counter("sched_conflicts_total")
    depth = module.LabeledGauge("sched_queue_depth", "queue")
    for i, (q, c, lat) in enumerate(values):
        depth.labels("scheduler").set(q)
        conflicts.inc(c)
        for v in lat:
            hist.labels("filter").observe(v)
        out.append({"t": 1000.0 + i, "mono": float(i), "metrics": {
            m.name: m.snapshot() for m in (hist, conflicts, depth)}})
    return out


@pytest.mark.parametrize("shape", ["quiet", "queue_growth", "conflicts",
                                   "p95"])
def test_the_watchdog_rules_equal_jax_on_the_same_snapshots(shape):
    n = 14
    if shape == "quiet":
        values = [(1, 0, [0.5] * 40) for _ in range(n)]
    elif shape == "queue_growth":
        values = [(10 + 3 * i, 0, []) for i in range(n)]
    elif shape == "conflicts":
        values = [(0, 3, []) for _ in range(n)]
    else:
        values = [(0, 0, [0.3] * 40) for _ in range(8)] + \
                 [(0, 0, [9.0] * 40) for _ in range(6)]
    ours = _snaps(metrics, values)
    assert ours == _snaps(jax_metrics, values)
    found = timeseries.Watchdog().check(ours)
    assert found == jax_timeseries.Watchdog().check(ours)
    assert (found == []) == (shape == "quiet")
    series = timeseries.MetricsTimeSeries()
    series._ring.extend(ours)
    ref = jax_timeseries.MetricsTimeSeries()
    ref._ring.extend(ours)
    assert series.window(1e9) == ref.window(1e9)


def test_snapshots_cover_every_metric_under_the_jax_names():
    snap = timeseries.snapshot_metrics()
    assert set(snap) == {m.name for m in metrics.all_metrics()}
    jax_names = {m.name: m.snapshot()["type"]
                 for m in jax_metrics.all_metrics()}
    # the port's own: launches of a kernel the JAX package does not have
    port_only = {"decode_attn_kernel_calls_total": "counter"}
    for name, entry in snap.items():
        assert {**jax_names, **port_only}[name] == entry["type"], name
    assert not set(port_only) & set(jax_names)
    for name in ("watch_batch_size", "watch_coalesced_total",
                 "watch_push_lag_ms", "lease_transitions_total", "flight_dumps_total",
                 "profile_samples_total"):
        assert name in snap


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        body = r.read()
        return r.status, (json.loads(body) if r.headers.get_content_type()
                          == "application/json" else body.decode())


def test_serve_health_serves_the_debug_routes(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rec = _traced()
    series = timeseries.start_timeseries(0.05)
    server = common.serve_health(port, extra_status=lambda: True,
                                 recorder=rec)
    try:
        assert _get(port, "/healthz") == (200, "ok")
        status, text = _get(port, "/metrics")
        assert status == 200 and "# TYPE lease_transitions_total counter" \
            in text
        _, doc = _get(port, "/debug/traces")
        assert validate.validate_chrome_trace(doc) == []
        _, pod = _get(port, "/debug/pod/p0")
        assert pod["pod"] == "p0" and pod["state"] == "bound"
        assert pod["node"] == "host0"
        assert [s["name"] for s in pod["spans"]][:1] == ["schedule_cycle"]
        _, prof = _get(port, "/debug/profile")
        assert prof["active"] is False
        while len(series.snapshots()) < 2:
            threading.Event().wait(0.02)
        _, hist = _get(port, "/metrics/history?window_s=60&limit=1")
        assert hist["active"] and len(hist["series"]) == 1
        assert "counters" in hist["window"]
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/debug/nothing")
    finally:
        server.shutdown()
        server.server_close()
        timeseries.stop_timeseries()
