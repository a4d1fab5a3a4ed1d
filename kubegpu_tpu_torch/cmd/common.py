"""Shared plumbing of the port's binaries: config files, the health,
metrics and debug endpoint, the observability flags, and the device
backends.

The port's copy of ``kubegpu_tpu/cmd/common.py``: a ``--config`` file
(JSON, or YAML where PyYAML is installed) fills in the flags not given
on the command line, and one HTTP server answers ``/healthz``, ``/metrics``
(``kubegpu_tpu_torch.metrics`` in Prometheus text), ``/metrics/history``
(the metrics time-series), ``/debug/profile`` (the sampling profiler),
``/debug/traces`` (the span ring as a Chrome trace) and
``/debug/pod/<name>`` (one pod's spans and verdict). On the node agent
the last four answer from an empty ring and stopped samplers: nothing of
the node side records a span.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubegpu_tpu_torch import metrics

# the GPU backends: NVML on the host, or one of node/fake.py's inventories
BACKENDS = ("nvml", "fake-hgx", "fake-pcie", "fake-rig")


def load_config(path: str | None) -> dict:
    if not path:
        return {}
    with open(path) as f:
        text = f.read()
    try:
        parsed = json.loads(text)
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise ValueError(f"{path} is not JSON and PyYAML is unavailable")
        parsed = yaml.safe_load(text)
    if not isinstance(parsed, dict):
        raise ValueError(f"{path}: config must be a mapping, got "
                         f"{type(parsed).__name__}")
    return parsed


def merge_flags(parser, argv, args, config: dict, keys) -> None:
    """The config file fills in each flag of ``keys`` that ``argv`` (the
    command line ``parser`` parsed into ``args``) does not give; a flag
    given on the command line wins, even at its default value."""
    # parse again with every default suppressed: only the flags given land
    saved = [(action, action.default) for action in parser._actions]
    try:
        for action, _ in saved:
            action.default = argparse.SUPPRESS
        given = set(vars(parser.parse_args(argv)))
    finally:
        for action, default in saved:
            action.default = default
    for key in keys:
        if key in config and key not in given:
            setattr(args, key, config[key])


def serve_health(port: int, extra_status=None, recorder=None):
    """Serve ``/healthz`` (200 "ok", or 500 "unhealthy" when
    ``extra_status()`` is false), ``/metrics`` and the debug routes of the
    module docstring on loopback ``port`` in a daemon thread; returns the
    server, or None when ``port <= 0``. ``recorder`` is the span ring the
    trace routes read (the process's own by default)."""
    if port is None or port <= 0:
        return None
    from urllib.parse import parse_qs, unquote, urlsplit

    from kubegpu_tpu_torch import obs

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code: int, body: bytes, ctype: str = "text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj):
            self._send(200, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            split = urlsplit(self.path)
            path = split.path
            query = {k: v[-1] for k, v in parse_qs(split.query).items()}
            if path == "/healthz":
                ok = extra_status is None or bool(extra_status())
                self._send(200 if ok else 500, b"ok" if ok else b"unhealthy")
            elif path == "/metrics":
                self._send(200, metrics.prometheus_text().encode(),
                           "text/plain; version=0.0.4")
            elif path == "/metrics/history":
                self._json(obs.metrics_history(
                    window_s=float(query.get("window_s", 300.0)),
                    limit=int(query.get("limit", 0))))
            elif path == "/debug/profile":
                self._json(obs.profile_status())
            elif path == "/debug/traces":
                self._json(obs.chrome_trace(recorder=recorder))
            elif path.startswith("/debug/pod/"):
                name = unquote(path[len("/debug/pod/"):])
                self._json(obs.explain_pod(name, recorder=recorder))
            else:
                self._send(404, b"not found")

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="health").start()
    return server


def add_observability_flags(parser) -> None:
    """The sampling profiler's and the metrics time-series' flags."""
    parser.add_argument("--profile-dir", default=None,
                        help="run the sampling profiler (a ~125 Hz stack "
                             "sampler with role, phase and lock-wait "
                             "attribution) and write its collapsed stacks "
                             "and attribution JSON here on exit; "
                             "KGTPU_PROFILE=0 disables")
    parser.add_argument("--profile-hz", type=float, default=0.0,
                        help="sampler frequency (default 125, or "
                             "$KGTPU_PROFILE_HZ)")
    parser.add_argument("--metrics-interval-s", type=float, default=0.0,
                        help="snapshot every metric into a bounded ring at "
                             "this interval (served on /metrics/history; "
                             "the anomaly watchdog runs over it); 0 "
                             "disables")


def start_observability(args):
    """Start what ``--profile-dir`` and ``--metrics-interval-s`` ask for
    (the sampler with its lock probe; the time-series with the anomaly
    watchdog). Returns an idempotent ``stop()`` that stops both and writes
    the profile."""
    from kubegpu_tpu_torch.obs import profile, timeseries

    profile_dir = getattr(args, "profile_dir", None)
    interval = getattr(args, "metrics_interval_s", 0.0) or 0.0
    sampler = series = None
    installed_probe = False
    if profile_dir and profile.enabled():
        # stop() uninstalls only a probe this call installed
        installed_probe = (not profile.lock_probe_installed()
                           and profile.install_lock_probe())
        sampler = profile.start_profiler(
            hz=getattr(args, "profile_hz", 0.0) or None)
    if interval > 0:
        series = timeseries.start_timeseries(
            interval, watchdog=timeseries.Watchdog())
    state = {"done": False}

    def stop():
        if state["done"]:
            return
        state["done"] = True
        if sampler is not None:
            profile.stop_and_dump(profile_dir)
        if installed_probe:
            profile.uninstall_lock_probe()
        if series is not None:
            timeseries.stop_timeseries()

    return stop


def build_backend(kind: str):
    """The device backend behind ``--backend``. ``nvml`` reads the host's
    cards through ``libnvidia-ml``; it never stands in a fake when the
    library is missing (discovery then raises)."""
    if kind == "nvml":
        from kubegpu_tpu_torch.node.nvml import NVMLBackend

        return NVMLBackend()
    from kubegpu_tpu_torch.node import fake

    inventories = {"fake-hgx": fake.hgx_h100_inventory,
                   "fake-pcie": fake.pcie_h100_inventory,
                   "fake-rig": fake.rig_inventory}
    if kind not in inventories:
        raise ValueError(f"unknown backend {kind!r}")
    return fake.FakeGPUBackend(inventories[kind]())
