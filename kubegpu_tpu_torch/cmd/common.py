"""Shared plumbing of the GPU node binaries: config files, the health and
metrics endpoint, and the device backends.

The port's copy of ``kubegpu_tpu/cmd/common.py``'s node-side half: a
``--config`` file (JSON, or YAML where PyYAML is installed) fills in the
flags left at their defaults, and one HTTP server answers ``/healthz``
and ``/metrics`` (the serving and control-plane wire metrics of
``kubegpu_tpu_torch.metrics`` in Prometheus text). The JAX package's ``/metrics/history`` and ``/debug/*``
endpoints serve its control plane's observability package and are not
part of the port.
"""

from __future__ import annotations

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


def merge_flags(args, config: dict, keys: list) -> None:
    """The config file fills in any flag left unset (None or ""); flags
    given on the command line win."""
    for key in keys:
        if key in config and getattr(args, key, None) in (None, ""):
            setattr(args, key, config[key])


def serve_health(port: int, extra_status=None):
    """Serve ``/healthz`` (200 "ok", or 500 "unhealthy" when
    ``extra_status()`` is false) and ``/metrics`` on loopback ``port`` in
    a daemon thread; returns the server, or None when ``port <= 0``."""
    if port is None or port <= 0:
        return None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code: int, body: bytes, ctype: str = "text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                ok = extra_status is None or bool(extra_status())
                self._send(200 if ok else 500, b"ok" if ok else b"unhealthy")
            elif self.path == "/metrics":
                self._send(200, metrics.prometheus_text().encode(),
                           "text/plain; version=0.0.4")
            else:
                self._send(404, b"not found")

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="health").start()
    return server


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
