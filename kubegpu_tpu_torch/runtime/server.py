"""The long-running CRI interception endpoint of the GPU node agent.

The port's copy of ``kubegpu_tpu/runtime/server.py`` (reference:
`crishim/pkg/kubecri/docker_container.go:115-191`, a persistent CRI server
the runtime calls on every CreateContainer). The node agent serves a
local HTTP endpoint, a unix socket or loopback TCP, and the container
runtime, or the thin ``kgtpu-gpu-cri-hook`` client in its OCI hook
configuration, posts the container config and uses the rewritten one:

    POST /v1/create-container
    {"pod": "name", "container": "main", "config": {...CRI JSON...}}
    -> 200 {"config": {...rewritten...}}
    -> 409 on the hook's AllocationMismatch (the annotation allocates
       fewer cards than the pod asks for: refuse to start,
       `docker_container.go:58-60`)
    -> 404 when the API server does not know the pod

With a `WorkloadSupervisor` attached the server also creates and starts
the container (`docker_container.go:95-99`):

    POST /v1/launch-container   {pod, container, config, command: [...]}
    -> 200 {"config": ..., "id", "pid"}     (rewrite + spawn, supervised)
    GET  /v1/container-status?id=...        -> the container record
    GET  /v1/containers                     -> all records
    POST /v1/stop-container     {"id": ...} -> SIGTERM/SIGKILL, record
    POST /v1/remove-container   {"id": ...} -> evict an exited record
    GET  /v1/container-logs?id=...[&tail=N] -> {"logs": "..."}
    GET  /healthz                           -> {"ok": true, "served": N}

The server shares the agent's device manager, so discovery runs once per
process, not once per container.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubegpu_tpu_torch.cluster.httpapi import NotFound
from kubegpu_tpu_torch.runtime.hook import AllocationMismatch


class _UnixHTTPServer(ThreadingHTTPServer):
    address_family = socket.AF_UNIX
    daemon_threads = True

    def server_bind(self):
        # A stale socket file from a crashed agent must not block startup —
        # but a LIVE socket (another agent serving) must: probe-connect
        # before unlinking so a second agent fails loudly instead of
        # silently stealing the endpoint.
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.settimeout(0.5)
            probe.connect(self.server_address)
            raise OSError(
                f"socket {self.server_address} is live (another agent?)")
        except (ConnectionRefusedError, FileNotFoundError):
            pass  # stale or absent: safe to (re)bind
        finally:
            probe.close()
        try:
            os.unlink(self.server_address)
        except FileNotFoundError:
            pass
        super().server_bind()

    def client_address_string(self):  # pragma: no cover - logging only
        return "local"


class CRIHookServer:
    """Serve a runtime hook's ``create_container`` (the port's
    `GPURuntimeHook`) over a local endpoint, and with a supervisor the
    launch and lifecycle endpoints."""

    def __init__(self, hook, unix_socket: str | None = None,
                 port: int | None = None, host: str = "127.0.0.1",
                 supervisor=None):
        if (unix_socket is None) == (port is None):
            raise ValueError("exactly one of unix_socket / port required")
        self.hook = hook
        self.supervisor = supervisor
        self.unix_socket = unix_socket
        self.requests_served = 0
        self._count_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: dict):
                blob = json.dumps(body, sort_keys=True).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def _supervisor(self):
                """The attached supervisor, or reply 501 and return None."""
                if outer.supervisor is None:
                    self._reply(501, {"error": "no supervisor attached"})
                return outer.supervisor

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True,
                                      "served": outer.requests_served})
                elif self.path == "/v1/containers":
                    sup = self._supervisor()
                    if sup is not None:
                        self._reply(200, {"containers": sup.list()})
                elif self.path.startswith("/v1/container-status"):
                    sup = self._supervisor()
                    if sup is None:
                        return
                    from urllib.parse import parse_qs, urlparse

                    cid = (parse_qs(urlparse(self.path).query).get("id")
                           or [""])[0]
                    try:
                        self._reply(200, sup.status(cid))
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                elif self.path.startswith("/v1/container-logs"):
                    sup = self._supervisor()
                    if sup is None:
                        return
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    cid = (q.get("id") or [""])[0]
                    try:
                        tail = int((q.get("tail") or ["0"])[0])
                        self._reply(200, {"id": cid,
                                          "logs": sup.logs(cid, tail)})
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                    except ValueError as e:
                        self._reply(400, {"error": str(e)})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    req = json.loads(self.rfile.read(length) or b"{}")
                except Exception as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                if self.path == "/v1/create-container":
                    self._create(req, launch=False)
                elif self.path == "/v1/launch-container":
                    self._create(req, launch=True)
                elif self.path == "/v1/stop-container":
                    sup = self._supervisor()
                    if sup is None:
                        return
                    try:
                        self._reply(200, sup.stop(req.get("id") or ""))
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                elif self.path == "/v1/remove-container":
                    sup = self._supervisor()
                    if sup is None:
                        return
                    try:
                        sup.remove(req.get("id") or "")
                        self._reply(200, {"removed": req.get("id")})
                    except KeyError as e:
                        self._reply(404, {"error": str(e)})
                    except RuntimeError as e:
                        self._reply(409, {"error": str(e)})
                else:
                    self._reply(404, {"error": "not found"})

            def _create(self, req: dict, launch: bool):
                if launch and self._supervisor() is None:
                    return
                try:
                    cfg = outer.hook.create_container(
                        req.get("pod") or "", req.get("container") or "",
                        req.get("config") or {})
                except AllocationMismatch as e:
                    self._reply(409, {"error": str(e)})
                    return
                except NotFound as e:
                    self._reply(404, {"error": f"pod not found: {e}"})
                    return
                except Exception as e:  # config must never crash the agent
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                body = {"config": cfg}
                if launch:
                    try:
                        cont = outer.supervisor.launch(
                            req.get("pod") or "", req.get("container") or "",
                            cfg, req.get("command") or [])
                    except Exception as e:
                        # malformed command/envs must yield a JSON error,
                        # not a dropped connection
                        self._reply(400, {"error": f"launch failed: "
                                          f"{type(e).__name__}: {e}"})
                        return
                    body.update({"id": cont.cid, "pid": cont.proc.pid})
                with outer._count_lock:
                    outer.requests_served += 1
                self._reply(200, body)

        if unix_socket is not None:
            self._server = _UnixHTTPServer(unix_socket, Handler)
        else:
            self._server = ThreadingHTTPServer((host, port), Handler)
            self._server.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int | None:
        if self.unix_socket is not None:
            return None
        return self._server.server_address[1]

    def start(self) -> None:
        # racer: single-writer -- start()/stop() are owner-thread calls
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="cri-hook")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self.unix_socket is not None:
            try:
                os.unlink(self.unix_socket)
            except OSError:
                pass


def request_create_container(endpoint: str, pod: str, container: str,
                             config: dict, timeout: float = 30.0) -> dict:
    """Thin client of ``kgtpu-gpu-cri-hook``: POST a container config to a
    running node agent; a 409 raises `AllocationMismatch`. ``endpoint`` is ``http://host:port`` or
    ``unix:///path/to.sock``."""
    from http import client as http_client

    body = json.dumps({"pod": pod, "container": container,
                       "config": config}).encode()
    if endpoint.startswith("unix://"):
        path = endpoint[len("unix://"):]

        class UnixConn(http_client.HTTPConnection):
            def connect(self):
                self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                self.sock.settimeout(timeout)
                self.sock.connect(path)

        conn = UnixConn("localhost", timeout=timeout)
    else:
        from urllib.parse import urlparse

        u = urlparse(endpoint)
        conn = http_client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        conn.request("POST", "/v1/create-container", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = json.loads(resp.read() or b"{}")
    finally:
        conn.close()
    if resp.status == 409:
        raise AllocationMismatch(f"create-container refused (409): "
                                 f"{payload.get('error')}")
    if resp.status != 200:
        raise RuntimeError(
            f"create-container failed ({resp.status}): {payload.get('error')}")
    return payload["config"]
