"""A mock Kubernetes API server speaking the real wire grammar.

The port's copy of ``kubegpu_tpu/cluster/mock_kube.py``, over the port's
`InMemoryAPIServer` (so its arbiter keys GPU cards). The reference tests
its node side against a fake nvidia-docker REST daemon returning canned
JSON (`nvidia_fake_plugin.go:29-39`); this is the same seam one level up:
a real HTTP server with genuine Kubernetes paths, verbs, patch
content-types, the Binding subresource and streaming ``?watch=true``
JSON-lines, backed by `InMemoryAPIServer` semantics. It exists so
`KubeAPIClient` (cluster/kubeclient.py) is tested against the grammar it
will meet in production, not against a convenience API.

Not a complete kube-apiserver: only the resources and verbs this
framework uses (annotations and bind are the wire protocol). Unlike a
real one it arbitrates cards: a bind that would book a card another
bound pod holds is refused 409.
"""

from __future__ import annotations

import copy
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubegpu_tpu_torch.cluster.apiserver import (Conflict, InMemoryAPIServer,
                                                 NotFound)

STRATEGIC_MERGE = "application/strategic-merge-patch+json"
_EVENT_TYPES = {"added": "ADDED", "modified": "MODIFIED",
                "deleted": "DELETED"}


class _VersionedLog:
    """Sequence-numbered event log; the seq doubles as resourceVersion."""

    def __init__(self, api: InMemoryAPIServer, limit: int = 10000):
        self._cond = threading.Condition()
        self._events: list = []  # (seq, kind, TYPE, obj)
        self.seq = 0
        self.limit = limit
        self.closed = False  # guarded-by: self._cond
        api.add_watcher(self._record)

    def close(self) -> None:
        """Wake every waiting watch stream so it ends (server shutdown)."""
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def _record(self, kind, event, obj):
        with self._cond:
            self.seq += 1
            obj = copy.deepcopy(obj)
            obj.setdefault("metadata", {})["resourceVersion"] = str(self.seq)
            self._events.append((self.seq, kind, _EVENT_TYPES[event], obj))
            if len(self._events) > self.limit:
                self._events = self._events[-self.limit:]
            self._cond.notify_all()

    def wait_since(self, seq: int, timeout: float = 5.0):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                out = [e for e in self._events if e[0] > seq]
                if out or self.closed or time.monotonic() >= deadline:
                    return out
                self._cond.wait(min(0.5, deadline - time.monotonic()))


def serve_mock_kube(api: InMemoryAPIServer | None = None,
                    host: str = "127.0.0.1", port: int = 0,
                    token: str | None = None, namespace: str = "default"):
    """Serve; returns (server, base_url, api). Daemon thread; stop with
    ``server.shutdown()``. ``token`` (optional) enforces Bearer auth."""
    api = api or InMemoryAPIServer()
    log = _VersionedLog(api)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        # -- plumbing -------------------------------------------------------

        def _body(self):
            n = int(self.headers.get("Content-Length") or 0)
            return json.loads(self.rfile.read(n).decode()) if n else {}

        def _send(self, code: int, obj=None):
            data = json.dumps(obj if obj is not None else {}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _authorized(self) -> bool:
            if token is None:
                return True
            return self.headers.get("Authorization") == f"Bearer {token}"

        def _parse(self):
            path, _, rawq = self.path.partition("?")
            parts = [urllib.parse.unquote(p) for p in path.split("/") if p]
            query = {k: v[0] for k, v in
                     urllib.parse.parse_qs(rawq).items()}
            return parts, query

        def _route(self, method: str):
            if not self._authorized():
                return self._send(401, {"kind": "Status", "code": 401,
                                        "message": "Unauthorized"})
            parts, query = self._parse()
            try:
                return self._dispatch(method, parts, query)
            except NotFound as e:
                self._send(404, {"kind": "Status", "code": 404,
                                 "reason": "NotFound", "message": str(e)})
            except Conflict as e:
                self._send(409, {"kind": "Status", "code": 409,
                                 "reason": "Conflict", "message": str(e)})
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                self._send(500, {"kind": "Status", "code": 500,
                                 "message": f"{type(e).__name__}: {e}"})

        # -- watch streaming ------------------------------------------------

        def _stream_watch(self, kind: str, since: int):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            seq = since
            while not log.closed:
                events = log.wait_since(seq, timeout=5.0)
                for s, k, typ, obj in events:
                    seq = max(seq, s)
                    if k != kind:
                        continue
                    frame = json.dumps(
                        {"type": typ, "object": obj}).encode() + b"\n"
                    self.wfile.write(
                        f"{len(frame):x}\r\n".encode() + frame + b"\r\n")
                    self.wfile.flush()
            # the server is shutting down: end the chunked body
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
            self.close_connection = True

        # -- dispatch -------------------------------------------------------

        def _list(self, kind_name: str, items: list):
            self._send(200, {
                "apiVersion": "v1", "kind": kind_name,
                "metadata": {"resourceVersion": str(log.seq)},
                "items": items})

        def _require_smp(self):
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype != STRATEGIC_MERGE:
                raise Conflict(f"unsupported patch content-type {ctype!r}; "
                               f"want {STRATEGIC_MERGE}")

        def _dispatch(self, method, parts, query):
            if parts[:2] != ["api", "v1"]:
                return self._send(404, {"kind": "Status", "code": 404,
                                        "message": "unknown API group"})
            rest = parts[2:]

            # /api/v1/nodes[...]
            if rest and rest[0] == "nodes":
                if len(rest) == 1:
                    if method == "GET" and query.get("watch") == "true":
                        return self._stream_watch(
                            "node", int(query.get("resourceVersion") or 0))
                    if method == "GET":
                        return self._list("NodeList", api.list_nodes())
                    if method == "POST":
                        return self._send(201, api.create_node(self._body()))
                elif len(rest) == 2:
                    name = rest[1]
                    if method == "GET":
                        return self._send(200, api.get_node(name))
                    if method == "DELETE":
                        api.delete_node(name)
                        return self._send(200, {"kind": "Status", "code": 200})
                    if method == "PATCH":
                        self._require_smp()
                        patch = self._body()
                        return self._send(200, api.patch_node_metadata(
                            name, patch.get("metadata") or {}))

            # /api/v1/namespaces/{ns}/pods[...]
            if (len(rest) >= 3 and rest[0] == "namespaces"
                    and rest[1] == namespace and rest[2] == "pods"):
                sub = rest[3:]
                if not sub:
                    if method == "GET" and query.get("watch") == "true":
                        return self._stream_watch(
                            "pod", int(query.get("resourceVersion") or 0))
                    if method == "GET":
                        node = None
                        sel = query.get("fieldSelector") or ""
                        if sel.startswith("spec.nodeName="):
                            node = sel.split("=", 1)[1]
                        return self._list("PodList", api.list_pods(node))
                    if method == "POST":
                        return self._send(201, api.create_pod(self._body()))
                elif len(sub) == 1:
                    name = sub[0]
                    if method == "GET":
                        return self._send(200, api.get_pod(name))
                    if method == "DELETE":
                        api.delete_pod(name)
                        return self._send(200, {"kind": "Status", "code": 200})
                    if method == "PATCH":
                        self._require_smp()
                        patch = self._body()
                        ann = ((patch.get("metadata") or {})
                               .get("annotations"))
                        if ann is None:
                            raise Conflict("only annotation patches modeled")
                        return self._send(
                            200, api.update_pod_annotations(name, ann))
                elif sub[1:] == ["binding"] and method == "POST":
                    binding = self._body()
                    if binding.get("kind") != "Binding":
                        raise Conflict("body must be a v1 Binding")
                    api.bind_pod(sub[0], (binding.get("target") or {})["name"])
                    return self._send(201, {"kind": "Status", "code": 201})

            # /api/v1/persistentvolumes[...] (cluster-scoped)
            if rest and rest[0] == "persistentvolumes":
                if len(rest) == 1:
                    if method == "GET" and query.get("watch") == "true":
                        return self._stream_watch(
                            "pv", int(query.get("resourceVersion") or 0))
                    if method == "GET":
                        return self._list("PersistentVolumeList",
                                          api.list_pvs())
                    if method == "POST":
                        return self._send(201, api.create_pv(self._body()))
                elif len(rest) == 2:
                    name = rest[1]
                    if method == "GET":
                        return self._send(200, api.get_pv(name))
                    if method == "DELETE":
                        api.delete_pv(name)
                        return self._send(200, {"kind": "Status", "code": 200})
                    if method == "PATCH":
                        self._require_smp()
                        return self._send(200, api.patch_pv_spec(
                            name, self._body().get("spec") or {}))

            # /api/v1/namespaces/{ns}/persistentvolumeclaims[...]
            if (len(rest) >= 3 and rest[0] == "namespaces"
                    and rest[1] == namespace
                    and rest[2] == "persistentvolumeclaims"):
                sub = rest[3:]
                if not sub:
                    if method == "GET" and query.get("watch") == "true":
                        return self._stream_watch(
                            "pvc", int(query.get("resourceVersion") or 0))
                    if method == "GET":
                        return self._list("PersistentVolumeClaimList",
                                          api.list_pvcs())
                    if method == "POST":
                        return self._send(201, api.create_pvc(self._body()))
                elif len(sub) == 1:
                    name = sub[0]
                    if method == "GET":
                        return self._send(200, api.get_pvc(name))
                    if method == "DELETE":
                        api.delete_pvc(name)
                        return self._send(200, {"kind": "Status", "code": 200})
                    if method == "PATCH":
                        self._require_smp()
                        return self._send(200, api.patch_pvc_spec(
                            name, self._body().get("spec") or {}))

            self._send(404, {"kind": "Status", "code": 404,
                             "message": f"no route {method} {self.path}"})

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

        def do_PATCH(self):
            self._route("PATCH")

        def do_DELETE(self):
            self._route("DELETE")

    class Server(ThreadingHTTPServer):
        daemon_threads = True

        def shutdown(self):
            # stopped means STOPPED: serve_forever has returned by the
            # time super().shutdown() comes back, so the listening
            # socket is released here instead of leaking until process
            # exit (same lifecycle contract as cluster/httpapi.py), and
            # every open watch stream ends
            log.close()
            super().shutdown()
            self.server_close()

    server = Server((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="mock-kube-apiserver").start()
    return server, f"http://{host}:{server.server_address[1]}", api
