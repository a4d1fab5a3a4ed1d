"""Kubernetes API client: the same surface as the port's
`InMemoryAPIServer` and `HTTPAPIClient`, spoken against a **real**
Kubernetes API server.

The port's copy of ``kubegpu_tpu/cluster/kubeclient.py``. The reference's
components talk to the cluster through client-go:
`kubeinterface.PatchNodeMetadata` issues a strategic-merge patch on the
Node (`kubeinterface/kubeinterface.go:145-158`), `UpdatePodMetadata`
updates pod annotations before binding (`:160-193`), and the scheduler
binds through the pods/binding subresource (`kube-scheduler/pkg/
scheduler.go:405-417`). This module is that adapter for the GPU build,
stdlib only (urllib, http.client, ssl): the port's scheduler, advertiser
and runtime hook each take an ``api`` object, so putting them on a real
cluster is constructing ``KubeAPIClient(KubeConfig.load(...))``.

Wire grammar (the real one):

- nodes:      ``/api/v1/nodes[/{name}]``
- pods:       ``/api/v1/namespaces/{ns}/pods[/{name}]``
- bind:       ``POST .../pods/{name}/binding`` with a v1 Binding
- annotations: ``PATCH`` with ``application/strategic-merge-patch+json``
- watches:    ``?watch=true&resourceVersion=N`` chunked JSON-lines

Auth: bearer token or client-cert kubeconfig contexts, plus in-cluster
(serviceaccount token + CA). A kubeconfig that is JSON (valid YAML) is
read with ``json``; other YAML needs PyYAML. The tests drive this against
``cluster/mock_kube.py``, a mock API server speaking the same grammar.

Kubernetes has no atomic multi-bind, so ``bind_many`` here is two stages
(annotate every pod, then bind every pod) and declares it:
``atomic_bind_many = False``. The engine then treats its single-pod bind
as a stamped write and withdraws the stamp when the bind is refused
(``Scheduler._bind_write``).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

from kubegpu_tpu_torch import obs
from kubegpu_tpu_torch.cluster.apiserver import Conflict, NotFound

log = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
STRATEGIC_MERGE = "application/strategic-merge-patch+json"


@dataclass
class KubeConfig:
    """Connection settings for one cluster/user pair."""

    server: str
    token: str | None = None
    ca_file: str | None = None
    client_cert: str | None = None
    client_key: str | None = None
    insecure: bool = False
    namespace: str = "default"
    extra_headers: dict = field(default_factory=dict)

    @classmethod
    def load(cls, path: str | None = None, context: str | None = None):
        """Load from a kubeconfig file (``path`` or $KUBECONFIG or
        ~/.kube/config), or fall back to in-cluster settings."""
        path = path or os.environ.get("KUBECONFIG") or \
            os.path.expanduser("~/.kube/config")
        if os.path.exists(path):
            return cls.from_kubeconfig(path, context)
        return cls.in_cluster()

    @classmethod
    def from_kubeconfig(cls, path: str, context: str | None = None):
        with open(path) as f:
            text = f.read()
        doc = _parse_kubeconfig(text, path)

        def by_name(items, name):
            for it in items or []:
                if it.get("name") == name:
                    return it.get(next(k for k in it if k != "name"), {})
            raise ValueError(f"kubeconfig: no entry named {name!r}")

        ctx_name = context or doc.get("current-context")
        ctx = by_name(doc.get("contexts"), ctx_name)
        cluster = by_name(doc.get("clusters"), ctx["cluster"])
        user = by_name(doc.get("users"), ctx["user"]) \
            if ctx.get("user") else {}
        return cls(
            server=cluster["server"].rstrip("/"),
            token=user.get("token"),
            ca_file=cluster.get("certificate-authority"),
            client_cert=user.get("client-certificate"),
            client_key=user.get("client-key"),
            insecure=bool(cluster.get("insecure-skip-tls-verify")),
            namespace=ctx.get("namespace", "default"),
        )

    @classmethod
    def in_cluster(cls):
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not running in a cluster (no kubeconfig "
                               "file and KUBERNETES_SERVICE_HOST unset)")
        token = None
        token_path = os.path.join(SA_DIR, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
        ns = "default"
        ns_path = os.path.join(SA_DIR, "namespace")
        if os.path.exists(ns_path):
            with open(ns_path) as f:
                ns = f.read().strip() or "default"
        ca = os.path.join(SA_DIR, "ca.crt")
        return cls(server=f"https://{host}:{port}", token=token,
                   ca_file=ca if os.path.exists(ca) else None, namespace=ns)


def _parse_kubeconfig(text: str, path: str) -> dict:
    """A kubeconfig's document: JSON (valid YAML) through ``json``, other
    YAML through PyYAML, which this module needs only then."""
    try:
        doc = json.loads(text) if text.strip() else {}
    except ValueError:
        try:
            import yaml
        except ImportError:
            raise RuntimeError(
                f"kubeconfig {path} is YAML, not JSON, and PyYAML is not "
                f"installed: install PyYAML or write the kubeconfig as "
                f"JSON") from None
        doc = yaml.safe_load(text)
    return doc or {}


class KubeAPIClient:
    """`InMemoryAPIServer`-shaped facade over the real Kubernetes REST API.

    ``add_watcher`` starts informer threads (one per resource kind) that
    stream ``?watch=true`` events and replay them as the in-process
    ``(kind, event, obj)`` callbacks the scheduler/advertiser expect;
    ``close`` severs their streams and joins them.
    """

    # Kubernetes has no atomic multi-bind: bind_many annotates, then binds
    atomic_bind_many = False

    def __init__(self, config: KubeConfig, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        self.namespace = config.namespace
        self._watchers: list = []
        self._watch_threads: list = []
        self._stop = threading.Event()
        self._ssl = self._make_ssl_context()
        self._watch_lock = threading.Lock()
        # guarded-by: self._watch_lock -- every open watch stream's
        # connection, severed by close() to wake a blocked read
        self._watch_conns: set = set()

    def _make_ssl_context(self):
        if not self.config.server.startswith("https"):
            return None
        if self.config.insecure:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        else:
            ctx = ssl.create_default_context(cafile=self.config.ca_file)
        if self.config.client_cert:
            ctx.load_cert_chain(self.config.client_cert,
                                self.config.client_key)
        return ctx

    # -- plumbing -----------------------------------------------------------

    def _headers(self, content_type: str = "application/json") -> dict:
        h = {"Content-Type": content_type, "Accept": "application/json"}
        if self.config.token:
            h["Authorization"] = f"Bearer {self.config.token}"
        trace_ctx = obs.header_value()
        if trace_ctx is not None:
            # the binder's span context rides every write it performs
            # (annotate/bind), same contract as the HTTP control-plane
            # client — a tracing sidecar/proxy can continue the trace
            h[obs.TRACE_HEADER] = trace_ctx
        h.update(self.config.extra_headers)
        return h

    def _req(self, method: str, path: str, body=None,
             content_type: str = "application/json", timeout=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.config.server + path, data=data, method=method,
            headers=self._headers(content_type))
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout,
                    context=self._ssl) as resp:
                return json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            payload = e.read().decode()
            if e.code == 404:
                raise NotFound(payload)
            if e.code == 409:
                raise Conflict(payload)
            raise RuntimeError(f"{method} {path} -> HTTP {e.code}: {payload}")

    def _pod_path(self, name: str = "", sub: str = "") -> str:
        base = f"/api/v1/namespaces/{self.namespace}/pods"
        if name:
            base += f"/{urllib.parse.quote(name)}"
        if sub:
            base += f"/{sub}"
        return base

    # -- nodes --------------------------------------------------------------

    def create_node(self, node: dict) -> dict:
        return self._req("POST", "/api/v1/nodes", node)

    def get_node(self, name: str) -> dict:
        return self._req("GET", f"/api/v1/nodes/{urllib.parse.quote(name)}")

    def list_nodes(self) -> list:
        return self._req("GET", "/api/v1/nodes").get("items") or []

    def patch_node_metadata(self, name: str, metadata_patch: dict) -> dict:
        """Strategic-merge patch of node metadata — the advertiser's write
        path (`kubeinterface.go:145-158`)."""
        return self._req(
            "PATCH", f"/api/v1/nodes/{urllib.parse.quote(name)}",
            {"metadata": metadata_patch}, content_type=STRATEGIC_MERGE)

    def delete_node(self, name: str) -> None:
        self._req("DELETE", f"/api/v1/nodes/{urllib.parse.quote(name)}")

    # -- pods ---------------------------------------------------------------

    def create_pod(self, pod: dict) -> dict:
        return self._req("POST", self._pod_path(), pod)

    def get_pod(self, name: str) -> dict:
        return self._req("GET", self._pod_path(name))

    def list_pods(self, node_name: str | None = None,
                  phase: str | None = None, bound: bool = False) -> list:
        path = self._pod_path()
        selectors = []
        if node_name:
            selectors.append(f"spec.nodeName={node_name}")
        if phase:
            selectors.append(f"status.phase={phase}")
        if selectors:
            sel = urllib.parse.quote(",".join(selectors))
            path += f"?fieldSelector={sel}"
        items = self._req("GET", path).get("items") or []
        if bound:
            # the real apiserver has no "nodeName is set" field selector;
            # filtering client-side keeps the surface identical to the
            # in-memory/HTTP servers' bound index
            items = [p for p in items
                     if (p.get("spec") or {}).get("nodeName")]
        return items

    def update_pod_annotations(self, name: str, annotations: dict) -> dict:
        """Annotation-only strategic-merge patch — `UpdatePodMetadata`'s
        contract (`kubeinterface.go:175-193`): never touches spec/status."""
        return self._req(
            "PATCH", self._pod_path(name),
            {"metadata": {"annotations": annotations}},
            content_type=STRATEGIC_MERGE)

    def update_pod_annotations_many(self, annotations: dict) -> None:
        """Batched annotation replace. Kubernetes has no multi-object
        patch, so this degrades to one PATCH per pod — callers written
        against the batched surface stay correct on a real cluster and
        get the single-request form on the in-memory/HTTP servers. Every
        pod is attempted (one deleted pod must not strand its
        batch-mates' stamps) and missing pods are reported per-pod, the
        same NotFound shape the in-memory server raises."""
        missing: dict = {}
        conflicts: dict = {}
        other: list = []
        for name, ann in sorted(annotations.items()):
            try:
                self.update_pod_annotations(name, ann)
            except NotFound:
                missing[name] = "not found"
            except Conflict as e:
                # a 409 is the server's definitive refusal — it must
                # stay a typed Conflict with per-pod detail, or callers
                # would retry-in-place a refusal the server repeats
                conflicts[name] = str(e)
            except Exception as e:  # noqa: BLE001
                other.append((name, e))
        if other:
            name, err = other[0]
            raise RuntimeError(
                f"annotation batch failed for {[n for n, _ in other]}; "
                f"first: {name}: {err}") from err
        if conflicts:
            raise Conflict(
                f"annotation batch refused for {sorted(conflicts)}",
                per_pod=conflicts)
        if missing:
            raise NotFound(f"pods not found: {sorted(missing)}",
                           per_pod=missing)

    def bind_pod(self, name: str, node_name: str) -> None:
        """POST the v1 Binding subresource (`scheduler.go:405-417`)."""
        self._req("POST", self._pod_path(name, "binding"), {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": name, "namespace": self.namespace},
            "target": {"apiVersion": "v1", "kind": "Node",
                       "name": node_name},
        })

    def bind_many(self, bindings: dict, annotations: dict) -> None:
        """Gang commit against a real API server. Kubernetes has no
        atomic multi-bind; this is annotate-everything-then-
        bind-everything, every member attempted (the in-memory server's
        bind_many is the atomic analogue used for single-process runs).
        Failures are reported PER POD: all-Conflict failures raise a
        ``Conflict`` with ``per_pod`` detail — the same shape the
        arbiter raises, so the binder's taken-card handling (forget +
        requeue the losers, never blind-retry) works against a real
        cluster too — and anything else raises with the already-bound
        members listed so the caller can reconcile. The annotate stage
        shares `update_pod_annotations_many`'s every-member-attempted /
        per-pod-errors contract."""
        self.update_pod_annotations_many(annotations)
        bound: list = []
        conflicts: dict = {}
        other: list = []
        for name, node_name in sorted(bindings.items()):
            try:
                self.bind_pod(name, node_name)
                bound.append(name)
            except Conflict as e:
                conflicts[name] = str(e)
            except Exception as e:  # noqa: BLE001
                other.append((name, e))
        if other:
            name, err = other[0]
            raise RuntimeError(
                f"gang bind partially failed (bound {bound}, failed "
                f"{[n for n, _ in other]}): {err}") from err
        if conflicts:
            raise Conflict(
                f"bind refused for {len(conflicts)} pod(s) "
                f"(bound {bound})", per_pod=conflicts)

    def delete_pod(self, name: str) -> None:
        self._req("DELETE", self._pod_path(name))

    # -- persistent volumes / claims ----------------------------------------
    # PVCs are namespaced, PVs cluster-scoped (the real wire grammar). The
    # scheduler's volume binder consumes exactly this surface
    # (`volumebinder/volume_binder.go:1-74`).

    # -- selector owners (SelectorSpreadPriority listers) --------------------
    # The four owner kinds `selector_spreading.go`'s getSelectors lists.
    # List-only: this scheduler never creates them on a real cluster.

    def list_services(self) -> list:
        return self._req(
            "GET", f"/api/v1/namespaces/{self.namespace}/services"
        ).get("items") or []

    def list_rcs(self) -> list:
        return self._req(
            "GET",
            f"/api/v1/namespaces/{self.namespace}/replicationcontrollers"
        ).get("items") or []

    def list_rss(self) -> list:
        return self._req(
            "GET",
            f"/apis/apps/v1/namespaces/{self.namespace}/replicasets"
        ).get("items") or []

    def list_statefulsets(self) -> list:
        return self._req(
            "GET",
            f"/apis/apps/v1/namespaces/{self.namespace}/statefulsets"
        ).get("items") or []

    def _pvc_path(self, name: str = "") -> str:
        base = f"/api/v1/namespaces/{self.namespace}/persistentvolumeclaims"
        return base + (f"/{urllib.parse.quote(name)}" if name else "")

    @staticmethod
    def _pv_path(name: str = "") -> str:
        base = "/api/v1/persistentvolumes"
        return base + (f"/{urllib.parse.quote(name)}" if name else "")

    def create_pvc(self, pvc: dict) -> dict:
        return self._req("POST", self._pvc_path(), pvc)

    def get_pvc(self, name: str) -> dict:
        return self._req("GET", self._pvc_path(name))

    def list_pvcs(self) -> list:
        return self._req("GET", self._pvc_path()).get("items") or []

    def delete_pvc(self, name: str) -> None:
        self._req("DELETE", self._pvc_path(name))

    def create_pv(self, pv: dict) -> dict:
        return self._req("POST", self._pv_path(), pv)

    def get_pv(self, name: str) -> dict:
        return self._req("GET", self._pv_path(name))

    def list_pvs(self) -> list:
        return self._req("GET", self._pv_path()).get("items") or []

    def delete_pv(self, name: str) -> None:
        self._req("DELETE", self._pv_path(name))

    def bind_volume(self, pv_name: str, claim_name: str) -> None:
        """Commit a claim<->volume pairing the way the real binder does:
        patch the PV's ``claimRef``, then the PVC's ``volumeName`` (two
        strategic-merge patches — Kubernetes has no atomic pair-bind; the
        PV patch first makes the reservation visible before the claim
        flips).

        Re-claim guard: a real apiserver merges a claimRef patch over an
        existing one without complaint, so each side is GET-verified
        first (Conflict on a foreign pairing) and the observed
        ``resourceVersion`` rides in the patch body, which makes the
        write an optimistic test-and-set on servers that stamp it — an
        external binder racing into the GET->PATCH window loses to the
        precondition instead of being silently overwritten."""
        pv = self.get_pv(pv_name)
        ref = (pv.get("spec") or {}).get("claimRef")
        if ref and (ref.get("name") != claim_name
                    or (ref.get("namespace") or self.namespace)
                    != self.namespace):
            raise Conflict(
                f"pv {pv_name} already claimed by "
                f"{ref.get('namespace') or self.namespace}/{ref.get('name')}")
        body: dict = {"spec": {"claimRef": {"name": claim_name,
                                            "namespace": self.namespace}}}
        rv = (pv.get("metadata") or {}).get("resourceVersion")
        if rv:
            body["metadata"] = {"resourceVersion": rv}
        self._req("PATCH", self._pv_path(pv_name), body,
                  content_type=STRATEGIC_MERGE)
        pvc = self.get_pvc(claim_name)
        bound = (pvc.get("spec") or {}).get("volumeName")
        if bound and bound != pv_name:
            raise Conflict(f"pvc {claim_name} already bound to {bound}")
        body = {"spec": {"volumeName": pv_name}}
        rv = (pvc.get("metadata") or {}).get("resourceVersion")
        if rv:
            body["metadata"] = {"resourceVersion": rv}
        self._req("PATCH", self._pvc_path(claim_name), body,
                  content_type=STRATEGIC_MERGE)

    # -- watches ------------------------------------------------------------

    def add_watcher(self, fn) -> None:
        """Register ``fn(kind, event, obj)``; the first registration spawns
        watch threads for nodes, pods, claims and volumes."""
        self._watchers.append(fn)
        if not self._watch_threads:
            for kind, path in (
                    ("node", "/api/v1/nodes"),
                    ("pod", self._pod_path()),
                    ("pvc", self._pvc_path()),
                    ("pv", "/api/v1/persistentvolumes")):
                t = threading.Thread(
                    target=self._watch_loop, args=(kind, path), daemon=True,
                    name=f"kubewatch-{kind}")
                t.start()
                self._watch_threads.append(t)

    def _open_watch(self, path: str, version: str):
        """Dial one ``?watch=true`` stream from ``version``; returns the
        connection (registered for close() to sever) and its response.
        No read timeout: a quiet watch is a healthy one."""
        q = urllib.parse.urlencode(
            {"watch": "true", "resourceVersion": version})
        split = urllib.parse.urlsplit(self.config.server)
        if split.scheme == "https":
            conn = http.client.HTTPSConnection(
                split.hostname, split.port, timeout=self.timeout,
                context=self._ssl)
        else:
            conn = http.client.HTTPConnection(
                split.hostname, split.port, timeout=self.timeout)
        with self._watch_lock:
            if self._stop.is_set():
                raise ConnectionError("client is closed")
            self._watch_conns.add(conn)
        try:
            conn.request("GET", f"{split.path}{path}?{q}",
                         headers=self._headers())
            resp = conn.getresponse()
            if resp.status != 200:
                raise RuntimeError(
                    f"watch {path} -> HTTP {resp.status}: "
                    f"{resp.read().decode(errors='replace')}")
            if self._stop.is_set():
                # close() swept before this socket was dialled
                raise ConnectionError("client is closed")
            conn.sock.settimeout(None)
        except BaseException:
            self._drop_watch(conn)
            raise
        return conn, resp

    def _drop_watch(self, conn) -> None:
        with self._watch_lock:
            self._watch_conns.discard(conn)
        conn.close()

    def _watch_loop(self, kind: str, path: str) -> None:
        version = ""
        while not self._stop.is_set():
            conn = None
            try:
                # (Re)list to get a resourceVersion, then stream from it.
                if not version:
                    listing = self._req("GET", path)
                    version = (listing.get("metadata") or {}).get(
                        "resourceVersion") or "0"
                    for obj in listing.get("items") or []:
                        self._dispatch(kind, "added", obj)
                conn, resp = self._open_watch(path, version)
                for line in resp:
                    if self._stop.is_set():
                        return
                    line = line.strip()
                    if not line:
                        continue
                    evt = json.loads(line.decode())
                    obj = evt.get("object") or {}
                    version = (obj.get("metadata") or {}).get(
                        "resourceVersion") or version
                    self._dispatch(kind, evt.get("type", "").lower(), obj)
                # the server ended the stream: resume from `version`
            except Exception:
                if self._stop.is_set():
                    return
                log.warning("%s watch dropped; relisting", kind,
                            exc_info=True)
                version = ""  # relist after a dropped watch
                self._stop.wait(1.0)
            finally:
                if conn is not None:
                    self._drop_watch(conn)

    def _dispatch(self, kind: str, event: str, obj: dict) -> None:
        if event not in ("added", "modified", "deleted"):
            return  # BOOKMARK / ERROR frames
        for fn in list(self._watchers):
            try:
                fn(kind, event, obj)
            except Exception:
                # a bad watcher must not kill the informer, but it must
                # not fail invisibly either
                log.warning("watch consumer %r failed on %s %s event",
                            fn, kind, event, exc_info=True)

    def close(self) -> None:
        """Stop the informers: sever every watch stream (a shutdown wakes
        a read blocked with no timeout, where a close would not) and join
        the threads."""
        self._stop.set()
        with self._watch_lock:
            conns = list(self._watch_conns)
        for conn in conns:
            sock = conn.sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # already gone
        for t in self._watch_threads:
            t.join(timeout=self.timeout)
