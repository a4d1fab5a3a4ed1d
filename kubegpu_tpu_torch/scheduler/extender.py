"""Scheduler extender: HTTP callouts that veto or re-rank nodes.

Reference: `kube-scheduler/pkg/core/extender.go` (252 LoC) + the policy
config that declares extenders (`kube-scheduler/pkg/api/types.go`). An
extender is an external HTTP service the scheduler consults after its own
predicates/priorities — the escape hatch for constraints the in-process
plugins don't model.

Wire protocol (JSON over POST, mirroring upstream's v1 shapes):

- ``filter``:   {"pod": <pod>, "nodeNames": [...]} ->
                {"nodeNames": [...], "failedNodes": {name: reason}}
- ``prioritize``: {"pod": <pod>, "nodeNames": [...]} ->
                [{"host": name, "score": int}, ...]   (0..10 per upstream)
- ``bind``:     {"podName": name, "node": name} -> {} | {"error": reason}
                (`extender.go:44,90`: an extender declaring a bind verb
                OWNS the binding — it performs the placement itself, e.g.
                against its own device manager, instead of the scheduler
                POSTing the Binding)

Declared in the scheduler config as::

    {"extenders": [{"urlPrefix": "http://127.0.0.1:9199",
                    "filterVerb": "filter",
                    "prioritizeVerb": "prioritize",
                    "weight": 1, "enableHttps": false}]}

A filter extender that errors fails the pods-fit pass closed unless
``ignorable`` is set (upstream `HTTPExtender.IsIgnorable`).

The port's copy of ``kubegpu_tpu/scheduler/extender.py``: the protocol
has no device path, so both engines send and read the same bodies.
"""

from __future__ import annotations

import json
import urllib.request


class ExtenderError(RuntimeError):
    pass


class HTTPExtender:
    def __init__(self, url_prefix: str, filter_verb: str | None = None,
                 prioritize_verb: str | None = None, weight: float = 1.0,
                 ignorable: bool = False, timeout_s: float = 5.0,
                 bind_verb: str | None = None):
        self.url_prefix = url_prefix.rstrip("/")
        self.filter_verb = filter_verb
        self.prioritize_verb = prioritize_verb
        self.bind_verb = bind_verb
        self.weight = weight
        self.ignorable = ignorable
        self.timeout_s = timeout_s

    @classmethod
    def from_config(cls, cfg: dict) -> "HTTPExtender":
        return cls(
            url_prefix=cfg["urlPrefix"],
            filter_verb=cfg.get("filterVerb"),
            prioritize_verb=cfg.get("prioritizeVerb"),
            bind_verb=cfg.get("bindVerb"),
            weight=float(cfg.get("weight", 1.0)),
            ignorable=bool(cfg.get("ignorable", False)),
            timeout_s=float(cfg.get("httpTimeout", 5.0)),
        )

    def _post(self, verb: str, payload: dict):
        req = urllib.request.Request(
            f"{self.url_prefix}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode())

    def filter(self, kube_pod: dict, node_names: list) -> tuple:
        """Returns (surviving node names, {failed node: reason})."""
        if not self.filter_verb:
            return node_names, {}
        try:
            out = self._post(self.filter_verb,
                             {"pod": kube_pod, "nodeNames": node_names})
        except Exception as e:
            if self.ignorable:
                return node_names, {}
            raise ExtenderError(f"extender {self.url_prefix} filter: {e}") from e
        survivors = out.get("nodeNames")
        if survivors is None:
            survivors = node_names
        return list(survivors), dict(out.get("failedNodes") or {})

    def prioritize(self, kube_pod: dict, node_names: list) -> dict:
        """Returns {node name: weighted score contribution}."""
        if not self.prioritize_verb:
            return {}
        try:
            out = self._post(self.prioritize_verb,
                             {"pod": kube_pod, "nodeNames": node_names})
            # Shape the reply inside the try: a malformed response (an
            # error object, non-dict entries) is as non-fatal as a refused
            # connection — scoring hiccups must never block placement.
            allowed = set(node_names)
            return {entry["host"]: float(entry.get("score", 0)) * self.weight
                    for entry in out if isinstance(entry, dict)
                    and entry.get("host") in allowed}
        except Exception:
            return {}  # prioritize errors are non-fatal upstream

    def bind(self, pod_name: str, node_name: str) -> None:
        """Delegate the binding to the extender (`extender.go:44,90`).
        Raises ``ExtenderError`` when the extender refuses or errors —
        binding is placement, never soft-failed like prioritize."""
        try:
            out = self._post(self.bind_verb,
                             {"podName": pod_name, "node": node_name})
        except Exception as e:
            raise ExtenderError(
                f"extender {self.url_prefix} bind: {e}") from e
        if isinstance(out, dict) and out.get("error"):
            raise ExtenderError(
                f"extender {self.url_prefix} bind: {out['error']}")


def load_extenders(config: dict) -> list:
    return [HTTPExtender.from_config(c) for c in config.get("extenders") or []]
