"""Scheduler-side volume binding.

Analogue of the reference's `volumebinder/volume_binder.go:1-74` +
`predicates.go:1443-1465` (CheckVolumeBinding): during the fit pass every
node is checked for PV compatibility (bound PVCs: node affinity; unbound
PVCs: a matchable available PV), and at bind time the provisional
pvc->pv pairings are committed through the API server before the pod
binds — the kubelet must find the claim bound when the pod lands.

Differences from the reference, deliberate:

- No informer/workqueue machinery: the API server IS the source of truth
  and the scheduler is the only binder, so the in-flight reservation set
  (``_reserved``) replaces the binding cache; it exists to stop two pods
  in the same scheduling burst from being promised the same PV.
- All-or-nothing commit: if any pairing conflicts at bind time (e.g. an
  external writer grabbed the PV), already-committed pairings stay (PV
  binds are idempotent and harmless) and the pod is requeued — the next
  pass recomputes against fresh PV state.
"""

from __future__ import annotations

import threading

from kubegpu_tpu_torch.scheduler import predicates


class VolumeBinder:
    def __init__(self, api):
        self.api = api
        self._lock = threading.Lock()
        # pod name -> {pvc name: pv name} promised at schedule time
        self._assumed: dict = {}
        # pv names promised to in-flight pods (union of _assumed values)
        self._reserved: set = set()

    # ---- fit-pass support --------------------------------------------------

    def snapshot(self, kube_pod: dict):
        """(pvcs_by_name, pvs, reserved) for the fit pass, or None when
        the pod references no PVCs — the gate that keeps volume binding
        free for the common device-only pod."""
        if not predicates.pod_pvc_names(kube_pod):
            return None
        list_pvcs = getattr(self.api, "list_pvcs", None)
        list_pvs = getattr(self.api, "list_pvs", None)
        if list_pvcs is None or list_pvs is None:
            return None  # API without a volume surface: predicate no-ops
        pvcs = {p["metadata"]["name"]: p for p in list_pvcs()}
        pvs = list_pvs()
        with self._lock:
            reserved = set(self._reserved)
        return pvcs, pvs, reserved

    # (the predicate face lives in `factory._p_volume_binding`, which
    # unpacks a `snapshot()` and calls `predicates.check_volume_binding`)

    # ---- schedule-time assume / bind-time commit ---------------------------

    def assume(self, kube_pod: dict, kube_node: dict) -> bool:
        """Re-run matching against CURRENT volume state for the chosen
        node and reserve the pairings. False = volume state moved since
        the fit pass and the pod no longer binds here."""
        vol = self.snapshot(kube_pod)
        if vol is None:
            return True
        pvcs, pvs, reserved = vol
        ok, _, proposed = predicates.check_volume_binding(
            kube_pod, kube_node, pvcs, pvs, reserved)
        if not ok:
            return False
        if proposed:
            with self._lock:
                self._assumed[kube_pod["metadata"]["name"]] = proposed
                self._reserved.update(proposed.values())
        return True

    def bind(self, pod_name: str) -> bool:
        """Commit the assumed pairings through the API. True = all bound
        (or nothing to bind)."""
        with self._lock:
            proposed = self._assumed.pop(pod_name, None)
        if not proposed:
            return True
        ok = True
        try:
            for claim_name in sorted(proposed):
                try:
                    self.api.bind_volume(proposed[claim_name], claim_name)
                except Exception:
                    ok = False
                    break
        finally:
            with self._lock:
                self._reserved.difference_update(proposed.values())
        return ok

    def forget(self, pod_name: str) -> None:
        """Drop reservations for a pod that will not bind."""
        with self._lock:
            proposed = self._assumed.pop(pod_name, None)
            if proposed:
                self._reserved.difference_update(proposed.values())
