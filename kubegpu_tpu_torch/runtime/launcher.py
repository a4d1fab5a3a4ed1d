"""Supervised workload launch: the "create and start the container" half.

The port's copy of ``kubegpu_tpu/runtime/launcher.py`` (reference:
`crishim/pkg/kubecri/docker_container.go:95-99`, where the shim hands the
rewritten config to ``DockerService.CreateContainer``, which creates and
starts it). The node agent has no container runtime behind it, so the
supervisor spawns the workload command as an OS process in its own
process group, with the rewritten config's env merged over the agent's
(parent < config: the allocation's ``CUDA_VISIBLE_DEVICES`` and torchrun's
variables win). The device nodes in the config are the runtime's to
create; the record lists them. A reaper thread notices exits, and each
start and exit is reported to the API server as the pod's
``pod.alpha/ContainerStatus`` annotation.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import threading
import time
import uuid

# Pod status annotation the supervisor maintains; one JSON blob per
# container, mirroring the node/pod DeviceInformation annotation style.
STATUS_ANNOTATION_KEY = "pod.alpha/ContainerStatus"

log = logging.getLogger(__name__)


class Container:
    """One supervised workload process (the container record)."""

    def __init__(self, cid: str, pod: str, container: str, config: dict,
                 command: list, proc: subprocess.Popen, log_path: str):
        self.cid = cid
        self.pod = pod
        self.container = container
        self.config = config
        self.command = list(command)
        self.proc = proc
        self.log_path = log_path
        # Wall clock on purpose: container status timestamps cross the CRI
        # boundary and are read by humans/other processes, like kubelet's.
        # analysis: disable=monotonic-time
        self.started_at = time.time()
        self.finished_at: float | None = None
        self.exit_code: int | None = None

    @property
    def state(self) -> str:
        return "running" if self.exit_code is None else "exited"

    def status(self) -> dict:
        return {
            "id": self.cid,
            "pod": self.pod,
            "container": self.container,
            "pid": self.proc.pid,
            "state": self.state,
            "exit_code": self.exit_code,
            "devices": [d.get("host_path") for d in
                        (self.config.get("devices") or [])],
            "log_path": self.log_path,
        }


class WorkloadSupervisor:
    """Spawn, track, and stop workload processes for rewritten configs.

    ``api`` (optional) receives lifecycle reports: the pod's
    `STATUS_ANNOTATION_KEY` annotation is updated on start and exit, so
    the scheduler side can watch run state the same way it watches
    allocations — through the API server, the system's only transport.
    """

    def __init__(self, api=None, log_dir: str | None = None):
        self.api = api
        self.log_dir = log_dir
        self._containers: dict[str, Container] = {}
        self._lock = threading.Lock()
        self._report_lock = threading.Lock()
        self._reaper: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle ------------------------------------------------------------

    def launch(self, pod: str, container: str, config: dict,
               command: list) -> Container:
        """Start ``command`` with the rewritten config's env injected.

        The env merge order is parent < config: the allocation's
        CUDA_VISIBLE_DEVICES and torchrun's variables win over anything
        inherited."""
        if not command:
            raise ValueError("launch needs a non-empty command")
        env = dict(os.environ)
        for e in config.get("envs") or []:
            env[e["key"]] = e["value"]
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            # names are request-derived: flatten to a collision-free safe
            # basename (no separators escaping log_dir, no a/b-c vs a-b/c
            # ambiguity from a plain '-' join)
            safe = "__".join(
                "".join(ch if ch.isalnum() or ch in "._-" else "_"
                        for ch in part) or "x"
                for part in (pod, container))
            log_path = os.path.join(self.log_dir, f"{safe}.log")
            log_file = open(log_path, "ab")
        else:
            log_path = os.devnull
            log_file = open(os.devnull, "wb")
        try:
            proc = subprocess.Popen(
                command, env=env, stdout=log_file, stderr=log_file,
                start_new_session=True)  # its own group: stop() kills children
        finally:
            log_file.close()
        cid = uuid.uuid4().hex[:12]
        cont = Container(cid, pod, container, config, command, proc, log_path)
        with self._lock:
            self._containers[cid] = cont
            if self._reaper is None:
                self._reaper = threading.Thread(
                    target=self._reap_loop, daemon=True, name="cri-reaper")
                self._reaper.start()
        self._report(cont)
        return cont

    def status(self, cid: str) -> dict:
        with self._lock:
            cont = self._containers.get(cid)
        if cont is None:
            raise KeyError(f"unknown container {cid}")
        self._poll(cont)
        return cont.status()

    def list(self) -> list:
        with self._lock:
            conts = list(self._containers.values())
        for c in conts:
            self._poll(c)
        return [c.status() for c in conts]

    def stop(self, cid: str, timeout: float = 5.0) -> dict:
        """SIGTERM the process group, escalate to SIGKILL after
        ``timeout`` — the CRI StopContainer contract."""
        with self._lock:
            cont = self._containers.get(cid)
        if cont is None:
            raise KeyError(f"unknown container {cid}")
        if cont.exit_code is None:
            try:
                os.killpg(cont.proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                cont.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(cont.proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                cont.proc.wait()
            self._poll(cont)
        return cont.status()

    def remove(self, cid: str) -> None:
        """Evict an exited container record (the CRI RemoveContainer
        analogue) — without this a long-running agent accumulates one
        record per launch forever. Running containers must be stopped
        first, as in the CRI contract."""
        with self._lock:
            cont = self._containers.get(cid)
        if cont is None:
            raise KeyError(f"unknown container {cid}")
        self._poll(cont)  # outside the lock: _report may hit the network
        with self._lock:
            if cont.exit_code is None:
                raise RuntimeError(
                    f"container {cid} is running; stop it first")
            self._containers.pop(cid, None)

    def logs(self, cid: str, tail_lines: int = 0) -> str:
        """The container's captured stdout/stderr (last ``tail_lines``
        when > 0) — the read side of the reference's streaming server
        (`docker_container.go:179-190`), file-backed instead of
        attach-multiplexed."""
        with self._lock:
            cont = self._containers.get(cid)
        if cont is None:
            raise KeyError(f"unknown container {cid}")
        if cont.log_path == os.devnull:
            return ""
        # bounded read: a workload can write gigabytes; serving a tail
        # query must not load the whole file into the agent. Reads the
        # last 1 MiB (lines longer than that are truncated at the front).
        max_bytes = 1 << 20
        try:
            with open(cont.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                data = f.read().decode(errors="replace")
        except OSError:
            return ""
        if tail_lines > 0:
            data = "\n".join(data.splitlines()[-tail_lines:])
        return data

    def wait(self, cid: str, timeout: float | None = None) -> dict:
        with self._lock:
            cont = self._containers.get(cid)
        if cont is None:
            raise KeyError(f"unknown container {cid}")
        cont.proc.wait(timeout=timeout)
        self._poll(cont)
        return cont.status()

    def shutdown(self) -> None:
        """Stop the reaper and every still-running container."""
        self._stop.set()
        with self._lock:
            cids = list(self._containers)
        for cid in cids:
            try:
                self.stop(cid, timeout=2.0)
            except KeyError:
                pass

    # -- internals ------------------------------------------------------------

    def _poll(self, cont: Container) -> None:
        if cont.exit_code is not None:
            return
        rc = cont.proc.poll()
        if rc is not None:
            cont.exit_code = rc
            # analysis: disable=monotonic-time  -- CRI status timestamp
            cont.finished_at = time.time()
            self._report(cont)

    def _reap_loop(self) -> None:
        """Notice exits promptly even when nobody polls status — exit
        reports must not wait for the next status query."""
        while not self._stop.wait(0.2):
            with self._lock:
                conts = list(self._containers.values())
            for c in conts:
                self._poll(c)

    def _report(self, cont: Container) -> None:
        if self.api is None:
            return
        # serialized: the annotation update is read-modify-write over a
        # SHARED per-pod blob, and concurrent reports for two containers
        # of one pod would lose the slower writer's entry forever
        with self._report_lock:
            try:
                pod = self.api.get_pod(cont.pod)
                # the update REPLACES the pod's annotations, so carry the
                # full dict forward: dropping the device allocation from a
                # bound running pod would destroy the placement record
                # (and the API server now refuses such writes outright)
                ann = dict((pod.get("metadata") or {})
                           .get("annotations") or {})
                statuses = json.loads(ann.get(STATUS_ANNOTATION_KEY) or "{}")
                statuses[cont.container] = cont.status()
                ann[STATUS_ANNOTATION_KEY] = json.dumps(statuses,
                                                        sort_keys=True)
                self.api.update_pod_annotations(cont.pod, ann)
            except Exception:
                # the API server being briefly away must not take down a
                # running workload; the advertiser loop has the same stance
                log.warning("status report of container %s (pod %s) "
                            "failed", cont.cid, cont.pod, exc_info=True)
