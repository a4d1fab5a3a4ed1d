"""The container-runtime (CRI) hook for NVIDIA cards.

The counterpart of ``kubegpu_tpu/runtime/hook.py``'s `TPURuntimeHook`
(reference: `crishim/pkg/kubecri/docker_container.go:37-100`): on
``CreateContainer`` re-fetch the pod from the API server, strip every
existing ``/dev/nvidia*`` entry from the container config, check the
allocation against the request, and append the allocated device nodes and
env. A gang's process contract becomes what
``workload.spmd.distributed_init_from_env`` reads.

Container configs are CRI-JSON-shaped dicts::

    {"devices": [{"container_path", "host_path", "permissions"}],
     "envs":    [{"key", "value"}], ...}

``api`` is duck-typed (``get_pod``, ``get_node``); the port imports no API
client.
"""

from __future__ import annotations

import json

from kubegpu_tpu_torch.core import codec, grammar

# Device-node prefix this hook owns (cards, nvidiactl, nvidia-uvm*);
# anything else is left untouched.
GPU_DEVICE_PREFIX = "/dev/nvidia"
# The scheduler's per-pod process contract: one JSON blob {gang, rank,
# count, coordinator_node, coordinator_port} (the JAX package's
# scheduler/gang.py writes it).
GANG_PROCESS_ANNOTATION = "pod.alpha/GangProcess"


class AllocationMismatch(RuntimeError):
    """Annotation and request disagree: refuse to start the container
    (`docker_container.go:58-60`)."""


class GPURuntimeHook:
    """``dev_mgr`` is the node's `GPUDeviceManager`."""

    def __init__(self, api, dev_mgr):
        self.api = api
        self.dev_mgr = dev_mgr

    def _gang_process_env(self, kube_pod: dict) -> dict:
        """torchrun's variables for the gang's process contract, if the
        scheduler wrote one: the coordinator node resolved to a routable
        address through its advertised ``node.alpha/Address`` (its name
        where it advertises none), the port, the world size and this
        pod's rank. Each pod sees only its own cards, so its local rank
        is 0."""
        raw = ((kube_pod.get("metadata") or {}).get("annotations") or {}).get(
            GANG_PROCESS_ANNOTATION)
        if not raw:
            return {}
        gp = json.loads(raw)
        node = gp["coordinator_node"]
        addr = node
        try:
            node_obj = self.api.get_node(node)
            addr = ((node_obj.get("metadata") or {}).get("annotations")
                    or {}).get(codec.NODE_ADDRESS_ANNOTATION) or node
        except Exception:
            pass  # unadvertised node: the name itself may resolve
        return {
            "MASTER_ADDR": str(addr),
            "MASTER_PORT": str(gp["coordinator_port"]),
            "WORLD_SIZE": str(gp["count"]),
            "RANK": str(gp["rank"]),
            "LOCAL_RANK": "0",
        }

    def create_container(self, pod_name: str, container_name: str,
                         config: dict) -> dict:
        """Rewrite one container config before the runtime sees it."""
        kube_pod = self.api.get_pod(pod_name)
        pod_info = codec.kube_pod_to_pod_info(kube_pod, invalidate_existing=False)
        cont = pod_info.container(container_name)
        if cont is None:
            return config

        # The allocation in the annotation is the only source of truth
        # (`docker_container.go:39-57`).
        devices = [d for d in (config.get("devices") or [])
                   if not d.get("host_path", "").startswith(GPU_DEVICE_PREFIX)]

        requested = int(cont.requests.get(grammar.RESOURCE_NUM_GPU, 0))
        allocated = sum(1 for path in cont.allocate_from.values()
                        if grammar.gpu_id_from_path(path) is not None)
        if requested > 0 and allocated < requested:
            raise AllocationMismatch(
                f"pod {pod_name}/{container_name}: requested {requested} "
                f"GPUs but annotation allocates {allocated}")

        _, device_paths, env = self.dev_mgr.allocate(pod_info, cont)
        env.update(self._gang_process_env(kube_pod))
        for path in device_paths:
            devices.append({"container_path": path, "host_path": path,
                            "permissions": "mrw"})
        config["devices"] = devices

        envs = [e for e in (config.get("envs") or [])
                if e.get("key") not in env]
        for key in sorted(env):
            envs.append({"key": key, "value": env[key]})
        config["envs"] = envs
        return config
