"""Seeded fault injection: over the API client, over a tenant's traffic,
and over the cards of fake GPU hosts.

The port's copy of ``kubegpu_tpu/cluster/chaos.py``. Every component (the
scheduler, the node agent, the lifecycle and repair controllers, the
runtime hook) reaches the control plane through one client surface, the
port's `InMemoryAPIServer` in process or `HTTPAPIClient` over a wire. A
`ChaosProxy` wraps any such client and, per call, may

- **drop** the request (raise ``ConnectionError`` before it is sent: the
  caller sees a transport fault, the server nothing),
- **delay** it (sleep before delivery),
- **duplicate** it (deliver twice and discard the second outcome, the
  at-least-once retry a real network can produce), or
- **partition** the component (every call fails until ``heal``).

Faults draw from one seeded RNG of the shared `ChaosNetwork`, in the JAX
package's order, so one seed gives a single-threaded caller the same
``(component, verb, fault)`` sequence in both packages. ``verbs=`` and
``exempt=`` scope a component's faults; ``add_watcher`` and ``close`` are
never faulted (process wiring, not requests).

`TenantFlood` is the abusive tenant of the ``tenant-flood`` scenario, and
`DeviceChaos` fails cards of `FakeGPUBackend` hosts. The JAX injector also
cuts ICI links (``link-down``); no GPU inventory the port reads reports a
link per card and its repair controller reads no link health, so
`DeviceChaos` refuses that kind with a ``ValueError`` (a deliberate
divergence, ROADMAP).
"""

from __future__ import annotations

import itertools
import random
import threading
import time

from kubegpu_tpu_torch.cluster.apf import TooManyRequests
from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.core.types import ContainerInfo, PodInfo

# Verbs never faulted: local wiring, not requests on the wire.
_PASSTHROUGH = {"add_watcher", "close"}

LINK_DOWN_DIVERGENCE = (
    "link-down is not injected on GPU hosts: no GPU inventory the port "
    "reads reports per-card links, and the repair controller reads no "
    "link health (a deliberate divergence from the JAX package's "
    "DeviceChaos)")


class ChaosConfig:
    """A component's fault rates: ``drop``, ``delay`` and ``duplicate``
    are probabilities per call, ``delay_s`` the injected latency."""

    def __init__(self, drop: float = 0.0, delay: float = 0.0,
                 delay_s: float = 0.002, duplicate: float = 0.0,
                 verbs: set | frozenset | None = None,
                 exempt: set | frozenset | None = None):
        self.drop = drop
        self.delay = delay
        self.delay_s = delay_s
        self.duplicate = duplicate
        self.verbs = frozenset(verbs) if verbs is not None else None
        self.exempt = frozenset(exempt or ())

    def applies_to(self, verb: str) -> bool:
        if verb in self.exempt:
            return False
        return self.verbs is None or verb in self.verbs


class ChaosNetwork:
    """The shared fault source of a set of proxied components: one seeded
    RNG, their configs, and the partition set."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._partitioned: set = set()
        self.faults: dict = {}  # (component, kind) -> count

    def proxy(self, api, component: str,
              config: ChaosConfig | None = None) -> "ChaosProxy":
        return ChaosProxy(self, api, component, config or ChaosConfig())

    # ---- partitions --------------------------------------------------------

    def partition(self, *components: str) -> None:
        """Cut the named components off from the API server."""
        with self._lock:
            self._partitioned.update(components)

    def heal(self, *components: str) -> None:
        """Reconnect components (none named: all of them)."""
        with self._lock:
            if components:
                self._partitioned.difference_update(components)
            else:
                self._partitioned.clear()

    def is_partitioned(self, component: str) -> bool:
        with self._lock:
            return component in self._partitioned

    # ---- drawing -----------------------------------------------------------

    def _count(self, component: str, kind: str) -> None:
        key = (component, kind)
        self.faults[key] = self.faults.get(key, 0) + 1

    def draw(self, component: str, verb: str, config: ChaosConfig):
        """This call's fate: ``(delay_s, duplicate)``, or a
        ``ConnectionError`` for a drop or a partition. Three draws a call
        that the config covers (drop, delay, duplicate), in that order,
        under the lock: the JAX package's order."""
        with self._lock:
            if component in self._partitioned:
                self._count(component, "partition")
                raise ConnectionError(
                    f"chaos: {component} is partitioned from the API "
                    f"server ({verb})")
            if not config.applies_to(verb):
                return 0.0, False
            if self._rng.random() < config.drop:
                self._count(component, "drop")
                raise ConnectionError(f"chaos: dropped {component}.{verb}")
            delay_s = 0.0
            if self._rng.random() < config.delay:
                self._count(component, "delay")
                delay_s = config.delay_s
            duplicate = self._rng.random() < config.duplicate
            if duplicate:
                self._count(component, "duplicate")
            return delay_s, duplicate


class TenantFlood:
    """The abusive tenant: ``threads`` threads send requests for ONE tenant
    as fast as the transport answers, ignoring the server's advised
    retry-after (an abuser does not defer). ``mode="mutate"`` creates
    1-card GPU pods; ``mode="read"`` lists pods instead, the read
    flood a proxy replica absorbs from its mirror. ``pace_s`` is the floor
    a network puts under even an abuser (0: infinitely fast). `stop`
    returns the counts: ``accepted``, ``rejected`` (typed 429s) and
    ``errored``."""

    def __init__(self, client_factory, tenant: str = "abuser",
                 threads: int = 4, pace_s: float = 0.001,
                 mode: str = "mutate"):
        if mode not in ("mutate", "read"):
            raise ValueError(f"unknown flood mode {mode!r}")
        self._factory = client_factory
        self.tenant = tenant
        self.threads = threads
        self.pace_s = pace_s
        self.mode = mode
        self._stop = threading.Event()
        # racer: single-writer -- start()/stop() are the driver
        # thread's lifecycle calls; flood workers never touch these
        self._workers: list = []
        # racer: single-writer -- same owner-thread lifecycle contract
        self._clients: list = []
        self._lock = threading.Lock()
        self.accepted = 0
        self.rejected = 0
        self.errored = 0
        self._seq = itertools.count()

    def _flood_pod(self, name: str) -> dict:
        pi = PodInfo(name=name)
        pi.running_containers["main"] = ContainerInfo(
            requests={grammar.RESOURCE_NUM_GPU: 1})
        meta = {"name": name, "labels": {"kgtpu.io/tenant": self.tenant}}
        codec.pod_info_to_annotation(meta, pi)
        return {"metadata": meta,
                "spec": {"containers": [
                    {"name": "main",
                     "resources": {"requests": {"cpu": "1"}}}]}}

    def _run(self, client) -> None:
        while not self._stop.is_set():
            name = f"{self.tenant}-flood-{next(self._seq)}"
            try:
                if self.mode == "read":
                    client.list_pods()
                else:
                    client.create_pod(self._flood_pod(name))
                with self._lock:
                    self.accepted += 1
            except TooManyRequests:
                # shed by the front door: an abuser sends again at once
                with self._lock:
                    self.rejected += 1
            except Exception:
                with self._lock:
                    self.errored += 1
            if self.pace_s > 0:
                self._stop.wait(self.pace_s)

    def start(self) -> "TenantFlood":
        for _ in range(self.threads):
            client = self._factory()
            self._clients.append(client)
            worker = threading.Thread(target=self._run, args=(client,),
                                      daemon=True, name="tenant-flood")
            self._workers.append(worker)
            worker.start()
        return self

    def stop(self) -> dict:
        """Stop the flood, join the workers, close their clients, and
        return the counts."""
        self._stop.set()
        for worker in self._workers:
            worker.join(timeout=10.0)
        self._workers = []
        for client in self._clients:
            close = getattr(client, "close", None)
            if close is not None:
                close()
        self._clients = []
        with self._lock:
            return {"accepted": self.accepted,
                    "rejected": self.rejected,
                    "errored": self.errored}


class DeviceChaos:
    """Seeded card faults over ``{node name: FakeGPUBackend}``: a card
    killed or flapping. The advertiser then reports the damage in the
    ordinary health annotation and the repair controller takes it from
    there. Every choice (the node, the card) comes from one seeded RNG,
    drawn as the JAX injector draws over sorted nodes and each host's
    device list, so twin fleets of equal counts get the same picks; `plan`
    draws a schedule of kinds up front."""

    KINDS = ("chip-kill", "chip-flap")

    def __init__(self, backends: dict, seed: int = 0):
        self._backends = dict(backends)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected: list = []  # (kind, node, card UUID, detail)

    def _pick(self, node: str | None, chip_id: str | None):
        """``(node, backend, card)``, drawn for whatever the caller left
        out."""
        node = node if node is not None \
            else self._rng.choice(sorted(self._backends))
        backend = self._backends[node]
        gpus = backend.inventory.gpus
        if chip_id is None:
            gpu = gpus[self._rng.randrange(len(gpus))]
        else:
            gpu = backend.inventory.gpu(chip_id)
            if gpu is None:
                raise KeyError(f"card {chip_id} not on node {node}")
        return node, backend, gpu

    def kill_chip(self, node: str | None = None,
                  chip_id: str | None = None) -> tuple:
        """Fail one card for good (a seeded pick where not named);
        returns ``(node, card UUID)``."""
        from kubegpu_tpu_torch.node.backend import CHIP_FAILED

        with self._lock:
            node, backend, gpu = self._pick(node, chip_id)
            backend.set_chip_health(gpu.uuid, CHIP_FAILED)
            self.injected.append(("chip-kill", node, gpu.uuid, ""))
            return node, gpu.uuid

    def flap_chip(self, node: str | None = None,
                  chip_id: str | None = None, period: int = 2) -> tuple:
        """Make one card's health probe report degraded on every
        ``period``-th call."""
        from kubegpu_tpu_torch.node.backend import CHIP_DEGRADED

        with self._lock:
            node, backend, gpu = self._pick(node, chip_id)
            backend.set_chip_flapper(gpu.uuid, CHIP_DEGRADED, period=period)
            self.injected.append(
                ("chip-flap", node, gpu.uuid, f"period={period}"))
            return node, gpu.uuid

    def cut_link(self, *args, **kwargs) -> tuple:
        raise ValueError(LINK_DOWN_DIVERGENCE)

    def plan(self, n: int, kinds: tuple = KINDS) -> list:
        """A seeded schedule of ``n`` fault kinds (the targets are drawn at
        injection, from the same RNG)."""
        with self._lock:
            return [self._rng.choice(list(kinds)) for _ in range(n)]

    def step(self, kind: str) -> tuple:
        """Apply one fault kind with a seeded target."""
        if kind == "chip-kill":
            return self.kill_chip()
        if kind == "chip-flap":
            return self.flap_chip()
        if kind == "link-down":
            return self.cut_link()
        raise ValueError(f"unknown device fault kind: {kind}")


class ChaosProxy:
    """A stand-in for the client it wraps: every public callable goes
    through the chaos network first."""

    def __init__(self, net: ChaosNetwork, api, component: str,
                 config: ChaosConfig):
        self._net = net
        self._api = api
        self._component = component
        self._config = config

    def __getattr__(self, name: str):
        real = getattr(self._api, name)
        if not callable(real) or name.startswith("_") \
                or name in _PASSTHROUGH:
            return real

        def wrapper(*args, **kwargs):
            delay_s, duplicate = self._net.draw(
                self._component, name, self._config)
            if delay_s > 0:
                time.sleep(delay_s)
            result = real(*args, **kwargs)
            if duplicate:
                # at-least-once delivery: the second outcome (often a
                # Conflict on a create) is the network's, not the caller's
                try:
                    real(*args, **kwargs)
                except Exception:
                    pass
            return result
        return wrapper
