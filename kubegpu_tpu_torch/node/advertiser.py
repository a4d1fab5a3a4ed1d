"""The device advertiser: node inventory -> API-server annotations.

The port's copy of ``kubegpu_tpu/node/advertiser.py`` (reference:
`crishim/pkg/kubeadvertise/advertise_device.go`). A loop (every 20 s by
default) builds a fresh `NodeInfo` from the device manager and patches
the node's annotations: the inventory, a wall-clock heartbeat, the
per-card health and dead-link maps, and the node's routable address. A
failed pass retries on a 5 s loop until a patch lands
(`advertise_device.go:63-95,130`).
"""

from __future__ import annotations

import logging
import threading
import time

from kubegpu_tpu_torch.core import codec
from kubegpu_tpu_torch.core.types import NodeInfo

DEFAULT_INTERVAL_S = 20.0
DEFAULT_RETRY_S = 5.0

log = logging.getLogger(__name__)


class DeviceAdvertiser:
    """``client`` is duck-typed: ``get_node`` and ``patch_node_metadata``
    (the port's `HTTPAPIClient`, or the JAX package's in-memory server
    in tests). ``clock`` stamps the heartbeat: wall clock, because the
    stamp crosses processes and hosts; the control plane ages its own
    observations of it."""

    def __init__(self, client, dev_mgr, node_name: str,
                 address: str | None = None, clock=None):
        self.client = client
        self.dev_mgr = dev_mgr
        self.node_name = node_name
        self.address = address
        # Deliberately NOT monotonic: the stamp crosses process (and
        # potentially host) boundaries, where monotonic clocks are
        # meaningless; the consumer (scheduler/lifecycle.py) ages its own
        # local observations instead of comparing clocks.
        # analysis: disable=monotonic-time
        self.clock = clock if clock is not None else time.time
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # written by the advertise loop only; healthz reads them
        self.patch_count = 0
        self.error_count = 0
        self.last_success_monotonic: float | None = None
        self._interval_s = DEFAULT_INTERVAL_S
        self._retry_s = DEFAULT_RETRY_S

    def advertise_once(self) -> None:
        """One advertise pass (`advertise_device.go:39-61`)."""
        self.client.get_node(self.node_name)  # fail fast if the node is gone
        info = NodeInfo(name=self.node_name)
        self.dev_mgr.update_node_info(info)
        meta: dict = {}
        codec.node_info_to_annotation(meta, info)
        codec.heartbeat_to_annotation(meta, self.clock())
        codec.chip_health_to_annotation(meta, self.dev_mgr.chip_health())
        codec.link_health_to_annotation(meta, self.dev_mgr.link_health())
        if self.address:
            meta["annotations"][codec.NODE_ADDRESS_ANNOTATION] = self.address
        self.client.patch_node_metadata(self.node_name, meta)
        self.patch_count += 1  # racer: single-writer
        self.last_success_monotonic = time.monotonic()  # racer: single-writer

    def healthy(self, now: float | None = None) -> bool:
        """The agent's ``/healthz``: false until the first pass lands, and
        false again once advertising has failed for longer than the
        interval plus one retry period."""
        if self.last_success_monotonic is None:
            return False
        now = time.monotonic() if now is None else now
        return (now - self.last_success_monotonic) <= \
            self._interval_s + self._retry_s

    def start(self, interval_s: float = DEFAULT_INTERVAL_S,
              retry_s: float = DEFAULT_RETRY_S) -> None:
        """Run the advertise loop in a daemon thread
        (`advertise_device.go:120-133`)."""
        # racer: single-writer -- start()/stop() are owner-thread calls
        self._interval_s = interval_s
        self._retry_s = retry_s  # racer: single-writer -- ditto

        def loop():
            while not self._stop.is_set():
                try:
                    self.advertise_once()
                    wait = interval_s
                except Exception:
                    self.error_count += 1
                    log.warning("advertise pass failed for node %s "
                                "(error %d)", self.node_name,
                                self.error_count, exc_info=True)
                    wait = retry_s
                self._stop.wait(wait)

        # racer: single-writer -- stop() joins the loop before clearing
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"advertiser-{self.node_name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
