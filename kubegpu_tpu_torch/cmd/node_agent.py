"""``kgtpu-gpu-node-agent``: GPU discovery, the advertiser and the CRI hook
server of one node.

The port's counterpart of ``kubegpu_tpu/cmd/node_agent.py`` (reference:
`crishim/pkg/app/app.go`, and the persistent CRI endpoint of
`docker_container.go:115-191`). It discovers the host's NVIDIA cards
(``--backend nvml``, or a fake inventory), advertises them to the JAX
package's API server over its binary stream wire (``--wire stream``, the
default, which negotiates down to JSON against a server without it; or
``--wire json``), serves ``/healthz`` and
``/metrics`` on ``--healthz-port``, and on ``--cri-socket`` or
``--cri-port`` serves the port's `GPURuntimeHook` with a workload
supervisor behind it. So a GPU pod that comes through it has its stale
``/dev/nvidia*`` entries stripped, its ``alpha.gpu/numgpu`` request held
against its allocation (409 on a short one), and a gang's torchrun
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    kgtpu-gpu-node-agent --api http://127.0.0.1:8070 --backend nvml \\
        --register-node --cri-socket /run/kgtpu-gpu.sock

SIGTERM or SIGINT stops it: the CRI server first, then the supervisor
(which stops its containers), then the advertiser.
"""

from __future__ import annotations

import argparse
import signal
import socket
import threading

from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient
from kubegpu_tpu_torch.cmd import common
from kubegpu_tpu_torch.node.advertiser import DeviceAdvertiser
from kubegpu_tpu_torch.node.manager import DevicesManager, GPUDeviceManager


def build_manager(backend_kind: str, plugins_dir: str | None = None
                  ) -> tuple[DevicesManager, GPUDeviceManager]:
    """The node's device registry, started, and its GPU device. Raises
    when the GPU backend cannot discover (``nvml`` without a working
    ``libnvidia-ml``): a node agent with no cards to offer is a fault of
    the host, not an empty node."""
    gpu = GPUDeviceManager(common.build_backend(backend_kind))
    mgr = DevicesManager()
    mgr.add_device(gpu)
    if plugins_dir:
        # the reference's --cridevices seam (`crishim/pkg/app/app.go:33-38`)
        mgr.add_devices_from_plugins(plugins_dir)
    mgr.start()
    if gpu.inventory is None:
        # start() records a failed discovery as zero cards; ask once more
        # so the error names its cause
        gpu.backend.enumerate()
        raise RuntimeError("GPU discovery failed")
    return mgr, gpu


def _primary_address() -> str | None:
    """The routable primary IP, through a connected UDP socket (no packet
    is sent). The hostname often maps to a loopback address in
    /etc/hosts, which every remote gang member would dial as itself. On
    failure advertise nothing: the hook then falls back to the node
    name."""
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        probe.connect(("10.255.255.255", 1))
        return str(probe.getsockname()[0])
    except OSError:
        return None
    finally:
        probe.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--api", default="http://127.0.0.1:8070")
    parser.add_argument("--wire", choices=("stream", "json"),
                        default="stream",
                        help="control-plane wire (stream negotiates down "
                             "to json against an older apiserver)")
    parser.add_argument("--node-name", default=None,
                        help="defaults to the hostname, like kubelet")
    parser.add_argument("--node-address", default=None,
                        help="routable address advertised for this node "
                             "(gang coordinators resolve through it); "
                             "defaults to the host's primary IP")
    parser.add_argument("--backend", default="nvml", choices=common.BACKENDS)
    parser.add_argument("--device-plugins-dir", default=None,
                        help="load extra device plugins (*.py exporting "
                             "create_device_plugin) from this directory, "
                             "like the reference's --cridevices")
    parser.add_argument("--advertise-interval", type=float, default=20.0)
    parser.add_argument("--retry-interval", type=float, default=5.0)
    parser.add_argument("--register-node", action="store_true",
                        help="create the node object if absent")
    parser.add_argument("--healthz-port", type=int, default=0)
    parser.add_argument("--cri-socket", default=None,
                        help="serve the CRI create-container rewrite "
                             "endpoint on this unix socket")
    parser.add_argument("--cri-port", type=int, default=None,
                        help="serve the CRI rewrite endpoint on this "
                             "loopback TCP port (0 = ephemeral)")
    parser.add_argument("--launch-log-dir", default=None,
                        help="directory for supervised workloads' "
                             "stdout/stderr (default: discard)")
    parser.add_argument("--config", default=None)
    args = parser.parse_args(argv)
    common.merge_flags(parser, argv, args, common.load_config(args.config),
                       ["api", "node_name", "node_address", "backend",
                        "cri_socket", "cri_port"])
    # before anything is served: a SIGTERM right after the readiness
    # lines must stop the agent cleanly, not kill it
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())

    node_name = args.node_name or socket.gethostname()
    client = HTTPAPIClient(args.api, wire=args.wire)
    if args.register_node:
        try:
            client.get_node(node_name)
        except KeyError:
            client.create_node({"metadata": {"name": node_name}})

    address = args.node_address or _primary_address()
    mgr, gpu = build_manager(args.backend, args.device_plugins_dir)
    adv = DeviceAdvertiser(client, mgr, node_name, address=address)
    adv.start(interval_s=args.advertise_interval, retry_s=args.retry_interval)
    # /healthz goes 500 until the first advertise lands and again once
    # advertising has failed for longer than the interval
    health = common.serve_health(args.healthz_port, extra_status=adv.healthy)

    cri_server = None
    supervisor = None
    if args.cri_socket or args.cri_port is not None:
        from kubegpu_tpu_torch.runtime.hook import GPURuntimeHook
        from kubegpu_tpu_torch.runtime.launcher import WorkloadSupervisor
        from kubegpu_tpu_torch.runtime.server import CRIHookServer

        supervisor = WorkloadSupervisor(api=client,
                                        log_dir=args.launch_log_dir)
        cri_server = CRIHookServer(
            GPURuntimeHook(client, gpu), unix_socket=args.cri_socket,
            port=None if args.cri_socket else args.cri_port,
            supervisor=supervisor)
        cri_server.start()
        where = args.cri_socket or f"127.0.0.1:{cri_server.port}"
        print(f"cri-hook serving on {where}", flush=True)
    print(f"node-agent advertising {node_name} -> {args.api}", flush=True)

    stop.wait()
    # the server first: no launch may arrive once the supervisor has begun
    # stopping containers, or it would run unsupervised
    if cri_server is not None:
        cri_server.stop()
    if supervisor is not None:
        supervisor.shutdown()
    adv.stop()
    if health is not None:
        health.shutdown()
        health.server_close()
    client.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
