"""``kgtpu-gpu-proxy``: a watch-cache proxy replica in front of the port's
API server.

The port's copy of ``kubegpu_tpu/cmd/proxy_main.py``. It holds one stream
subscription upstream and serves its downstream watchers from a local
window (``cluster/proxy.py``); resume stays seq-exact through it, since the
sequence space is the server's own, so clients move between a replica and
the server without a relist. Reads are answered from the mirrored store,
writes are forwarded with their typed errors. Run N replicas, shared
nothing, and point each client shard at one. It prints ``proxy <name>
listening at <url> (upstream <url>)`` and exits 0 on SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from kubegpu_tpu_torch.cluster.apf import APFDispatcher
from kubegpu_tpu_torch.cluster.proxy import WatchCacheProxy
from kubegpu_tpu_torch.cmd import common


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kgtpu-gpu-proxy", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--upstream", required=True,
                   help="the API server's base URL this replica mirrors "
                        "(e.g. http://127.0.0.1:8070)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--name", default="proxy",
                   help="the replica's name: labels "
                        "proxy_downstream_watchers and the upstream "
                        "consumer thread")
    p.add_argument("--wire", choices=("stream", "json"), default="stream",
                   help="downstream wire: stream (default) also serves the "
                        "framed binary wire; json refuses the upgrade. The "
                        "upstream leg negotiates on its own")
    p.add_argument("--window", type=int, default=10000,
                   help="events in the local window; a resume below it "
                        "backfills from the deeper upstream window")
    p.add_argument("--apf", action="store_true",
                   help="this replica's own priority-and-fairness front "
                        "door: a flooding tenant saturates only this "
                        "shard, system traffic stays exempt")
    common.add_observability_flags(p)
    return p


def main(argv=None) -> int:
    # as the API server: a busy encode thread must not stall a reply for
    # a whole default switch interval
    sys.setswitchinterval(0.0005)
    args = parser().parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop_obs = common.start_observability(args)
    apf = APFDispatcher() if args.apf else None
    proxy = WatchCacheProxy(args.upstream, name=args.name, host=args.host,
                            port=args.port, apf=apf, limit=args.window,
                            stream_wire=args.wire == "stream")
    print(f"proxy {args.name} listening at {proxy.url} "
          f"(upstream {args.upstream})"
          + (" (APF front door on)" if apf else ""), flush=True)
    stop.wait()
    proxy.stop()
    stop_obs()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
