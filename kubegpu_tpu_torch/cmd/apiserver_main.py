"""``kgtpu-gpu-apiserver``: the port's API server as a binary.

The port's copy of ``kubegpu_tpu/cmd/apiserver_main.py``: an
`InMemoryAPIServer` (``cluster/apiserver.py``, whose arbiter keys GPU
cards) served on both wires by ``cluster/httpapi.serve_api``. ``--wire
json`` answers the stream upgrade with a plain 404, so every client
negotiates down to JSON.

With ``--wal-dir`` the server is durable: every watch event is appended to
a checksummed write-ahead log before any watcher sees it, the object state
is snapshotted and the log compacted every ``--wal-snapshot-every``
events, and a restart replays snapshot and log, so watch clients resume
seq-exact (``cluster/wal.py``). ``--apf`` puts the priority-and-fairness
front door (``cluster/apf.py``) in front of both wires. It prints
``apiserver listening at <url> ...`` and exits 0 on SIGTERM or SIGINT.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from kubegpu_tpu_torch.cluster.apf import APFDispatcher
from kubegpu_tpu_torch.cluster.apiserver import InMemoryAPIServer
from kubegpu_tpu_torch.cluster.httpapi import serve_api
from kubegpu_tpu_torch.cluster.wal import WriteAheadLog
from kubegpu_tpu_torch.cmd import common


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kgtpu-gpu-apiserver", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8070)
    p.add_argument("--wire", choices=("stream", "json"), default="stream",
                   help="stream (default) also serves the framed binary "
                        "wire behind an Upgrade handshake; json refuses "
                        "the upgrade, so every client negotiates down to "
                        "the JSON long poll")
    p.add_argument("--wal-dir", default=None,
                   help="directory of the write-ahead log and snapshot; a "
                        "restart recovers the state and the watch's "
                        "sequence space from it")
    p.add_argument("--wal-no-fsync", action="store_true",
                   help="no fsync per append (durable across a process "
                        "crash, not a power loss)")
    p.add_argument("--wal-snapshot-every", type=int, default=4096,
                   help="events between snapshot and compaction passes")
    p.add_argument("--apf", action="store_true",
                   help="the priority-and-fairness front door on both "
                        "wires: per-flow shuffle-sharded fair queuing with "
                        "bounded seats; system traffic (node PATCHes, "
                        "leases, watch, health) is exempt, and shed work "
                        "gets a typed 429 or REJECT with retry_after_s")
    common.add_observability_flags(p)
    return p


def main(argv=None) -> int:
    # a latency-sensitive multi-threaded service: the default 5 ms switch
    # interval lets one busy thread (a watch encode, a handler) stall a
    # reply for milliseconds
    sys.setswitchinterval(0.0005)
    args = parser().parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    # the profiler and the metrics time-series before any server object,
    # so the lock probe wraps the event log's, the WAL's and the front
    # door's locks
    stop_obs = common.start_observability(args)
    wal = WriteAheadLog(args.wal_dir, fsync=not args.wal_no_fsync,
                        snapshot_every=args.wal_snapshot_every) \
        if args.wal_dir else None
    apf = APFDispatcher() if args.apf else None
    server, url = serve_api(InMemoryAPIServer(), args.host, args.port,
                            wal=wal, stream_wire=args.wire == "stream",
                            apf=apf)
    print(f"apiserver listening at {url} (wire: {args.wire}+json)"
          + (f" (WAL at {args.wal_dir})" if wal else "")
          + (" (APF front door on)" if apf else ""), flush=True)
    stop.wait()
    # severs every connection, joins the push fan-out, closes the WAL and
    # releases the port
    server.shutdown()
    stop_obs()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
