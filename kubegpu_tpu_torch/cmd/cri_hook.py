"""``kgtpu-gpu-cri-hook``: per-container GPU injection, OCI-hook style.

The port's counterpart of ``kubegpu_tpu/cmd/cri_hook.py`` (reference:
`crishim/pkg/kubecri/docker_container.go`, where the shim rewrites the
config of every CreateContainer). The runtime pipes the container config
JSON to stdin and uses the rewritten JSON from stdout.

With ``--server`` (``http://127.0.0.1:PORT`` or ``unix:///path.sock``) it
is a thin client of the GPU node agent's endpoint, whose discovery ran
once. Without it, it runs standalone: its own discovery pass and its own
`GPURuntimeHook` against the API server at ``--api``.

    kgtpu-gpu-cri-hook --server unix:///run/kgtpu-gpu.sock \\
        --pod mypod --container main < config.json

A refusal (the pod's allocation is short of its ``alpha.gpu/numgpu``)
exits 1 with ``AllocationMismatch`` on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

from kubegpu_tpu_torch.cmd import common
from kubegpu_tpu_torch.runtime.hook import AllocationMismatch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--server", default=None,
                        help="node agent CRI endpoint (http://... or "
                             "unix:///...); omit for standalone mode")
    parser.add_argument("--api", default="http://127.0.0.1:8070")
    parser.add_argument("--pod", required=True)
    parser.add_argument("--container", required=True)
    parser.add_argument("--backend", default="nvml", choices=common.BACKENDS)
    parser.add_argument("--config", default=None)
    args = parser.parse_args(argv)
    common.merge_flags(parser, argv, args, common.load_config(args.config),
                       ["server", "api", "backend"])

    raw = sys.stdin.read()
    container_config = json.loads(raw) if raw.strip() else {}
    try:
        if args.server:
            from kubegpu_tpu_torch.runtime.server import \
                request_create_container

            out = request_create_container(args.server, args.pod,
                                           args.container, container_config)
        else:
            from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient
            from kubegpu_tpu_torch.cmd.node_agent import build_manager
            from kubegpu_tpu_torch.runtime.hook import GPURuntimeHook

            client = HTTPAPIClient(args.api)
            try:
                _, gpu = build_manager(args.backend)
                out = GPURuntimeHook(client, gpu).create_container(
                    args.pod, args.container, container_config)
            finally:
                client.close()
    except AllocationMismatch as e:
        print(f"AllocationMismatch: {e}", file=sys.stderr)
        return 1
    json.dump(out, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
