"""``kgtpu-gpu-apiserver`` (`kubegpu_tpu_torch/cmd/apiserver_main.py`) as a
subprocess: it serves ``/healthz`` and both wires (``--wire json`` answers
the upgrade with plain HTTP, so the client negotiates down), exits 0 on
SIGTERM, and with ``--wal-dir`` a SIGKILL and a restart on the same port
recover its nodes and pods, and its arbiter's card claims."""

import json
import os
import signal
import urllib.request

import pytest

pytest.importorskip("torch")

from kubegpu_tpu_torch.cluster import apiserver, httpapi  # noqa: E402
from tests import torch_api as ta  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("wire", ["stream", "json"])
def test_it_serves_healthz_and_both_wires_and_stops_on_sigterm(wire):
    binary = ta.APIServerBinary(REPO, "--wire", wire)
    try:
        assert f"(wire: {wire}+json)" in binary.line
        with urllib.request.urlopen(binary.url + "/healthz",
                                    timeout=10) as r:
            assert r.status == 200 and json.loads(r.read()) == {"ok": True}
        for want in ("stream", "json"):
            client = httpapi.HTTPAPIClient(binary.url, wire=want)
            try:
                client.create_node(ta.gpu_node(f"host-{want}"))
                assert client.get_node(f"host-{want}")["metadata"][
                    "name"] == f"host-{want}"
                # a server without the stream wire negotiates it down
                assert client.wire == (want if wire == "stream" else "json")
            finally:
                client.close()
    finally:
        assert binary.stop() == 0


def test_a_sigkill_and_a_restart_recover_its_state(tmp_path):
    binary = ta.APIServerBinary(REPO, "--wal-dir", str(tmp_path / "wal"),
                                "--apf")
    assert "(WAL at " in binary.line and "(APF front door on)" in binary.line
    client = httpapi.HTTPAPIClient(binary.url, wire="stream")
    try:
        for i in range(3):
            client.create_node(ta.gpu_node(f"host{i}", i))
        ann = ta.gpu_pod("x", 1, alloc=(2, (5,)))["metadata"]["annotations"]
        for name in ("owner", "thief", "other"):
            client.create_pod(ta.gpu_pod(name, tenant="ta"))
        client.bind_many({"owner": "host2"}, {"owner": ann})
        nodes, pods = client.list_nodes(), client.list_pods()
        assert binary.stop(signal.SIGKILL) == -signal.SIGKILL
        binary.start()
        assert client.list_nodes() == nodes and client.list_pods() == pods
        with pytest.raises(apiserver.Conflict) as err:
            client.bind_many({"thief": "host2"}, {"thief": ann})
        assert "taken by owner" in err.value.per_pod["thief"]
        assert client.list_quotas()["ta"]["chips_created"] == 3
    finally:
        client.close()
        assert binary.stop() == 0
