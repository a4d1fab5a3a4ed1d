"""The port's GPU node agent and CRI hook binaries
(`kubegpu_tpu_torch/cmd/node_agent.py`, `cmd/cri_hook.py`) against the JAX
package's control plane: its API server served over HTTP, its `Scheduler`
with the port's scheduler plugin (the pattern of
tests/test_torch_gpu_e2e.py), and its node agent loading the port's device
plugin as the reference to advertise against. The agent runs as a
subprocess on the ``fake-hgx`` backend (node/fake.py's HGX H100 board)."""

import argparse
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.cluster.httpapi import serve_api  # noqa: E402
from kubegpu_tpu.core import codec as jax_codec  # noqa: E402
from kubegpu_tpu.node.advertiser import \
    DeviceAdvertiser as JaxAdvertiser  # noqa: E402
from kubegpu_tpu.node.manager import \
    DevicesManager as JaxDevicesManager  # noqa: E402
from kubegpu_tpu.runtime.hook import TPURuntimeHook  # noqa: E402
from kubegpu_tpu.runtime.server import CRIHookServer as JaxCRIServer  # noqa: E402
from kubegpu_tpu.runtime.server import \
    request_create_container as jax_request  # noqa: E402
from kubegpu_tpu.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu.scheduler.lifecycle import (LOST, READY,  # noqa: E402
                                             NodeLifecycle)
from kubegpu_tpu.scheduler.registry import DevicesScheduler  # noqa: E402
from kubegpu_tpu.scheduler.tpu_scheduler import TPUScheduler  # noqa: E402
from kubegpu_tpu_torch.cmd import common  # noqa: E402
from kubegpu_tpu_torch.cmd.node_agent import build_manager  # noqa: E402
from kubegpu_tpu_torch.core import codec, grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.node.advertiser import DeviceAdvertiser  # noqa: E402
from kubegpu_tpu_torch.node.manager import (DevicesManager,  # noqa: E402
                                            GPUDeviceManager)
from kubegpu_tpu_torch.runtime.hook import (GANG_PROCESS_ANNOTATION,  # noqa: E402
                                            AllocationMismatch)
from kubegpu_tpu_torch.runtime.launcher import \
    STATUS_ANNOTATION_KEY  # noqa: E402
from kubegpu_tpu_torch.runtime.server import \
    request_create_container  # noqa: E402
from tests.test_torch_gpu_e2e import (DEVICE_PLUGINS,  # noqa: E402
                                      SCHEDULER_PLUGINS, gpu_pod)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE = "host0"
STALE = {"devices": [
    {"host_path": "/dev/nvidia9", "container_path": "/dev/nvidia9"},
    {"host_path": "/dev/null", "container_path": "/dev/null"}],
    "envs": [{"key": "KEEP", "value": "1"}]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {k: v for k, v in os.environ.items()
            if k not in ("CUDA_VISIBLE_DEVICES", "MASTER_ADDR", "RANK")}


class Agent:
    """``python -m kubegpu_tpu_torch.cmd.node_agent`` as a subprocess,
    started and waited for until it advertises."""

    def __init__(self, url, tmp_path, *extra, cri="unix"):
        self.healthz = _free_port()
        args = ["--api", url, "--node-name", NODE, "--backend", "fake-hgx",
                "--node-address", "127.0.0.1", "--advertise-interval", "0.2",
                "--retry-interval", "0.2", "--healthz-port", str(self.healthz),
                "--launch-log-dir", str(tmp_path / "logs"), *extra]
        if cri == "unix":
            args += ["--cri-socket", str(tmp_path / "gpu.sock")]
        elif cri == "tcp":
            args += ["--cri-port", "0"]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubegpu_tpu_torch.cmd.node_agent", *args],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.endpoint = None
        for line in self.proc.stdout:
            if line.startswith("cri-hook serving on "):
                where = line.split()[-1]
                self.endpoint = f"unix://{where}" if where.startswith("/") \
                    else f"http://{where}"
            if line.startswith("node-agent advertising"):
                break
        else:
            raise AssertionError(f"agent died: {self.proc.stderr.read()}")

    def stop(self, timeout: float = 10.0) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.proc.stdout.close()
            self.proc.stderr.close()


def _wait(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _advertised(api):
    ann = (api.get_node(NODE)["metadata"].get("annotations") or {})
    return ann if codec.NODE_ANNOTATION_KEY in ann else None


@pytest.fixture()
def control_plane():
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    yield api, url
    server.shutdown()


def _scheduler(api):
    ds = DevicesScheduler()
    ds.add_device(TPUScheduler())
    assert ds.add_devices_from_plugins(SCHEDULER_PLUGINS) == 1
    return Scheduler(api, ds)


def _placed(api, name, numgpu, gang=None):
    sched = _scheduler(api)
    api.create_pod(gpu_pod(name, numgpu))
    sched.run_until_idle()
    pod = api.get_pod(name)
    assert pod["spec"]["nodeName"] == NODE
    if gang is not None:
        pod["metadata"]["annotations"][GANG_PROCESS_ANNOTATION] = \
            json.dumps(gang)
        api.restore_object("pod", "modified", pod)
    return pod


def _registered(api):
    api.create_node({"metadata": {"name": NODE},
                     "status": {"allocatable": {"cpu": "64", "pods": 100}}})


def _jax_reference_annotations(address="127.0.0.1") -> dict:
    """What the JAX node agent, given the port's device plugin directory,
    advertises for the same fake host."""
    api = InMemoryAPIServer()
    api.create_node({"metadata": {"name": NODE}})
    dm = JaxDevicesManager()
    assert dm.add_devices_from_plugins(DEVICE_PLUGINS) == 1
    dm.devices[0].backend = fake.FakeGPUBackend(fake.hgx_h100_inventory())
    dm.start()
    JaxAdvertiser(api, dm, NODE, address=address).advertise_once()
    return api.get_node(NODE)["metadata"]["annotations"]


def _transport_bytes(agent) -> dict:
    """The agent's ``transport_bytes_total`` from its ``/metrics``, as
    {(wire, dir): bytes}."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{agent.healthz}/metrics", timeout=5) as r:
        text = r.read().decode()
    assert "# TYPE serve_ttft_ms histogram" in text
    out = {}
    for m in re.finditer(r'^transport_bytes_total\{wire="(\w+)",dir="(\w+)"\}'
                         r" (\d+)$", text, re.M):
        out[m.group(1), m.group(2)] = int(m.group(3))
    return out


@pytest.mark.parametrize("wire", ["json", "stream"])
def test_agent_advertises_what_the_jax_agent_advertises(control_plane,
                                                        tmp_path, wire):
    api, url = control_plane
    agent = Agent(url, tmp_path, "--register-node", "--wire", wire, cri=None)
    try:
        got = _wait(lambda: _advertised(api), what="the first advertise")
        want = _jax_reference_annotations()
        for ann in (got, want):
            assert jax_codec.annotation_to_heartbeat({"annotations": ann})
        strip = {codec.NODE_HEARTBEAT_ANNOTATION}
        assert {k: v for k, v in got.items() if k not in strip} == \
            {k: v for k, v in want.items() if k not in strip}
        info = jax_codec.annotation_to_node_info({"annotations": got})
        assert info.allocatable["alpha.gpu/numgpu"] == 8
        with urllib.request.urlopen(
                f"http://127.0.0.1:{agent.healthz}/healthz", timeout=5) as r:
            assert r.status == 200 and r.read() == b"ok"
        moved = _transport_bytes(agent)
        other = "json" if wire == "stream" else "stream"
        assert moved[wire, "tx"] > 0 and moved[wire, "rx"] > 0
        assert moved.get((other, "tx"), 0) == 0
    finally:
        assert agent.stop() == 0


def test_agent_negotiates_down_to_json_against_a_json_only_server(tmp_path):
    api = InMemoryAPIServer()
    server, url = serve_api(api, stream_wire=False)
    agent = Agent(url, tmp_path, "--register-node", cri=None)
    try:
        got = _wait(lambda: _advertised(api), what="the first advertise")
        strip = {codec.NODE_HEARTBEAT_ANNOTATION}
        assert {k: v for k, v in got.items() if k not in strip} == \
            {k: v for k, v in _jax_reference_annotations().items()
             if k not in strip}
        moved = _transport_bytes(agent)
        assert moved["json", "tx"] > 0 and ("stream", "tx") not in moved
    finally:
        assert agent.stop() == 0
        server.shutdown()


@pytest.mark.parametrize("flag,wire", [((), "stream"),
                                       (("--wire", "json"), "json"),
                                       (("--wire", "stream"), "stream")])
def test_wire_defaults_to_stream(monkeypatch, flag, wire):
    from kubegpu_tpu_torch.cmd import node_agent

    class Built(Exception):
        pass

    def client(api, wire):
        raise Built(wire)

    monkeypatch.setattr(node_agent, "HTTPAPIClient", client)
    monkeypatch.setattr(node_agent.signal, "signal", lambda *a: None)
    with pytest.raises(Built) as got:
        node_agent.main(["--api", "http://127.0.0.1:1", "--node-name", NODE,
                         *flag])
    assert got.value.args == (wire,)
    with pytest.raises(SystemExit):
        node_agent.main(["--wire", "grpc"])


def test_jax_scheduler_binds_a_pod_the_agent_advertised_over_stream(
        control_plane, tmp_path):
    api, url = control_plane
    _registered(api)
    agent = Agent(url, tmp_path, cri=None)
    try:
        _wait(lambda: _advertised(api), what="the first advertise")
        moved = _transport_bytes(agent)
        assert moved["stream", "tx"] > 0 and ("json", "tx") not in moved
        pod = _placed(api, "bound", 2)
    finally:
        assert agent.stop() == 0
    pi = codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
    cards = {grammar.gpu_id_from_path(p) for p in
             pi.running_containers["main"].allocate_from.values()}
    cards.discard(None)
    assert len(cards) == 2 and \
        cards <= {g.uuid for g in fake.hgx_h100_inventory().gpus}


def test_jax_lifecycle_reads_the_port_heartbeat(control_plane, tmp_path):
    api, url = control_plane
    _registered(api)
    agent = Agent(url, tmp_path, cri=None)
    life = NodeLifecycle(api, stale_after_s=5.0, lost_after_s=10.0,
                         delete_lost_nodes=False)
    try:
        _wait(lambda: _advertised(api), what="the first advertise")
        first = jax_codec.annotation_to_heartbeat(api.get_node(NODE)["metadata"])
        assert abs(first - time.time()) < 30
        assert life.tick(now=0.0)["states"][NODE] == READY
        _wait(lambda: jax_codec.annotation_to_heartbeat(
            api.get_node(NODE)["metadata"]) != first, what="a new heartbeat")
        # a moving heartbeat keeps the node ready however late the tick
        assert life.tick(now=100.0)["states"][NODE] == READY
    finally:
        assert agent.stop() == 0
    # a stopped agent's heartbeat stands still: the node ages to lost
    life.tick(now=200.0)
    assert life.tick(now=300.0)["states"][NODE] == LOST


def _hook_cli(endpoint, pod, config, *extra):
    return subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.cmd.cri_hook",
         *(("--server", endpoint) if endpoint else ()), "--pod", pod,
         "--container", "main", *extra],
        cwd=REPO, env=_env(), input=json.dumps(config), capture_output=True,
        text=True, timeout=60)


def _check_gang_config(cfg, inventory, port):
    env = {e["key"]: e["value"] for e in cfg["envs"]}
    uuids = env["CUDA_VISIBLE_DEVICES"].split(",")
    assert len(uuids) == 2 and env["NVIDIA_VISIBLE_DEVICES"] == \
        env["CUDA_VISIBLE_DEVICES"]
    minors = sorted(inventory.gpu(u).minor for u in uuids)
    paths = [d["host_path"] for d in cfg["devices"]]
    assert paths == ["/dev/null", *[f"/dev/nvidia{m}" for m in minors],
                     "/dev/nvidiactl", "/dev/nvidia-uvm"]
    assert (env["MASTER_ADDR"], env["MASTER_PORT"], env["WORLD_SIZE"],
            env["RANK"], env["LOCAL_RANK"], env["KEEP"]) == \
        ("127.0.0.1", str(port), "2", "1", "0", "1")
    assert not any(k.startswith("TPU_") for k in env)


GANG = {"gang": 3, "rank": 1, "count": 2, "coordinator_node": NODE,
        "coordinator_port": 29512}


@pytest.mark.parametrize("cri", ["unix", "tcp"])
def test_gang_pod_through_the_port_cri_hook(control_plane, tmp_path, cri):
    api, url = control_plane
    _registered(api)
    agent = Agent(url, tmp_path, cri=cri)
    try:
        _wait(lambda: _advertised(api), what="the first advertise")
        _placed(api, "gang", 2, gang=GANG)
        hook = _hook_cli(agent.endpoint, "gang", STALE)
        assert hook.returncode == 0, hook.stderr
        _check_gang_config(json.loads(hook.stdout), fake.hgx_h100_inventory(),
                           GANG["coordinator_port"])
    finally:
        assert agent.stop() == 0


def test_the_jax_agent_endpoint_shows_the_fault_this_repairs(control_plane,
                                                             tmp_path):
    """The JAX agent's CRI endpoint (the TPU hook over a DevicesManager
    with the port's GPU plugin) keeps the stale card node and hands a gang
    the TPU process contract: the fault the port's agent repairs."""
    api, _ = control_plane
    _registered(api)
    dm = JaxDevicesManager()
    dm.add_devices_from_plugins(DEVICE_PLUGINS)
    dm.devices[0].backend = fake.FakeGPUBackend(fake.hgx_h100_inventory())
    dm.start()
    JaxAdvertiser(api, dm, NODE, address="127.0.0.1").advertise_once()
    _placed(api, "gang", 2, gang=GANG)
    server = JaxCRIServer(TPURuntimeHook(api, dm),
                          unix_socket=str(tmp_path / "jax.sock"))
    server.start()
    try:
        cfg = jax_request(f"unix://{tmp_path / 'jax.sock'}", "gang", "main",
                          json.loads(json.dumps(STALE)))
    finally:
        server.stop()
    env = {e["key"]: e["value"] for e in cfg["envs"]}
    assert "/dev/nvidia9" in [d["host_path"] for d in cfg["devices"]]
    assert "MASTER_ADDR" not in env and env["TPU_PROCESS_COUNT"] == "2"
    assert len(env["CUDA_VISIBLE_DEVICES"].split(",")) == 2


def test_numgpu_mismatch_is_409_and_unknown_pod_404(control_plane, tmp_path):
    api, url = control_plane
    _registered(api)
    agent = Agent(url, tmp_path, cri="tcp")
    try:
        _wait(lambda: _advertised(api), what="the first advertise")
        pod = _placed(api, "short", 2)
        pi = codec.kube_pod_to_pod_info(pod, invalidate_existing=False)
        cont = pi.running_containers["main"]
        cont.allocate_from = dict(sorted(cont.allocate_from.items())[:1])
        meta = dict(pod["metadata"])
        codec.pod_info_to_annotation(meta, pi)
        pod["metadata"] = meta
        api.restore_object("pod", "modified", pod)
        hook = _hook_cli(agent.endpoint, "short", {})
        assert hook.returncode == 1 and hook.stdout == ""
        assert "AllocationMismatch" in hook.stderr and "409" in hook.stderr
        assert "requested 2 GPUs but annotation allocates 1" in hook.stderr
        with pytest.raises(AllocationMismatch):
            request_create_container(agent.endpoint, "short", "main", {})
        req = urllib.request.Request(
            f"{agent.endpoint}/v1/create-container", method="POST",
            data=json.dumps({"pod": "ghost", "container": "main"}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=10)
        assert err.value.code == 404
        assert "pod not found" in json.loads(err.value.read())["error"]
        err.value.close()
    finally:
        assert agent.stop() == 0


def _post(endpoint, path, body):
    req = urllib.request.Request(f"{endpoint}{path}", method="POST",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(endpoint, path):
    with urllib.request.urlopen(f"{endpoint}{path}", timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("code", [0, 3])
def test_launch_container_runs_the_pod_and_reports(control_plane, tmp_path,
                                                   code):
    api, url = control_plane
    _registered(api)
    agent = Agent(url, tmp_path, cri="tcp")
    try:
        _wait(lambda: _advertised(api), what="the first advertise")
        _placed(api, "job", 2, gang=GANG)
        script = ("import os, sys; print(os.environ['CUDA_VISIBLE_DEVICES'],"
                  " os.environ['WORLD_SIZE'], os.environ['RANK'], flush=True);"
                  f" sys.exit({code})")
        got = _post(agent.endpoint, "/v1/launch-container", {
            "pod": "job", "container": "main", "config": STALE,
            "command": [sys.executable, "-c", script]})
        cid = got["id"]
        status = _wait(lambda: (lambda s: s if s["state"] == "exited"
                                else None)(_get(
                                    agent.endpoint,
                                    f"/v1/container-status?id={cid}")),
                       what="the pod's exit")
        assert status["exit_code"] == code
        assert status["devices"][0] == "/dev/null"
        env = {e["key"]: e["value"] for e in got["config"]["envs"]}
        logs = _get(agent.endpoint, f"/v1/container-logs?id={cid}")["logs"]
        assert logs.split() == [env["CUDA_VISIBLE_DEVICES"], "2", "1"]
        reported = _wait(lambda: json.loads(
            api.get_pod("job")["metadata"]["annotations"].get(
                STATUS_ANNOTATION_KEY) or "{}").get("main", {}).get(
                    "exit_code") is not None and api.get_pod("job"),
            what="the status annotation")
        status_ann = json.loads(reported["metadata"]["annotations"][
            STATUS_ANNOTATION_KEY])["main"]
        assert (status_ann["state"], status_ann["exit_code"]) == \
            ("exited", code)
        # the placement survives the status write
        assert codec.POD_ANNOTATION_KEY in reported["metadata"]["annotations"]
        assert [c["id"] for c in _get(agent.endpoint,
                                      "/v1/containers")["containers"]] == [cid]
        assert _post(agent.endpoint, "/v1/remove-container",
                     {"id": cid}) == {"removed": cid}
    finally:
        assert agent.stop() == 0


def test_standalone_cri_hook_matches_the_served_one(control_plane, tmp_path):
    api, url = control_plane
    _registered(api)
    agent = Agent(url, tmp_path, cri="unix")
    try:
        _wait(lambda: _advertised(api), what="the first advertise")
        _placed(api, "gang", 2, gang=GANG)
        served = _hook_cli(agent.endpoint, "gang", STALE)
    finally:
        assert agent.stop() == 0
    alone = _hook_cli(None, "gang", STALE, "--api", url, "--backend",
                      "fake-hgx")
    assert served.returncode == 0 and alone.returncode == 0, alone.stderr
    assert json.loads(alone.stdout) == json.loads(served.stdout)


def test_sigterm_stops_the_agent_cleanly(control_plane, tmp_path):
    api, url = control_plane
    _registered(api)
    agent = Agent(url, tmp_path, cri="unix")
    _wait(lambda: _advertised(api), what="the first advertise")
    t = time.monotonic()
    assert agent.stop(timeout=10.0) == 0
    assert time.monotonic() - t < 10.0
    assert not (tmp_path / "gpu.sock").exists()


def test_nvml_backend_never_falls_back_to_a_fake(tmp_path):
    """Without a loadable libnvidia-ml (this host, or any host without the
    driver), ``--backend nvml`` raises instead of advertising a fake."""
    if os.path.exists("/dev/nvidiactl"):
        pytest.skip("this host has the NVIDIA driver")
    with pytest.raises(RuntimeError, match="NVML cannot load"):
        build_manager("nvml")
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "kubegpu_tpu_torch.cmd.node_agent", "--api",
             url, "--node-name", NODE, "--register-node"],
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    finally:
        server.shutdown()
    assert proc.returncode != 0 and "NVML cannot load" in proc.stderr


def test_devices_manager_fans_out_over_the_plugin_directory():
    mgr = DevicesManager()
    assert mgr.add_devices_from_plugins(DEVICE_PLUGINS) == 1
    gpu = mgr.devices[0]
    assert isinstance(gpu, GPUDeviceManager)
    gpu.backend = fake.FakeGPUBackend(fake.pcie_h100_inventory())
    gpu.backend.set_chip_health(fake.fake_uuid(0, 3), "failed")
    mgr.start()
    assert mgr.operational == {"nvidiagpu": True}
    assert mgr.chip_health() == {fake.fake_uuid(0, 3): "failed"}
    assert mgr.link_health() == {}
    pod = codec.kube_pod_to_pod_info(gpu_pod("p", 1), False)
    cont = pod.running_containers["main"]
    cont.allocate_from = {"x": f"gpugrp1/0/gpugrp0/1/gpu/{fake.fake_uuid(0, 2)}/cards"}
    assert mgr.allocate_devices(pod, cont) == gpu.allocate(pod, cont)
    assert mgr.allocate_devices(pod, cont)[2]["CUDA_VISIBLE_DEVICES"] == \
        fake.fake_uuid(0, 2)
    # a directory that is not there registers nothing
    assert DevicesManager().add_devices_from_plugins("/nonexistent") == 0


def test_advertiser_health_follows_the_advertise_loop():
    api = InMemoryAPIServer()
    mgr, _ = build_manager("fake-rig")
    adv = DeviceAdvertiser(api, mgr, NODE)
    assert not adv.healthy()              # never advertised
    with pytest.raises(KeyError):
        adv.advertise_once()              # no node object yet
    _registered(api)
    adv.advertise_once()
    now = adv.last_success_monotonic
    assert adv.healthy(now + 1.0)
    assert not adv.healthy(now + adv._interval_s + adv._retry_s + 1.0)


def test_config_file_fills_unset_flags(tmp_path):
    path = tmp_path / "agent.json"
    path.write_text(json.dumps({"backend": "fake-pcie", "api": "http://x"}))

    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", default="nvml")
    parser.add_argument("--api", default="http://127.0.0.1:8070")
    # a flag given on the command line wins, even at its default value
    for argv, api in ((["--api", "http://given"], "http://given"),
                      (["--api", "http://127.0.0.1:8070"],
                       "http://127.0.0.1:8070")):
        args = parser.parse_args(argv)
        common.merge_flags(parser, argv, args, common.load_config(str(path)),
                           ["backend", "api"])
        assert (args.backend, args.api) == ("fake-pcie", api)
    args = parser.parse_args([])
    common.merge_flags(parser, [], args, common.load_config(str(path)),
                       ["backend"])
    assert (args.backend, args.api) == ("fake-pcie", "http://127.0.0.1:8070")
    assert parser.parse_args([]).backend == "nvml"
    path.write_text("[1, 2]")
    with pytest.raises(ValueError, match="must be a mapping"):
        common.load_config(str(path))
