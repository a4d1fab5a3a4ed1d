"""The port's group allocator against the JAX package's, on the scenario
table of tests/test_grpalloc.py (the reference's
`devicescheduler_test.go` table) in the GPU grammar: flat, 2-level and
3-level trees, count-only requests, init against running containers, and
the 4+2 split across gpugrp1 groups.

Each scenario runs through the JAX allocator's default path, its Python
path (`_pod_fits_group_constraints_py`), the port's default path (its
native core), the port's Python path, and the port's default path over
the JAX package's own NodeInfo/PodInfo (the objects the JAX control plane
hands a plugin): equal fit, equal `allocate_from`, scores
within 1e-9, the same idempotent re-check, and take/return that drains
`used` to zero in both packages."""

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.allocator import grpalloc as jalloc  # noqa: E402
from kubegpu_tpu.allocator.translate import \
    translate_resource as jtranslate  # noqa: E402
from kubegpu_tpu.core import types as jtypes  # noqa: E402
from kubegpu_tpu_torch.allocator import grpalloc as talloc  # noqa: E402
from kubegpu_tpu_torch.allocator.translate import \
    translate_resource as ttranslate  # noqa: E402
from kubegpu_tpu_torch.core import types as ttypes  # noqa: E402

G = "alpha/grpresource"
CORE = {"A1": 4000, "B1": 3000}

FLAT_ENUM = {
    "gpu/dev0/memory": 100000, "gpu/dev0/cards": 1,
    "gpu/dev1/memory": 256000, "gpu/dev1/cards": 1, "gpu/dev1/enumType": 0x1,
    "gpu/dev2/memory": 257000, "gpu/dev2/cards": 1,
    "gpu/dev3/memory": 192000, "gpu/dev3/cards": 1, "gpu/dev3/enumType": 0x1,
    "gpu/dev4/memory": 178000, "gpu/dev4/cards": 1,
}
FLAT = {k: v for k, v in FLAT_ENUM.items() if "enum" not in k}
TWO_LEVEL = {
    "gpugrp0/group0/gpu/dev0/memory": 100000, "gpugrp0/group0/gpu/dev0/cards": 1,
    "gpugrp0/group0/gpu/dev1/memory": 256000, "gpugrp0/group0/gpu/dev1/cards": 1,
    "gpugrp0/group1/gpu/dev2/memory": 257000, "gpugrp0/group1/gpu/dev2/cards": 1,
    "gpugrp0/group2/gpu/dev3/memory": 192000, "gpugrp0/group2/gpu/dev3/cards": 1,
    "gpugrp0/group2/gpu/dev4/memory": 178000, "gpugrp0/group2/gpu/dev4/cards": 1,
}
_MEM = (100000, 256000, 257000, 192000, 178000, 100000, 256000, 257000)
THREE_LEVEL = {}
for _d, _mem in enumerate(_MEM):
    _base = f"gpugrp1/{_d // 4}/gpugrp0/{_d // 2}/gpu/dev{_d}"
    THREE_LEVEL[f"{_base}/memory"] = _mem
    THREE_LEVEL[f"{_base}/cards"] = 1

# name -> (node group resources, init containers, running containers);
# a container is (group requests, core requests)
SCENARIOS = {
    "flat_mixed_with_enum": (FLAT_ENUM, {
        "Init0": ({"gpu/0/memory": 100000, "gpu/0/cards": 1},
                  {"A1": 2200, "B1": 2000})}, {
        "Run0": ({"gpu/a/memory": 256000, "gpu/a/cards": 1,
                  "gpu/b/memory": 178000, "gpu/b/cards": 1},
                 {"A1": 3000, "B1": 1000}),
        "Run1": ({"gpu/0/memory": 190000, "gpu/0/cards": 1,
                  "gpu/0/enumType": 0x3}, {"A1": 1000, "B1": 2000})}),
    "flat_init_larger_than_running": (FLAT_ENUM, {
        "Init0": ({"gpu/0/memory": 257000, "gpu/0/cards": 1}, {})}, {
        "Run0": ({"gpu/a/memory": 256000, "gpu/a/cards": 1,
                  "gpu/b/memory": 178000, "gpu/b/cards": 1}, {}),
        "Run1": ({"gpu/0/memory": 190000, "gpu/0/cards": 1,
                  "gpu/0/enumType": 0x3}, {})}),
    "flat_count_only": (FLAT, {"Init0": ({"gpu/0/cards": 1}, {})}, {
        "Run0": ({"gpu/0/cards": 1, "gpu/1/cards": 1}, {}),
        "Run1": ({"gpu/0/cards": 1}, {})}),
    "two_level_affinity_groups": (TWO_LEVEL, {
        "Init0": ({"gpu/0/memory": 100000, "gpu/0/cards": 1}, {})}, {
        "Run0": ({"gpugrp0/A/gpu/a/memory": 190000, "gpugrp0/A/gpu/a/cards": 1,
                  "gpugrp0/A/gpu/b/memory": 178000, "gpugrp0/A/gpu/b/cards": 1},
                 {}),
        "Run1": ({"gpu/0/memory": 256000, "gpu/0/cards": 1}, {}),
        "Run2": ({"gpu/0/memory": 256000, "gpu/0/cards": 1,
                  "gpu/1/memory": 100000, "gpu/1/cards": 1}, {})}),
    "three_level_pair_in_one_group": (THREE_LEVEL, {}, {
        "Run0": ({"gpugrp0/A/gpu/a/cards": 1, "gpugrp0/A/gpu/b/cards": 1},
                 {})}),
    "three_level_split_4_plus_2": (THREE_LEVEL, {}, {
        "Run0": ({"gpugrp1/0/gpugrp0/A/gpu/a/cards": 1,
                  "gpugrp1/0/gpugrp0/B/gpu/b/cards": 1,
                  "gpugrp1/0/gpugrp0/C/gpu/c/cards": 1,
                  "gpugrp1/0/gpugrp0/D/gpu/d/cards": 1,
                  "gpugrp0/A/gpu/a/cards": 1,
                  "gpugrp0/A/gpu/b/cards": 1}, {})}),
    "three_level_count_only_init_and_running": (THREE_LEVEL, {
        "Init0": ({f"gpu/{i}/cards": 1 for i in range(2)}, {})}, {
        "Run0": ({f"gpu/{i}/cards": 1 for i in range(2)}, {}),
        "Run1": ({"gpu/0/cards": 1}, {})}),
    # 6 running cards and a 3-card init container on 8: no fit, and the
    # containers placed before the failure keep their placements
    "three_level_count_only_no_fit": (THREE_LEVEL, {
        "Init0": ({f"gpu/{i}/cards": 1 for i in range(3)}, {})}, {
        "Run0": ({f"gpu/{i}/cards": 1 for i in range(2)}, {}),
        "Run1": ({f"gpu/{i}/cards": 1 for i in range(4)}, {})}),
    "unsatisfiable_memory": ({"gpu/dev0/memory": 100, "gpu/dev0/cards": 1},
                             {}, {"Run0": ({"gpu/0/memory": 500,
                                            "gpu/0/cards": 1}, {})}),
    "more_cards_than_available": ({"gpu/dev0/cards": 1, "gpu/dev1/cards": 1},
                                  {}, {"Run0": ({f"gpu/{i}/cards": 1
                                                 for i in range(3)}, {})}),
    "requestless_sidecar": ({"gpu/dev0/cards": 1, "gpu/dev1/cards": 1}, {}, {
        "Run0": ({"gpu/0/cards": 1}, {}), "Run1": ({}, {})}),
}


def _node(types, grpres, name="node1"):
    alloc = dict(CORE)
    alloc.update({f"{G}/{k}": v for k, v in grpres.items()})
    return types.NodeInfo(name=name, capacity=dict(alloc),
                          allocatable=dict(alloc))


def _pod(types, name, inits, runs):
    def cont(grp, core):
        reqs = dict(core)
        reqs.update({f"{G}/{k}": v for k, v in grp.items()})
        return types.ContainerInfo(requests=dict(reqs), dev_requests=dict(reqs),
                                   kube_requests=dict(core))
    pod = types.PodInfo(name=name)
    pod.init_containers = {n: cont(*c) for n, c in inits.items()}
    pod.running_containers = {n: cont(*c) for n, c in runs.items()}
    return pod


def _translate(translate, node, pod):
    for _, cont, _ in pod.all_containers():
        for this_stage, next_stage in (("gpugrp0", "gpu"), ("gpugrp1", "gpugrp0")):
            _, cont.dev_requests = translate(
                node.allocatable, cont.dev_requests, this_stage, next_stage)


# (types of the objects, translate, fit, module for take/return)
ROUTES = {
    "jax_default": (jtypes, jtranslate, jalloc.pod_fits_group_constraints, jalloc),
    "jax_python": (jtypes, jtranslate, jalloc._pod_fits_group_constraints_py, jalloc),
    "port": (ttypes, ttranslate, talloc.pod_fits_group_constraints, talloc),
    "port_python": (ttypes, ttranslate,
                    talloc._pod_fits_group_constraints_py, talloc),
    "port_on_jax_objects": (jtypes, jtranslate,
                            talloc.pod_fits_group_constraints, talloc),
}


def _run(route, grpres, inits, runs):
    types, translate, fit, mod = ROUTES[route]
    node = _node(types, grpres)
    pod = _pod(types, "p", inits, runs)
    _translate(translate, node, pod)
    fits, reasons, score = fit(node, pod, True)
    placed = {n: dict(c.allocate_from) for n, c, _ in pod.all_containers()}
    out = {"fits": fits, "score": score, "placed": placed,
           "dev_requests": {n: dict(c.dev_requests)
                            for n, c, _ in pod.all_containers()},
           "reasons": sorted(str(r) for r in reasons)}
    if fits:
        fits2, _, score2 = fit(node, pod, True)
        out["recheck"] = (fits2, score2)
        mod.take_pod_group_resource(node, pod)
        out["used"] = {k: v for k, v in node.used.items() if v}
        mod.return_pod_group_resource(node, pod)
        out["drained"] = all(v == 0 for v in node.used.values())
    return out


@pytest.mark.parametrize("route", ["jax_default", "port", "port_python",
                                   "port_on_jax_objects"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_parity(scenario, route):
    ref = _run("jax_python", *SCENARIOS[scenario])
    got = _run(route, *SCENARIOS[scenario])
    assert got["fits"] == ref["fits"]
    assert got["placed"] == ref["placed"]
    assert got["dev_requests"] == ref["dev_requests"]
    assert abs(got["score"] - ref["score"]) <= 1e-9
    if ref["fits"]:
        assert got["recheck"][0] and abs(got["recheck"][1] - ref["recheck"][1]) <= 1e-9
        assert got["used"] == ref["used"] and got["used"]
        assert got["drained"] and ref["drained"]
    elif route != "jax_default":    # the native core words its own reasons
        assert got["reasons"] == ref["reasons"]


@pytest.mark.parametrize("grpres", ["THREE_LEVEL", "TWO_LEVEL", "FLAT"])
def test_sequential_pods_and_release_parity(grpres):
    """Two-card pods placed one after another on one node until one does
    not fit, then released: equal placements and usage at every step, and
    the node drains to zero in both packages."""
    inv = globals()[grpres]
    state = {}
    for route in ("jax_python", "port"):
        types, translate, fit, mod = ROUTES[route]
        node = _node(types, inv)
        pods, steps = [], []
        for i in range(6):
            pod = _pod(types, f"p{i}", {"init": ({"gpu/0/cards": 1}, {})},
                       {"main": ({"gpu/0/cards": 1, "gpu/1/cards": 1}, {})})
            _translate(translate, node, pod)
            fits, _, score = fit(node, pod, True)
            steps.append((fits, round(score, 12),
                          pod.running_containers["main"].allocate_from))
            if not fits:
                break
            mod.take_pod_group_resource(node, pod)
            pods.append(pod)
            steps.append({k: v for k, v in node.used.items() if v})
        for pod in pods:
            mod.return_pod_group_resource(node, pod)
        assert all(v == 0 for v in node.used.values())
        state[route] = steps
    assert state["port"] == state["jax_python"]
    assert not state["port"][-1][0]          # the node filled up


def test_clear_allocate_from_replaces_identically():
    results = []
    for types, mod in ((jtypes, jalloc), (ttypes, talloc)):
        node = _node(types, THREE_LEVEL)
        pod = _pod(types, "p", {}, {"main": ({"gpu/0/cards": 1}, {})})
        fit = jalloc._pod_fits_group_constraints_py if mod is jalloc \
            else talloc.pod_fits_group_constraints
        fit(node, pod, True)
        before = dict(pod.running_containers["main"].allocate_from)
        mod.pod_clear_allocate_from(pod)
        assert pod.running_containers["main"].allocate_from == {}
        fit(node, pod, True)
        assert pod.running_containers["main"].allocate_from == before
        results.append(before)
    assert results[0] == results[1]
