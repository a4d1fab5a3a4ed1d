"""What the benchmark loads, checked in a fresh interpreter by whole
top-level module names (``kubegpu_tpu_torch`` is not ``kubegpu_tpu``)."""

import json
import subprocess
import sys

from perfbench.harness.spec import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in list(sys.modules)}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded(
        "from perfbench.harness import runner, spec\n"
        "import perfbench.reference\n"
        "import kubegpu_tpu_torch.workload.train\n"
        "import kubegpu_tpu_torch.workload.serve\n"
        "import kubegpu_tpu_torch.workload.data\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    spec.load_reader(m['name'])\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('pb_run', 'perfbench/run.py')\n"
        "s.loader.exec_module(u.module_from_spec(s))\n")
    assert "kubegpu_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "kubegpu_tpu"}


def test_reference_loads_no_program():
    mods = loaded("import perfbench.reference\n"
                  "import perfbench.harness.weights\n")
    assert not mods & {"jax", "jaxlib", "flax", "kubegpu_tpu",
                       "kubegpu_tpu_torch"}


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mistral7b-chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
