"""The GPU resource-name grammar, as the reference defines it.

The reference's NVIDIA plugin (`nvidia_gpu_manager.go:104-106,216-219`,
`gpuplugintypes/types.go:7`, `gpu_scheduler.go:13-16`) names its
resources so:

- Group resources live under ``alpha/grpresource/<path>``.
- Card leaves::

      alpha/grpresource/gpugrp1/<i>/gpugrp0/<j>/gpu/<UUID>/cards  = 1
      alpha/grpresource/gpugrp1/<i>/gpugrp0/<j>/gpu/<UUID>/memory = bytes

  ``gpugrp0`` groups cards whose pairs are joined by NVLink or at most a
  PCIe switch tree (P2P link codes 6, 5, 4); ``gpugrp1`` groups cards
  that reach each other at all (codes 6 to 1), the host. The id is the
  card's UUID (``GPU-...``): it holds no coordinates.

- Any leaf segment starting with ``enum`` is a bitmask resource matched by
  the enum scorer (`resource/resourcetranslate.go:20-27`).

Pod-level knobs (in the pod annotation's ``requests``):

- ``alpha.gpu/numgpu``: flat card count, translated into per-card group
  requests.
- ``alpha.gpu/memory-per-gpu``: optional minimum device memory in bytes
  per requested card (the JAX package's ``alpha.tpu/hbm-per-chip``).
- ``alpha.gpu/gpu-generate-topology``: 0 = translate requests as-is;
  1 = rewrite to the best-shaped inventory tree in the cluster.
- ``alpha.tpu/gang`` and ``alpha.tpu/gang-size``: the gang id and member
  count of a pod-set placed all-or-nothing. The keys are the JAX
  package's (``kubegpu_tpu/scheduler/gang.py``), so both engines read one
  wire.

Any other ``alpha.tpu/`` knob asks for TPU chips, which no plugin of the
port serves.
"""

from __future__ import annotations

import re

from kubegpu_tpu_torch.core.types import DEVICE_GROUP_PREFIX

# ---- leaf vocabulary -------------------------------------------------------

GPU_LEAF = "gpu"            # the device level
CARDS_SUFFIX = "cards"      # 1 per card
MEMORY_SUFFIX = "memory"    # bytes of device memory

# ---- topology levels (innermost -> outermost) ------------------------------

GPU_GRP_STEM = "gpugrp"          # level names are <stem><level-number>
GPU_GRP0 = f"{GPU_GRP_STEM}0"    # NVLink / PCIe-switch neighbourhood
GPU_GRP1 = f"{GPU_GRP_STEM}1"    # every card that reaches the others: the host

# ---- pod-level request names ----------------------------------------------

RESOURCE_NUM_GPU = "alpha.gpu/numgpu"
RESOURCE_MEMORY_PER_GPU = "alpha.gpu/memory-per-gpu"
GPU_TOPOLOGY_GENERATION = "alpha.gpu/gpu-generate-topology"
RESOURCE_GANG = "alpha.tpu/gang"
RESOURCE_GANG_SIZE = "alpha.tpu/gang-size"
TPU_REQUEST_PREFIX = "alpha.tpu/"

_ENUM_RE = re.compile(r"\S*/(\S*)")
_GPU_FROM_PATH_RE = re.compile(rf".*/{GPU_LEAF}/([^/]+)/{CARDS_SUFFIX}$")


def is_group_resource(name: str) -> bool:
    """True if the name is handled by the group allocator.

    Reference: `resource/resourcetranslate.go:15-17`.
    """
    return name.startswith(DEVICE_GROUP_PREFIX)


def prechecked_resource(name: str) -> bool:
    """Resources outside the group prefix are the core scheduler's problem.

    Reference: `resource/resourcetranslate.go:97-99`.
    """
    return not is_group_resource(name)


def is_enum_resource(name: str) -> bool:
    """Leaf segments starting with ``enum`` are bitmask-typed.

    Reference: `resource/resourcetranslate.go:20-27`.
    """
    m = _ENUM_RE.match(name)
    if m:
        return m.group(1).lower().startswith("enum")
    return False


def gpu_resource(uuid: str, suffix: str, *levels: tuple) -> str:
    """Build a full group-resource path for one card attribute.

    ``levels`` are (level_name, index) pairs, outermost first, e.g.
    ``gpu_resource("GPU-1", "cards", ("gpugrp1", 0), ("gpugrp0", 1))`` ->
    ``alpha/grpresource/gpugrp1/0/gpugrp0/1/gpu/GPU-1/cards``.
    """
    parts = [DEVICE_GROUP_PREFIX]
    for name, idx in levels:
        parts.append(f"{name}/{idx}")
    parts.append(f"{GPU_LEAF}/{uuid}/{suffix}")
    return "/".join(parts)


def gpu_id_from_path(path: str) -> str | None:
    """The UUID of a ``.../gpu/<UUID>/cards`` path, or None.

    The device manager turns ``allocate_from`` values into
    ``CUDA_VISIBLE_DEVICES`` through this (the reference's UUID regex,
    `nvidia_gpu_manager.go:238-253`).
    """
    m = _GPU_FROM_PATH_RE.match(path)
    return m.group(1) if m else None


def gpu_prefix_from_path(path: str) -> str | None:
    """The ``.../gpu/<UUID>`` prefix of a cards-leaf path, or None: with
    the node's name it identifies one physical card."""
    if gpu_id_from_path(path) is None:
        return None
    return path[: path.rfind("/")]
