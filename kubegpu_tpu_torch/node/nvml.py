"""NVIDIA GPU discovery through NVIDIA's NVML library.

`NVMLBackend` reads ``libnvidia-ml.so.1`` through ``ctypes``: ``nvmlInit_v2``,
then per device its handle, UUID, minor number, memory and PCI bus id,
then per pair the topology common ancestor and the NVLink P2P status, then
``nvmlShutdown``. It raises when NVML cannot load or initialise; there is
no other source of truth (not ``nvidia-smi``), and the device manager then
advertises zero cards.

The pure part, which the CPU tests reach, turns each pair's (level,
NVLink) into the reference's P2P link code (`link_code`) and groups the
cards by those codes (`group_cards`), as the reference's two-pass
topology discovery does (`nvidia_gpu_manager.go:93-121,171-193`).

Every constant and struct layout below is taken from ``nvml.h`` of the
CUDA 12.9 toolkit (``NVML_API_VERSION 12``, line 100); each cites its
line there.
"""

from __future__ import annotations

import ctypes

from kubegpu_tpu_torch.node.backend import GPUBackend, GPUInfo, GPUInventory

# ---- nvml.h constants --------------------------------------------------------

NVML_SUCCESS = 0                     # nvml.h:1198 (nvmlReturn_t)
NVML_ERROR_NOT_SUPPORTED = 3         # nvml.h:1201

# nvmlGpuTopologyLevel_t (nvml.h:478-488)
NVML_TOPOLOGY_INTERNAL = 0           # nvml.h:480, e.g. the two GPUs of a K80
NVML_TOPOLOGY_SINGLE = 10            # nvml.h:481, one PCIe switch
NVML_TOPOLOGY_MULTIPLE = 20          # nvml.h:482, several switches, no host bridge
NVML_TOPOLOGY_HOSTBRIDGE = 30        # nvml.h:483, the same host bridge
NVML_TOPOLOGY_NODE = 40              # nvml.h:484, the same NUMA node (was _CPU)
NVML_TOPOLOGY_SYSTEM = 50            # nvml.h:485, across sockets

NVML_P2P_STATUS_OK = 0               # nvml.h:496 (nvmlGpuP2PStatus_t)
NVML_P2P_CAPS_INDEX_NVLINK = 2       # nvml.h:512 (nvmlGpuP2PCapsIndex_t)

NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE = 32      # nvml.h:154
NVML_DEVICE_PCI_BUS_ID_BUFFER_V2_SIZE = 16   # nvml.h:159
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96         # nvml.h:3651


class NvmlPciInfo(ctypes.Structure):
    """``nvmlPciInfo_t``, nvml.h:185-197, as ``nvmlDeviceGetPciInfo_v3``
    fills it."""

    _fields_ = [
        ("busIdLegacy", ctypes.c_char * NVML_DEVICE_PCI_BUS_ID_BUFFER_V2_SIZE),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE),
    ]


class NvmlMemory(ctypes.Structure):
    """``nvmlMemory_t``, nvml.h:244-250 (v1, what
    ``nvmlDeviceGetMemoryInfo`` fills)."""

    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


# ---- the reference's P2P link codes ----------------------------------------
# The reference groups cards by nvidia-docker's P2PLinkType, an ordinal of
# closeness (`nvidia_gpu_manager.go:171-189`): 0 unknown, then 1 across
# sockets up to 6 on the same board.

P2P_LINK_UNKNOWN = 0
P2P_LINK_CROSS_CPU = 1
P2P_LINK_SAME_CPU = 2
P2P_LINK_HOST_BRIDGE = 3
P2P_LINK_MULTI_SWITCH = 4
P2P_LINK_SINGLE_SWITCH = 5
P2P_LINK_SAME_BOARD = 6

# NVML's common-ancestor level -> link code, the reference's level table
_LEVEL_TO_CODE = {
    NVML_TOPOLOGY_INTERNAL: P2P_LINK_SAME_BOARD,
    NVML_TOPOLOGY_SINGLE: P2P_LINK_SINGLE_SWITCH,
    NVML_TOPOLOGY_MULTIPLE: P2P_LINK_MULTI_SWITCH,
    NVML_TOPOLOGY_HOSTBRIDGE: P2P_LINK_HOST_BRIDGE,
    NVML_TOPOLOGY_NODE: P2P_LINK_SAME_CPU,
    NVML_TOPOLOGY_SYSTEM: P2P_LINK_CROSS_CPU,
}

# The reference's two passes: gpugrp0 joins pairs at codes 6, 5 or 4 (no
# host bridge between them), gpugrp1 at any known code.
GRP0_CODES = frozenset({P2P_LINK_SAME_BOARD, P2P_LINK_SINGLE_SWITCH,
                        P2P_LINK_MULTI_SWITCH})
GRP1_CODES = frozenset(range(P2P_LINK_CROSS_CPU, P2P_LINK_SAME_BOARD + 1))


def link_code(level: int | None, nvlink: bool) -> int:
    """One pair's link code. A pair joined by NVLink takes the tightest
    code, whatever PCIe path lies between the cards: NVLink groups are the
    constraint the scheduler exists to honour. ``level`` None (NVML
    does not report it) or unknown gives ``P2P_LINK_UNKNOWN``."""
    if nvlink:
        return P2P_LINK_SAME_BOARD
    return _LEVEL_TO_CODE.get(level, P2P_LINK_UNKNOWN)


def _components(links: list, codes: frozenset) -> list:
    """Connected components of the cards whose pairs have a code in
    ``codes``."""
    n = len(links)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if links[i][j] in codes or links[j][i] in codes:
                parent[find(i)] = find(j)
    comps: dict = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return list(comps.values())


def group_cards(links: list, order: list) -> list:
    """``(gpugrp1, gpugrp0)`` indices of each card.

    ``links`` is the matrix of link codes, ``order`` a sort key per card
    (`card_order`). Groups are the connected components at each pass;
    since GRP0_CODES lies inside GRP1_CODES, every gpugrp0 lies inside one
    gpugrp1. Indices of each level count groups in the order of their
    lowest key, so they do not depend on the order NVML listed the cards.
    """
    out = [[0, 0] for _ in links]
    for pos, codes in ((0, GRP1_CODES), (1, GRP0_CODES)):
        comps = sorted(_components(links, codes),
                       key=lambda c: min(order[i] for i in c))
        for g, comp in enumerate(comps):
            for i in comp:
                out[i][pos] = g
    return [tuple(x) for x in out]


def card_order(gpu: GPUInfo) -> tuple:
    """Sort key of a card: its PCI bus id, then NVML's index (which
    follows PCI bus order) where NVML does not report the id."""
    return (gpu.pci_bus_id is None, gpu.pci_bus_id or "", gpu.index)


def inventory_from_reads(cards: list, pairs: dict) -> GPUInventory:
    """Build the inventory from NVML's raw reads: ``cards`` as
    (index, uuid, minor, memory bytes, PCI bus id or None) in NVML order,
    ``pairs[(i, j)]`` = (common-ancestor level or None, NVLink P2P ok) for
    i < j."""
    gpus = [GPUInfo(index=i, uuid=u, minor=m, memory_bytes=mem, pci_bus_id=bus)
            for i, u, m, mem, bus in cards]
    n = len(gpus)
    links = [[P2P_LINK_UNKNOWN] * n for _ in range(n)]
    for (i, j), (level, nvlink) in pairs.items():
        links[i][j] = links[j][i] = link_code(level, nvlink)
    return GPUInventory(gpus=gpus, links=links)


# ---- the ctypes calls --------------------------------------------------------


class NVMLError(RuntimeError):
    """An NVML call returned an error (``code``, nvml.h:1195-1230)."""

    def __init__(self, call: str, code: int, text: str = ""):
        self.call, self.code = call, code
        super().__init__(f"{call} failed: NVML error {code} {text}".rstrip())


def _bind(lib) -> None:
    """Declare the signatures used here (nvml.h lines as cited)."""
    dev = ctypes.c_void_p                     # nvmlDevice_t, nvml.h:147
    uint_p = ctypes.POINTER(ctypes.c_uint)
    sigs = {
        "nvmlInit_v2": [],                                        # :3573
        "nvmlShutdown": [],                                       # :3607
        "nvmlDeviceGetCount_v2": [uint_p],                        # :4063
        "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint,
                                          ctypes.POINTER(dev)],   # :4131
        "nvmlDeviceGetTopologyCommonAncestor": [
            dev, dev, ctypes.POINTER(ctypes.c_int)],              # :4553
        "nvmlDeviceGetP2PStatus": [dev, dev, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)],  # :4588
        "nvmlDeviceGetUUID": [dev, ctypes.c_char_p, ctypes.c_uint],  # :4616
        "nvmlDeviceGetMinorNumber": [dev, uint_p],                # :4635
        "nvmlDeviceGetPciInfo_v3": [dev, ctypes.POINTER(NvmlPciInfo)],  # :4884
        "nvmlDeviceGetMemoryInfo": [dev, ctypes.POINTER(NvmlMemory)],   # :6110
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int             # nvmlReturn_t
    lib.nvmlErrorString.argtypes = [ctypes.c_int]   # :3628
    lib.nvmlErrorString.restype = ctypes.c_char_p


class NVMLBackend(GPUBackend):
    """Discovery over NVML. Each `enumerate` initialises
    NVML, reads every card and pair, and shuts NVML down again."""

    def __init__(self, library: str = "libnvidia-ml.so.1"):
        self.library = library

    def _load(self):
        try:
            lib = ctypes.CDLL(self.library)
        except OSError as e:
            raise RuntimeError(f"NVML cannot load ({self.library}): {e}") from e
        _bind(lib)
        return lib

    @staticmethod
    def _check(lib, call: str, code: int, optional: bool = False) -> bool:
        """True on success; False for ``NVML_ERROR_NOT_SUPPORTED`` where the
        field is ``optional`` (NVML withholds it, as ``nvidia-smi``
        then prints N/A); raises on any other code."""
        if code == NVML_SUCCESS:
            return True
        if optional and code == NVML_ERROR_NOT_SUPPORTED:
            return False
        raise NVMLError(call, code, (lib.nvmlErrorString(code) or b"").decode())

    def enumerate(self) -> GPUInventory:
        lib = self._load()
        self._check(lib, "nvmlInit_v2", lib.nvmlInit_v2())
        try:
            cards, pairs = self._read(lib)
        finally:
            lib.nvmlShutdown()
        return inventory_from_reads(cards, pairs)

    def _read(self, lib) -> tuple:
        count = ctypes.c_uint()
        self._check(lib, "nvmlDeviceGetCount_v2",
                    lib.nvmlDeviceGetCount_v2(ctypes.byref(count)))
        handles, cards = [], []
        for i in range(count.value):
            h = ctypes.c_void_p()
            self._check(lib, "nvmlDeviceGetHandleByIndex_v2",
                        lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)))
            uuid = ctypes.create_string_buffer(NVML_DEVICE_UUID_V2_BUFFER_SIZE)
            self._check(lib, "nvmlDeviceGetUUID", lib.nvmlDeviceGetUUID(
                h, uuid, NVML_DEVICE_UUID_V2_BUFFER_SIZE))
            minor = ctypes.c_uint()
            self._check(lib, "nvmlDeviceGetMinorNumber",
                        lib.nvmlDeviceGetMinorNumber(h, ctypes.byref(minor)))
            mem = NvmlMemory()
            self._check(lib, "nvmlDeviceGetMemoryInfo",
                        lib.nvmlDeviceGetMemoryInfo(h, ctypes.byref(mem)))
            pci = NvmlPciInfo()
            bus = None
            if self._check(lib, "nvmlDeviceGetPciInfo_v3",
                           lib.nvmlDeviceGetPciInfo_v3(h, ctypes.byref(pci)),
                           optional=True):
                bus = pci.busId.decode()
            handles.append(h)
            cards.append((i, uuid.value.decode(), minor.value, mem.total, bus))
        pairs = {}
        for i in range(len(handles)):
            for j in range(i + 1, len(handles)):
                level = ctypes.c_int()
                known = self._check(
                    lib, "nvmlDeviceGetTopologyCommonAncestor",
                    lib.nvmlDeviceGetTopologyCommonAncestor(
                        handles[i], handles[j], ctypes.byref(level)),
                    optional=True)
                status = ctypes.c_int()
                nvlink = self._check(
                    lib, "nvmlDeviceGetP2PStatus",
                    lib.nvmlDeviceGetP2PStatus(
                        handles[i], handles[j], NVML_P2P_CAPS_INDEX_NVLINK,
                        ctypes.byref(status)),
                    optional=True) and status.value == NVML_P2P_STATUS_OK
                pairs[(i, j)] = (level.value if known else None, nvlink)
        return cards, pairs
