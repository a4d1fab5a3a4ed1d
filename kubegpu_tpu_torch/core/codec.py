"""Annotation codec: node/pod annotations <-> the device side's types.

The port's copy of the JSON path of ``kubegpu_tpu/core/codec.py``: the
node advertises its inventory as one JSON blob under
``node.alpha/DeviceInformation``, the scheduler writes the allocation back
as ``pod.alpha/DeviceInformation`` (`kubeinterface/kubeinterface.go:29-123`).
Both are ``json.dumps(..., sort_keys=True)``, so the JAX codec and this
one write the same bytes for the same object. Kubernetes objects are
plain dicts in their JSON shape.

Below the annotations sits the compact binary value codec of the stream
wire (``cluster/stream.py``): ``encode_value``/``decode_value`` and the
request and response records built on them, and the watch records the
scheduler's informer reads (pods, node snapshots, watch batches), byte for
byte the JAX package's.
"""

from __future__ import annotations

import json
import math
import re
import struct

from kubegpu_tpu_torch.core.types import ContainerInfo, NodeInfo, PodInfo

NODE_ANNOTATION_KEY = "node.alpha/DeviceInformation"
POD_ANNOTATION_KEY = "pod.alpha/DeviceInformation"
# Routable address of the node agent's host, advertised alongside the
# inventory; the runtime hook resolves a gang's coordinator node through
# it (node names need not resolve).
NODE_ADDRESS_ANNOTATION = "node.alpha/Address"
# Wall-clock seconds the advertiser stamps on every pass that lands: the
# liveness signal the JAX control plane's NodeLifecycle ages into
# Ready/Stale/Lost. Wall clock, since the stamp crosses hosts.
NODE_HEARTBEAT_ANNOTATION = "node.alpha/Heartbeat"
# Per-card health map {uuid: "healthy" | ...} from the device backend; a
# card that is not healthy is withheld from the advertised allocatable.
NODE_CHIP_HEALTH_ANNOTATION = "node.alpha/ChipHealth"
# Per-device dead-link bitmask map {id: mask}; zero masks are dropped.
NODE_LINK_HEALTH_ANNOTATION = "node.alpha/LinkHealth"

# Kubernetes quantity suffixes -> multiplier; the reference reads requests
# through resource.Quantity.Value(), which rounds up to a whole int64.
_QUANTITY_SUFFIXES = {
    "": 1,
    "m": 1e-3,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_QUANTITY_RE = re.compile(r"^([+-]?[0-9.eE+-]+?)([A-Za-z]*)$")


def parse_quantity(val: "int | float | str") -> int:
    """Parse a Kubernetes resource quantity to a whole number, rounding up
    (``"500m"`` -> 1, ``"1Gi"`` -> 2**30)."""
    if isinstance(val, (int, float)):
        return math.ceil(val)
    m = _QUANTITY_RE.match(str(val).strip())
    if not m or m.group(2) not in _QUANTITY_SUFFIXES:
        raise ValueError(f"invalid quantity: {val!r}")
    number, suffix = m.groups()
    try:
        parsed = float(number)
    except ValueError:
        raise ValueError(f"invalid quantity: {val!r}") from None
    return math.ceil(parsed * _QUANTITY_SUFFIXES[suffix])


def _annotations(meta: dict) -> dict:
    # Tolerate "annotations": null, which some serializers emit for empty maps.
    if not meta.get("annotations"):
        meta["annotations"] = {}
    return meta["annotations"]


def node_info_to_annotation(meta: dict, node_info: NodeInfo) -> None:
    """Serialize a node's device inventory into its metadata annotations
    (`kubeinterface.go:29-40`)."""
    _annotations(meta)[NODE_ANNOTATION_KEY] = json.dumps(
        node_info.to_json(), sort_keys=True
    )


def annotation_to_node_info(meta: dict, existing: NodeInfo | None = None) -> NodeInfo:
    """Decode a node annotation, keeping ``existing``'s in-memory ``used``
    accounting, which the advertiser never writes (`kubeinterface.go:42-61`)."""
    node_info = NodeInfo()
    ann = meta.get("annotations") or {}
    raw = ann.get(NODE_ANNOTATION_KEY)
    if raw is not None:
        node_info = NodeInfo.from_json(json.loads(raw))
    if existing is not None and existing.used:
        for key, val in existing.used.items():
            node_info.used[key] = val
    return node_info


def heartbeat_to_annotation(meta: dict, timestamp: float) -> None:
    """Stamp the advertiser's liveness heartbeat (wall-clock seconds)."""
    _annotations(meta)[NODE_HEARTBEAT_ANNOTATION] = json.dumps(
        round(float(timestamp), 3))


def annotation_to_heartbeat(meta: dict) -> float | None:
    """The heartbeat timestamp; None when there is none or it does not
    parse (liveness is then not tracked for the node)."""
    raw = (meta.get("annotations") or {}).get(NODE_HEARTBEAT_ANNOTATION)
    if raw is None:
        return None
    try:
        return float(json.loads(raw))
    except (TypeError, ValueError):
        return None


def chip_health_to_annotation(meta: dict, health: dict) -> None:
    """Serialize the backend's per-card health map."""
    _annotations(meta)[NODE_CHIP_HEALTH_ANNOTATION] = json.dumps(
        dict(health), sort_keys=True)


def annotation_to_chip_health(meta: dict) -> dict:
    """Decode the per-card health map; {} = everything healthy."""
    raw = (meta.get("annotations") or {}).get(NODE_CHIP_HEALTH_ANNOTATION)
    if not raw:
        return {}
    try:
        decoded = json.loads(raw)
    except (TypeError, ValueError):
        return {}
    return decoded if isinstance(decoded, dict) else {}


def link_health_to_annotation(meta: dict, dead_links: dict) -> None:
    """Serialize the per-device dead-link bitmask map, zero masks
    dropped (absence means every link up)."""
    _annotations(meta)[NODE_LINK_HEALTH_ANNOTATION] = json.dumps(
        {k: int(v) for k, v in dict(dead_links).items() if int(v)},
        sort_keys=True)


def annotation_to_link_health(meta: dict) -> dict:
    """Decode the dead-link map; {} = every link up."""
    raw = (meta.get("annotations") or {}).get(NODE_LINK_HEALTH_ANNOTATION)
    if not raw:
        return {}
    try:
        decoded = json.loads(raw)
    except (TypeError, ValueError):
        return {}
    if not isinstance(decoded, dict):
        return {}
    out = {}
    for dev_id, mask in decoded.items():
        try:
            if int(mask):
                out[str(dev_id)] = int(mask)
        except (TypeError, ValueError):
            continue
    return out


def pod_info_to_annotation(meta: dict, pod_info: PodInfo) -> None:
    """Serialize the scheduler's decision into pod metadata annotations
    (`kubeinterface.go:111-123`)."""
    _annotations(meta)[POD_ANNOTATION_KEY] = json.dumps(
        pod_info.to_json(), sort_keys=True
    )


def annotation_to_pod_info(meta: dict) -> PodInfo:
    """Decode the persisted decision from pod metadata, raw: no pod-spec
    merge, no invalidation (that is :func:`kube_pod_to_pod_info`)."""
    raw = (meta.get("annotations") or {}).get(POD_ANNOTATION_KEY)
    if raw is None:
        return PodInfo()
    return PodInfo.from_json(json.loads(raw))


def _merge_kube_containers(
    containers: dict, kube_containers: list, invalidate: bool
) -> None:
    """Fold core-Kubernetes container requests into ContainerInfos
    (`kubeinterface.go:63-85`). With ``invalidate``, stale scheduler output
    (``allocate_from``/``dev_requests``) is dropped and ``dev_requests``
    reset to the annotation's ``requests``."""
    for c in kube_containers:
        name = c["name"]
        info = containers.setdefault(name, ContainerInfo())
        for res, val in ((c.get("resources") or {}).get("requests") or {}).items():
            info.kube_requests[res] = parse_quantity(val)
    if invalidate:
        for info in containers.values():
            info.allocate_from = {}
            info.dev_requests = dict(info.requests)


def kube_pod_to_pod_info(kube_pod: dict, invalidate_existing: bool) -> PodInfo:
    """Convert a Kubernetes pod (JSON dict) into the scheduler's PodInfo
    (`kubeinterface.go:88-109`): the existing device annotation first, then
    the spec's container requests merged into ``kube_requests``."""
    meta = kube_pod.get("metadata") or {}
    pod_info = PodInfo()
    raw = (meta.get("annotations") or {}).get(POD_ANNOTATION_KEY)
    if raw is not None:
        pod_info = PodInfo.from_json(json.loads(raw))
    pod_info.name = meta.get("name", "")
    spec = kube_pod.get("spec") or {}
    _merge_kube_containers(
        pod_info.init_containers, spec.get("initContainers") or [], invalidate_existing
    )
    _merge_kube_containers(
        pod_info.running_containers, spec.get("containers") or [], invalidate_existing
    )
    if invalidate_existing:
        pod_info.node_name = ""
    return pod_info


# ---- binary value codec (the stream wire's payloads) -----------------------
#
# A tagged, length-prefixed encoding of JSON-shaped values with two
# string interning tables: a STATIC table of protocol constants (object
# keys, annotation keys, verbs) every peer knows, so they never ride the
# wire as more than a 1-2 byte reference; and a DYNAMIC table scoped to
# one frame, where a string's first occurrence is sent inline and gets
# the next id and every repeat is a reference. Every frame decodes on its
# own, so a reconnect has no interner state to resync.

_F64 = struct.Struct("<d")

_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR_NEW = 0x05   # inline utf-8, registers the next dynamic id
_T_STR_REF = 0x06   # varint reference into static+dynamic table
_T_LIST = 0x07
_T_DICT = 0x08

# Wire protocol: an id is a position in this tuple, so an entry missing,
# added or moved decodes as another string without any error. Its order
# is the JAX package's, the two groups appended last included.
_STATIC_STRINGS: "tuple[str, ...]" = (
    # object shape
    "metadata", "name", "annotations", "labels", "spec", "status",
    "nodeName", "containers", "initContainers", "resources", "requests",
    "allocatable", "capacity", "cpu", "pods", "priority", "phase",
    "volumes", "persistentVolumeClaim", "claimName", "volumeName",
    "storageClassName", "nodeAffinity",
    # annotation keys (the hot per-record payloads)
    NODE_ANNOTATION_KEY, POD_ANNOTATION_KEY, NODE_ADDRESS_ANNOTATION,
    NODE_HEARTBEAT_ANNOTATION, NODE_CHIP_HEALTH_ANNOTATION,
    # verbs + routes
    "GET", "POST", "PUT", "PATCH", "DELETE",
    # watch stream
    "node", "pod", "pv", "pvc", "added", "modified", "deleted",
    "events", "seq", "coalesced", "relist", "epoch", "items",
    # error detail
    "error", "per_pod", "bindings", "holder", "ttl",
    # multi-tenant front door (appended last: static ids are wire
    # protocol, so existing indexes must never shift)
    "retry_after_s", "tenant", "kgtpu.io/tenant", "quota", "weight",
    "hard_chips", "chips_created",
    # device-fault repair (appended last, by the same rule)
    NODE_LINK_HEALTH_ANNOTATION,
)
_STATIC_INDEX = {s: i for i, s in enumerate(_STATIC_STRINGS)}


class CodecError(ValueError):
    """Malformed binary payload: truncated, a bad tag, or a dangling
    intern reference. Raised by every ``decode_*`` function; a transport
    treats it as a poisoned frame and never retries the bytes."""


# Both varint halves share one magnitude cap (1024 bits: far beyond any
# control-plane quantity, tight enough that a hostile frame cannot force
# quadratic bigint work). The encoder refuses what the decoder would
# reject, so the wire never carries a frame only one side understands.
_VARINT_MAX_BITS = 1024


def _encode_varint(buf: bytearray, n: int) -> None:
    if n.bit_length() > _VARINT_MAX_BITS:
        raise CodecError(f"integer too large for the wire "
                         f"({n.bit_length()} bits > {_VARINT_MAX_BITS})")
    while n > 0x7F:
        buf.append((n & 0x7F) | 0x80)
        n >>= 7
    buf.append(n)


def _encode_into(buf: bytearray, obj: object, table: "dict[str, int]") -> None:
    # type checks ordered by frequency (strings dominate control-plane
    # records), one-byte varints inlined
    t = type(obj)
    if t is str:
        idx = table.get(obj)
        if idx is not None:
            buf.append(_T_STR_REF)
            if idx < 0x80:
                buf.append(idx)
            else:
                _encode_varint(buf, idx)
        else:
            table[obj] = len(table)  # type: ignore[index]
            raw = obj.encode()  # type: ignore[union-attr]
            buf.append(_T_STR_NEW)
            n = len(raw)
            if n < 0x80:
                buf.append(n)
            else:
                _encode_varint(buf, n)
            buf += raw
    elif t is dict:
        buf.append(_T_DICT)
        _encode_varint(buf, len(obj))  # type: ignore[arg-type]
        for key, val in obj.items():  # type: ignore[union-attr]
            _encode_into(buf, key, table)
            _encode_into(buf, val, table)
    elif t is int:
        buf.append(_T_INT)
        # zigzag: the sign rides the low bit so magnitudes stay short
        zz = (obj << 1) if obj >= 0 else ((-obj) << 1) - 1  # type: ignore
        if zz < 0x80:
            buf.append(zz)
        else:
            _encode_varint(buf, zz)
    elif t is list or t is tuple:
        buf.append(_T_LIST)
        _encode_varint(buf, len(obj))  # type: ignore[arg-type]
        for item in obj:  # type: ignore[union-attr]
            _encode_into(buf, item, table)
    elif obj is None:
        buf.append(_T_NONE)
    elif obj is True:
        buf.append(_T_TRUE)
    elif obj is False:
        buf.append(_T_FALSE)
    elif t is float:
        buf.append(_T_FLOAT)
        buf += _F64.pack(obj)  # type: ignore[arg-type]
    else:
        # a subclass coerces to its exact base type and re-enters the
        # branches above; anything else is sent as its str
        _encode_into(buf, _coerce(obj), table)


def _coerce(obj: object) -> object:
    if isinstance(obj, bool):
        return bool(obj)
    if isinstance(obj, str):
        return str(obj)
    if isinstance(obj, int):
        return int(obj)
    if isinstance(obj, float):
        return float(obj)
    if isinstance(obj, (list, tuple)):
        return list(obj)
    if isinstance(obj, dict):
        return dict(obj)
    return str(obj)


def _decode_varint(data: bytes, pos: int) -> "tuple[int, int]":
    out = 0
    shift = 0
    end = len(data)
    while True:
        if pos >= end:
            raise CodecError("truncated varint")
        byte = data[pos]
        pos += 1
        out |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return out, pos
        shift += 7
        if shift > _VARINT_MAX_BITS:
            raise CodecError("varint too long")


def _decode_from(data: bytes, pos: int,
                 table: "list[str]") -> "tuple[object, int]":
    # branches ordered by frequency, one-byte varints inlined; an
    # IndexError from truncation is wrapped into CodecError by
    # decode_value
    end = len(data)
    if pos >= end:
        raise CodecError("truncated value")
    tag = data[pos]
    pos += 1
    if tag == _T_STR_REF:
        idx = data[pos]
        pos += 1
        if idx & 0x80:
            idx, pos = _decode_varint(data, pos - 1)
        if idx >= len(table):
            raise CodecError(f"dangling string reference {idx}")
        return table[idx], pos
    if tag == _T_STR_NEW:
        n = data[pos]
        pos += 1
        if n & 0x80:
            n, pos = _decode_varint(data, pos - 1)
        if pos + n > end:
            raise CodecError("truncated string")
        s = data[pos:pos + n].decode()
        table.append(s)
        return s, pos + n
    if tag == _T_DICT:
        n = data[pos]
        pos += 1
        if n & 0x80:
            n, pos = _decode_varint(data, pos - 1)
        if n > end - pos:
            raise CodecError("dict longer than payload")
        out_d: "dict[object, object]" = {}
        for _ in range(n):
            key, pos = _decode_from(data, pos, table)
            val, pos = _decode_from(data, pos, table)
            out_d[key] = val
        return out_d, pos
    if tag == _T_LIST:
        n = data[pos]
        pos += 1
        if n & 0x80:
            n, pos = _decode_varint(data, pos - 1)
        if n > end - pos:
            raise CodecError("list longer than payload")
        out_l: "list[object]" = []
        for _ in range(n):
            item, pos = _decode_from(data, pos, table)
            out_l.append(item)
        return out_l, pos
    if tag == _T_INT:
        zz = data[pos]
        pos += 1
        if zz & 0x80:
            zz, pos = _decode_varint(data, pos - 1)
        return (zz >> 1) ^ -(zz & 1), pos
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_FLOAT:
        if pos + 8 > end:
            raise CodecError("truncated float")
        return _F64.unpack_from(data, pos)[0], pos + 8
    raise CodecError(f"unknown tag 0x{tag:02x}")


def encode_value(obj: object) -> bytes:
    """Encode one JSON-shaped value (the generic wire payload)."""
    buf = bytearray()
    _encode_into(buf, obj, dict(_STATIC_INDEX))
    return bytes(buf)


def decode_value(data: bytes) -> object:
    """Decode one value. Raises :class:`CodecError` on malformed bytes
    (truncation, bad tags, dangling intern references) and on trailing
    bytes: a frame is exactly one value."""
    try:
        val, pos = _decode_from(data, 0, list(_STATIC_STRINGS))
    except IndexError:
        raise CodecError("truncated value") from None
    except RecursionError:
        raise CodecError("value nested too deeply") from None
    except UnicodeDecodeError:
        raise CodecError("string payload is not valid utf-8") from None
    except TypeError:
        # e.g. a decoded list arriving in dict-key position
        raise CodecError("unhashable dict key in payload") from None
    if pos != len(data):
        raise CodecError(f"{len(data) - pos} trailing byte(s) after value")
    return val


def _expect_dict(val: object, what: str) -> dict:
    if not isinstance(val, dict):
        raise CodecError(f"{what}: expected an object, got "
                         f"{type(val).__name__}")
    return val


def encode_pod(pod: dict) -> bytes:
    """Compact encoding of one pod object (its JSON dict shape)."""
    return encode_value(pod)


def decode_pod(data: bytes) -> dict:
    return _expect_dict(decode_value(data), "pod record")


def encode_node_snapshot(node: dict) -> bytes:
    """Compact encoding of one node object, its device annotation
    included: the repeated card paths are what interning folds away."""
    return encode_value(node)


def decode_node_snapshot(data: bytes) -> dict:
    return _expect_dict(decode_value(data), "node snapshot")


def encode_watch_batch(events: "list[tuple]", seq: int, coalesced: int = 0,
                       relist: bool = False, epoch: "str | None" = None,
                       ts: float = 0.0) -> bytes:
    """One coalesced watch window ``[(seq, kind, event, obj), ...]`` with
    its resume cursor, the number of events folded away, the relist flag,
    the server's epoch and its wall-clock stamp ``ts`` (cross-process, so
    not monotonic; the receiver's ``watch_push_lag_ms``)."""
    return encode_value([[list(e) for e in events], seq, coalesced,
                         relist, epoch, ts])


def decode_watch_batch(data: bytes) -> dict:
    val = decode_value(data)
    if not isinstance(val, list) or len(val) != 6 or \
            not isinstance(val[0], list):
        raise CodecError("malformed watch batch")
    events = []
    for ev in val[0]:
        if not isinstance(ev, list) or len(ev) != 4:
            raise CodecError("malformed watch event")
        events.append(tuple(ev))
    return {"events": events, "seq": val[1], "coalesced": val[2],
            "relist": bool(val[3]), "epoch": val[4], "ts": val[5]}


def encode_request(method: str, path: str, body: object,
                   trace: "str | None" = None) -> bytes:
    """One framed API request: verb, route, body and an optional trace
    context."""
    return encode_value([method, path, body, trace])


def decode_request(data: bytes) -> "tuple[str, str, object, str | None]":
    val = decode_value(data)
    if not isinstance(val, list) or len(val) != 4 or \
            not isinstance(val[0], str) or not isinstance(val[1], str) or \
            not (val[3] is None or isinstance(val[3], str)):
        raise CodecError("malformed request frame")
    return val[0], val[1], val[2], val[3]


def encode_response(status: int, body: object) -> bytes:
    """One framed API response: an HTTP status and the body (an error body
    carries the same ``{"error", "per_pod"}`` detail as on the JSON
    wire)."""
    return encode_value([status, body])


def decode_response(data: bytes) -> "tuple[int, object]":
    val = decode_value(data)
    if not isinstance(val, list) or len(val) != 2 or \
            not isinstance(val[0], int):
        raise CodecError("malformed response frame")
    return val[0], val[1]
