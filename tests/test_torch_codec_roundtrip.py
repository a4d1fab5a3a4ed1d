"""Round trips of the port's codec pairs that tests/test_torch_codec.py does
not cover: the node-health annotations (heartbeat, card health, dead
links) and the binary wire records (value, pod, node snapshot, watch
batch, request, response). Each pair decodes what it encoded, writes the
JAX package's bytes, and reads what the JAX encoder wrote. These are the
round-trip tests the port's codec-pairing rule reads
(``analysis/rules/codecs.py``)."""

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.core import codec as jcodec  # noqa: E402
from kubegpu_tpu_torch.core import codec as tcodec  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from tests import torch_api as ta  # noqa: E402

UUID = fake.fake_uuid(0, 3)
NODE = ta.gpu_node("host0")
POD = ta.gpu_pod("p1", 2, tenant="ta", alloc=(0, (1, 4)))

# (the port's encoder, its decoder, encoder arguments, what decoding gives
# back); the JAX twin of each is the function of the same name
ANNOTATION_PAIRS = {
    "heartbeat": (tcodec.heartbeat_to_annotation,
                 tcodec.annotation_to_heartbeat,
                  (1700000000.1234,), 1700000000.123),
    "chip_health": (tcodec.chip_health_to_annotation,
                   tcodec.annotation_to_chip_health,
                    ({UUID: "failed", fake.fake_uuid(0, 5): "degraded"},),
                    {UUID: "failed", fake.fake_uuid(0, 5): "degraded"}),
    "link_health": (tcodec.link_health_to_annotation,
                   tcodec.annotation_to_link_health,
                    ({UUID: 5, fake.fake_uuid(0, 1): 0},), {UUID: 5}),
}

WIRE_PAIRS = {
    "value": (tcodec.encode_value, tcodec.decode_value,
              ({"a": [1, 2.5, None, True, "x" * 40], "b": {"c": -7}},),
              {"a": [1, 2.5, None, True, "x" * 40], "b": {"c": -7}}),
    "pod": (tcodec.encode_pod, tcodec.decode_pod, (POD,), POD),
    "node_snapshot": (tcodec.encode_node_snapshot,
                      tcodec.decode_node_snapshot,
                      (NODE,), NODE),
    "watch_batch": (tcodec.encode_watch_batch, tcodec.decode_watch_batch,
                    ([(7, "pod", "modified", POD), (8, "node", "added",
                                                    NODE)], 8, 2, False,
                     "epoch-1", 1700000000.5),
                    {"events": [(7, "pod", "modified", POD),
                                (8, "node", "added", NODE)],
                     "seq": 8, "coalesced": 2, "relist": False,
                     "epoch": "epoch-1", "ts": 1700000000.5}),
    "request": (tcodec.encode_request, tcodec.decode_request,
                ("POST", "/bindmany", {"bindings": {"p1": "host0"}},
                 '{"parent": "t/s"}'),
                ("POST", "/bindmany", {"bindings": {"p1": "host0"}},
                 '{"parent": "t/s"}')),
    "response": (tcodec.encode_response, tcodec.decode_response,
                 (409, {"error": "taken", "per_pod": {"p1": "card"}}),
                 (409, {"error": "taken", "per_pod": {"p1": "card"}})),
}


@pytest.mark.parametrize("case", sorted(ANNOTATION_PAIRS))
def test_annotation_pair_round_trips_both_ways(case):
    enc, dec, args, want = ANNOTATION_PAIRS[case]
    jenc, jdec = (getattr(jcodec, f.__name__) for f in (enc, dec))
    tmeta, jmeta = {"name": "n"}, {"name": "n"}
    enc(tmeta, *args)
    jenc(jmeta, *args)
    assert tmeta == jmeta          # the reference's bytes
    assert dec(tmeta) == want      # round trip
    assert dec(jmeta) == want      # reads the reference's
    assert jdec(tmeta) == want     # and the reference reads it
    # absent annotation: the documented empty answer on both sides
    assert dec({}) == jdec({})


@pytest.mark.parametrize("case", sorted(WIRE_PAIRS))
def test_wire_pair_round_trips_both_ways(case):
    enc, dec, args, want = WIRE_PAIRS[case]
    jenc, jdec = (getattr(jcodec, f.__name__) for f in (enc, dec))
    data = enc(*args)
    assert data == jenc(*args)     # the reference's bytes
    assert dec(data) == want
    assert jdec(data) == want
    # a truncated record is a typed error, never a wrong value
    with pytest.raises(tcodec.CodecError):
        dec(data[:-1])
