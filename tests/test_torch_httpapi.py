"""The port's JSON-wire API client (`kubegpu_tpu_torch/cluster/httpapi.py`)
against the JAX package's API server, served over HTTP by its own
`serve_api`: every verb, typed errors, and the retry policy of the
reference client's ``_req`` (idempotent verbs retry transport faults,
POST is sent once, a 429's advised backoff is honoured)."""

import json

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu.cluster.httpapi import serve_api  # noqa: E402
from kubegpu_tpu_torch.cluster.httpapi import (Conflict,  # noqa: E402
                                               HTTPAPIClient, NotFound,
                                               TooManyRequests)


@pytest.fixture()
def served():
    api = InMemoryAPIServer()
    server, url = serve_api(api)
    client = HTTPAPIClient(url)
    yield api, client
    client.close()
    server.shutdown()


def test_every_verb_round_trips(served):
    api, client = served
    client.create_node({"metadata": {"name": "n1", "annotations": {"a": "1"}}})
    client.patch_node_metadata("n1", {"annotations": {"b": "2"}})
    assert client.get_node("n1")["metadata"]["annotations"] == \
        {"a": "1", "b": "2"}
    assert api.get_node("n1")["metadata"]["annotations"]["b"] == "2"
    api.create_pod({"metadata": {"name": "p", "annotations": {"x": "1"}}})
    assert client.get_pod("p")["metadata"]["name"] == "p"
    client.update_pod_annotations("p", {"x": "1", "y": "2"})
    assert api.get_pod("p")["metadata"]["annotations"] == {"x": "1", "y": "2"}


@pytest.mark.parametrize("verb", ["get_pod", "get_node"])
def test_unknown_object_is_a_keyerror(served, verb):
    _, client = served
    with pytest.raises(NotFound) as err:
        getattr(client, verb)("ghost")
    assert isinstance(err.value, KeyError)


def _flaky(client, monkeypatch, replies):
    """Make ``_roundtrip`` answer from ``replies`` (an exception to raise
    or a ``(status, body)`` pair) before passing calls on; returns the
    list of methods it saw."""
    real = client._roundtrip
    seen = []

    def roundtrip(method, path, data, timeout):
        seen.append(method)
        if replies:
            reply = replies.pop(0)
            if isinstance(reply, BaseException):
                raise reply
            return reply
        return real(method, path, data, timeout)

    monkeypatch.setattr(client, "_roundtrip", roundtrip)
    return seen


@pytest.mark.parametrize("status,cls", [(404, NotFound), (409, Conflict),
                                        (500, RuntimeError)])
def test_error_replies_are_typed(served, monkeypatch, status, cls):
    """The reference's ``_server_error``: the server's error text and
    per-pod detail survive the wire; a reply is never retried."""
    _, client = served
    body = json.dumps({"error": "no", "per_pod": {"p": "taken"}}).encode()
    seen = _flaky(client, monkeypatch, [(status, body)])
    with pytest.raises(cls) as err:
        client.patch_node_metadata("n1", {})
    assert seen == ["PATCH"]
    if cls is not RuntimeError:
        assert err.value.per_pod == {"p": "taken"} and "no" in str(err.value)


def test_idempotent_verb_retries_a_transport_fault(served, monkeypatch):
    api, client = served
    api.create_node({"metadata": {"name": "n1"}})
    seen = _flaky(client, monkeypatch, [ConnectionResetError("reset"),
                                        ConnectionResetError("reset")])
    assert client.get_node("n1")["metadata"]["name"] == "n1"
    assert seen == ["GET"] * 3 and client.retry_count == 2


def test_idempotent_verb_gives_up_after_three_attempts(served, monkeypatch):
    _, client = served
    seen = _flaky(client, monkeypatch, [ConnectionResetError("x")] * 3)
    with pytest.raises(ConnectionResetError):
        client.get_node("n1")
    assert len(seen) == 3


def test_post_is_sent_once(served, monkeypatch):
    api, client = served
    seen = _flaky(client, monkeypatch, [ConnectionResetError("reset")])
    with pytest.raises(ConnectionResetError):
        client.create_node({"metadata": {"name": "n1"}})
    assert seen == ["POST"] and client.retry_count == 0
    with pytest.raises(KeyError):
        api.get_node("n1")


def test_a_429_is_honoured_then_retried(served, monkeypatch):
    api, client = served
    api.create_node({"metadata": {"name": "n1"}})
    body = json.dumps({"error": "shed", "retry_after_s": 0.05}).encode()
    waits = []
    real_wait = client._stop.wait
    monkeypatch.setattr(client._stop, "wait",
                        lambda s: waits.append(s) or real_wait(0))
    seen = _flaky(client, monkeypatch, [(429, body)])
    assert client.get_node("n1")["metadata"]["name"] == "n1"
    assert seen == ["GET", "GET"] and client.throttled_count == 1
    # the advised delay is the floor, jitter only above it
    assert len(waits) == 1 and 0.05 <= waits[0] <= 0.05 * 1.25


def test_a_429_on_post_raises_typed(served, monkeypatch):
    _, client = served
    body = json.dumps({"error": "shed", "retry_after_s": 0.5}).encode()
    _flaky(client, monkeypatch, [(429, body)])
    with pytest.raises(TooManyRequests) as err:
        client.create_node({"metadata": {"name": "n1"}})
    assert err.value.retry_after_s == 0.5


def test_closed_client_does_not_dial_again(served):
    _, client = served
    client.close()
    with pytest.raises(ConnectionError):
        client.get_node("n1")
