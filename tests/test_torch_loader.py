"""The port's own binding of the native token loader
(kubegpu_tpu_torch.native, workload.data.NativeTokenLoader), mirroring
tests/test_dataloader.py:66-100: the C++ loader, built from
``native/dataloader.cpp`` at first use with the host's g++, must give
the stream of both packages' `PyTokenLoader` bit for bit; its error paths
raise with the loader's message; `make_loader` returns it and raises,
with the compiler's output, when it cannot be built (no fallback)."""

import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from kubegpu_tpu.workload import data as jdata  # noqa: E402
from kubegpu_tpu_torch import native  # noqa: E402
from kubegpu_tpu_torch.workload import data as tdata  # noqa: E402


def _shards(tmp_path, sizes=(5000, 3000, 257), seed=7):
    rng = np.random.default_rng(seed)
    return [tdata.write_token_shard(str(tmp_path / f"s{i}.kgtd"),
                                    rng.integers(0, 1000, size=n,
                                                 dtype=np.uint32))
            for i, n in enumerate(sizes)]


@pytest.mark.parametrize("seed", [0, 123, 2**63 + 5])
def test_native_stream_bit_identical_to_both_references(tmp_path, seed):
    paths = _shards(tmp_path)
    nat = tdata.make_loader(paths, batch=3, seq_len=64, seed=seed)
    assert isinstance(nat, tdata.NativeTokenLoader)
    ours = tdata.PyTokenLoader(paths, batch=3, seq_len=64, seed=seed)
    ref = jdata.PyTokenLoader(paths, batch=3, seq_len=64, seed=seed)
    try:
        for i in range(20):
            a, b, c = next(nat), next(ours), next(ref)
            assert a.dtype == np.int32 and a.shape == (3, 65)
            assert np.array_equal(a, b) and np.array_equal(a, c), i
    finally:
        nat.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(nat)
    nat.close()                                   # closing twice is fine


def test_native_loader_errors(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open"):
        tdata.NativeTokenLoader([str(tmp_path / "missing.kgtd")], 2, 8)
    tiny = tdata.write_token_shard(str(tmp_path / "tiny.kgtd"),
                                   np.arange(4, dtype=np.uint32))
    with pytest.raises(RuntimeError, match="shorter than sequence"):
        tdata.NativeTokenLoader([tiny], 2, 8)
    # n_tokens >= 2^62: the size check must not overflow and accept it
    evil = tmp_path / "evil.kgtd"
    evil.write_bytes(b"KGTDSH01" + struct.pack("<Q", 1 << 62)
                     + b"\x00" * 64)
    with pytest.raises(RuntimeError, match="truncated"):
        tdata.NativeTokenLoader([str(evil)], 2, 8)
    with pytest.raises(RuntimeError, match="no shards"):
        tdata.NativeTokenLoader([], 2, 8)


def test_native_prefetch_keeps_up(tmp_path):
    """Many rapid next() calls against a ring of two neither deadlock nor
    repeat batches."""
    nat = tdata.NativeTokenLoader(_shards(tmp_path), batch=2, seq_len=16,
                                  seed=9, prefetch=2)
    try:
        seen = {next(nat).tobytes() for _ in range(50)}
        assert len(seen) > 45
    finally:
        nat.close()


def test_library_is_built_once_into_the_build_tree():
    lib = native.load()
    assert native.load() is lib
    path = native._library_path()
    assert path.exists()
    assert path.parent.parent == native.BUILD_ROOT


def test_make_loader_raises_when_the_build_fails(tmp_path, monkeypatch):
    """No quiet fallback to the Python loader: a source that does not
    compile makes `make_loader` raise with the compiler's message."""
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed") as exc:
        tdata.make_loader(_shards(tmp_path), 2, 8)
    assert "error" in str(exc.value)
    assert not list((tmp_path / "build").rglob("*.so"))
