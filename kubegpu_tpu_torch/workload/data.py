"""Input pipeline: token shards and loaders, the port's own copy of
``kubegpu_tpu/workload/data.py``.

Shard format: 8-byte magic ``KGTDSH01``, uint64 LE token count, then
uint32 LE tokens. Sampling: splitmix64 from ``seed``; per sample
``shard = next() % n_shards`` then ``start = next() % (len - seq1 + 1)``;
``batch`` samples per batch, row order. `NativeTokenLoader` (the C++
loader of ``native/dataloader.cpp``: mmap and a prefetch thread, built at
first use by `kubegpu_tpu_torch.native`) and `PyTokenLoader` (the Python
reference) give the reference's stream bit for bit
(tests/test_torch_loader.py). `make_loader` returns the native loader and
raises when it cannot be built; it never falls back to the Python one.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

MAGIC = b"KGTDSH01"
_MASK = (1 << 64) - 1


def write_token_shard(path: str, tokens) -> str:
    """Write a uint32 token array as one shard file."""
    arr = np.asarray(tokens, dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", arr.size))
        f.write(arr.tobytes())
    return path


def read_token_shard(path: str) -> np.ndarray:
    """Validated mmap of one shard's tokens (zero-copy)."""
    with open(path, "rb") as f:
        header = f.read(16)
    if len(header) < 16 or header[:8] != MAGIC:
        raise ValueError(f"{path}: not a KGTDSH01 token shard")
    (n,) = struct.unpack("<Q", header[8:16])
    arr = np.memmap(path, dtype=np.uint32, mode="r", offset=16)
    if arr.size < n:
        raise ValueError(f"{path}: truncated shard ({arr.size} < {n})")
    return arr[:n]


class _SplitMix64:
    """The reference's SplitMix64 (and dataloader.cpp's), exactly."""

    def __init__(self, seed: int):
        self.x = seed & _MASK

    def next(self) -> int:
        self.x = (self.x + 0x9E3779B97F4A7C15) & _MASK
        z = self.x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        return z ^ (z >> 31)


class PyTokenLoader:
    """Batches ``[batch, seq_len + 1]`` int32 of tokens from the shards."""

    def __init__(self, paths: list, batch: int, seq_len: int, seed: int = 0):
        if not paths:
            raise ValueError("no shards")
        self.shards = [read_token_shard(p) for p in paths]
        self.batch = int(batch)
        self.seq1 = int(seq_len) + 1  # inputs + next-token target
        for p, s in zip(paths, self.shards):
            if s.size < self.seq1:
                raise ValueError(f"shard {p} shorter than sequence length")
        self.rng = _SplitMix64(seed)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.batch, self.seq1), np.int32)
        for b in range(self.batch):
            shard = self.shards[self.rng.next() % len(self.shards)]
            start = self.rng.next() % (shard.size - self.seq1 + 1)
            out[b] = shard[start:start + self.seq1].astype(np.int32)
        return out

    def close(self) -> None:
        pass


class NativeTokenLoader:
    """The C++ loader: mmap'd shards and a producer thread filling a ring
    of ``prefetch`` ready batches (``native/dataloader.cpp``)."""

    def __init__(self, paths: list, batch: int, seq_len: int, seed: int = 0,
                 prefetch: int = 2):
        from kubegpu_tpu_torch import native

        self._lib = native.load()
        self.batch = int(batch)
        self.seq1 = int(seq_len) + 1
        self._handle = self._lib.dl_open("\n".join(paths).encode(),
                                         self.batch, self.seq1,
                                         seed & _MASK, prefetch)
        if not self._handle:
            raise RuntimeError(
                f"dl_open: {self._lib.dl_last_error().decode()}")
        self._buf = np.empty(self.batch * self.seq1, np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self._handle:
            raise RuntimeError("loader is closed")
        n = self._lib.dl_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._buf.size)
        if n < 0:
            raise RuntimeError(
                f"dl_next: {self._lib.dl_last_error().decode()}")
        return self._buf[:n].reshape(self.batch, self.seq1).copy()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def make_loader(paths: list, batch: int, seq_len: int, seed: int = 0):
    """The native loader; raises (with the compiler's message when the
    build failed) rather than fall back to `PyTokenLoader`, which stays
    for explicit use and as the tests' reference."""
    return NativeTokenLoader(paths, batch, seq_len, seed)
