"""Input pipeline: token shards and a loader, the port's own copy of
``kubegpu_tpu/workload/data.py``'s Python half.

Shard format: 8-byte magic ``KGTDSH01``, uint64 LE token count, then
uint32 LE tokens. Sampling: splitmix64 from ``seed``; per sample
``shard = next() % n_shards`` then ``start = next() % (len - seq1 + 1)``;
``batch`` samples per batch, row order. The stream equals the reference's
bit for bit (tests/test_torch_train.py). The reference's C++ loader
(``native/dataloader.cpp``) is bound through the JAX package, so
`make_loader` returns `PyTokenLoader`; a binding of its own is queued in
ROADMAP.md.
"""

from __future__ import annotations

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


def make_loader(paths: list, batch: int, seq_len: int, seed: int = 0):
    """The loader of this package: `PyTokenLoader` (the same stream as the
    reference's native loader)."""
    return PyTokenLoader(paths, batch, seq_len, seed)
