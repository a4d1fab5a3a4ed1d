"""The training corpus on disk, and the rows a loader draws from it.

The file is the token-shard format the program's loader reads: the 8-byte
magic ``KGTDSH01``, the token count as a little-endian uint64, then the
tokens as little-endian uint32. `rows` works out again, from the raw
file and the loader's seed, the rows the loader hands each step: for
each row a SplitMix64 draw picks the shard and the next its start, as the
loader's documented sampling does, so the reference trains on the same
rows without reading anything of the program.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"KGTDSH01"
_MASK = (1 << 64) - 1


def write(path, tokens: np.ndarray) -> None:
    arr = np.ascontiguousarray(tokens, dtype="<u4")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", arr.size))
        f.write(arr.tobytes())


def read(path) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(16)
        if head[:8] != MAGIC:
            raise ValueError(f"{path}: not a token shard")
        (n,) = struct.unpack("<Q", head[8:])
        return np.frombuffer(f.read(4 * n), dtype="<u4")


class SplitMix64:
    def __init__(self, seed: int):
        self.x = seed & _MASK

    def next(self) -> int:
        self.x = (self.x + 0x9E3779B97F4A7C15) & _MASK
        z = self.x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        return z ^ (z >> 31)


def rows(shards: list, batch: int, seq_len: int, seed: int, steps: int):
    """The first ``steps`` batches ``[batch, seq_len + 1]`` (int64) a
    loader seeded with ``seed`` draws from ``shards`` (token arrays)."""
    rng = SplitMix64(seed)
    seq1 = seq_len + 1
    out = []
    for _ in range(steps):
        b = np.empty((batch, seq1), np.int64)
        for i in range(batch):
            shard = shards[rng.next() % len(shards)]
            start = rng.next() % (shard.size - seq1 + 1)
            b[i] = shard[start:start + seq1]
        out.append(b)
    return out
