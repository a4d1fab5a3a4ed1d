"""The port's counter-based sampling keys (kubegpu_tpu_torch.workload.keys)
held against a plain numpy uint32 implementation of the same hash, bit for
bit: the int64 tensor arithmetic with 16-bit halves must equal true 32-bit
wrap-around arithmetic. On the card (``cuda`` marker) the bits must equal
the CPU's. The uniforms and Gumbel draws they feed are checked against
their distributions. No JAX: the keys are the port's own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubegpu_tpu_torch.workload import keys  # noqa: E402


def _mix32_np(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _fold_np(key, data):
    with np.errstate(over="ignore"):
        d = _mix32_np(np.asarray(data, np.uint64).astype(np.uint32)
                      ^ np.uint32(0x9E3779B9))
        return _mix32_np(_mix32_np(np.asarray(key, np.uint32)) + d)


def _inputs():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    d = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint64)
    return np.concatenate([k, edges, edges]), \
        np.concatenate([d, edges, edges[::-1]])


def test_fold_equals_uint32_reference():
    k, d = _inputs()
    with np.errstate(over="ignore"):
        want = _fold_np(k, d)
    got = keys.fold(torch.from_numpy(k.astype(np.int64)),
                    torch.from_numpy(d.astype(np.int64)))
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_fold_takes_ints_and_large_counters():
    """Keys and counters are taken mod 2^32, so a position or seed past
    32 bits folds like its low word; ints and tensors give the same key."""
    assert int(keys.fold(7, 2**32 + 5)) == int(keys.fold(7, 5))
    assert int(keys.fold(2**40 + 7, 5)) == int(keys.fold(7, 5))
    assert int(keys.fold(torch.tensor(7), torch.tensor(5))) == \
        int(keys.fold(7, 5))
    assert int(keys.as_key(-1)) == 2**32 - 1
    assert int(keys.fold(7, 5)) != int(keys.fold(5, 7))


def test_uniform_and_gumbel_distributions():
    root = keys.fold(torch.arange(64), 3)
    u = keys.uniform(root, 4096)
    assert u.shape == (64, 4096) and u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    # 262144 uniforms: mean 1/2 and variance 1/12 within 5 sigma
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12) ** 0.5 / 512
    counts = np.histogram(u.numpy(), bins=16, range=(0, 1))[0]
    chi2 = ((counts - u.numel() / 16) ** 2 / (u.numel() / 16)).sum()
    assert chi2 < 37.7                       # chi-square, 15 dof, p=0.001
    g = keys.gumbel(root, 4096)
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01      # Euler-Mascheroni
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def test_bits_are_counter_folds():
    key = keys.fold(11, 4)
    assert torch.equal(keys.bits(key, 6), keys.fold(key, torch.arange(6)))
    two = keys.bits(torch.stack([key, keys.fold(11, 5)]), 6)
    assert two.shape == (2, 6) and torch.equal(two[0], keys.bits(key, 6))


@pytest.mark.cuda
def test_key_bits_on_card_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    k, d = _inputs()
    kt, dt = (torch.from_numpy(x.astype(np.int64)) for x in (k, d))
    cpu = keys.bits(keys.fold(kt, dt), 257)
    card = keys.bits(keys.fold(kt.cuda(), dt.cuda()), 257)
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(keys.uniform(kt.cuda(), 33).cpu(),
                       keys.uniform(kt, 33))
