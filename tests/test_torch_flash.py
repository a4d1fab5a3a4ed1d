"""The port's flash attention (kubegpu_tpu_torch.workload.kernels.flash)
held against the JAX package's Pallas kernel in interpret mode, as
tests/test_kernels.py runs it on the CPU.

On the CPU the port's wrapper computes with its plain version
(`flash_attention_plain`); the CUDA kernel itself is held against that
plain version on the card (`test_kernel_matches_plain_on_card`,
chip_smoke.py). Inputs come from numpy with a seed; float32 throughout,
tolerance 2e-5 as the reference's kernel tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload.kernels import flash as jflash  # noqa: E402
from kubegpu_tpu_torch.workload.kernels import flash as tflash  # noqa: E402

TOL = 2e-5


def _qkv(b, t, h, d, seed=0, tk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d), dtype=np.float32)
    k = rng.standard_normal((b, tk or t, h, d), dtype=np.float32)
    v = rng.standard_normal((b, tk or t, h, d), dtype=np.float32)
    return q, k, v


def _both(q, k, v, scale, **kw):
    """(JAX kernel (o, lse), port (o, lse)) as numpy arrays."""
    jo, jl = jflash.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), scale, interpret=True, **kw)
    to, tl = tflash.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), scale, **kw)
    return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())


@pytest.mark.parametrize("bq,bk", [(32, 32), (32, 16), (16, 32), (64, 64)])
def test_forward_matches_jax_kernel(bq, bk):
    q, k, v = _qkv(2, 64, 4, 32)
    (jo, jl), (to, tl) = _both(q, k, v, 32 ** -0.5, block_q=bq, block_k=bk)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)


def test_forward_non_causal():
    q, k, v = _qkv(1, 64, 2, 32, seed=1)
    (jo, jl), (to, tl) = _both(q, k, v, 32 ** -0.5, causal=False,
                               block_q=16, block_k=16)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)


def test_offsets_and_all_future_sentinel():
    q, k, v = _qkv(1, 32, 2, 32, seed=5)
    (jo, jl), (to, tl) = _both(q, k, v, 32 ** -0.5, q_offset=96,
                               kv_offset=32, block_q=16, block_k=16)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)
    # every tile of every row hidden: both give O = 0 and lse <= -1e20
    (jo, jl), (to, tl) = _both(q, k, v, 32 ** -0.5, q_offset=0,
                               kv_offset=1000, block_q=16, block_k=16)
    assert float(tl.max()) < -1e20 and float(jl.max()) < -1e20
    assert not to.any() and not np.asarray(jo).any()


@pytest.mark.parametrize("window", [16, 64])
def test_sliding_window_matches_jax_kernel(window):
    q, k, v = _qkv(2, 128, 2, 32, seed=2)
    (jo, jl), (to, tl) = _both(q, k, v, 32 ** -0.5, window=window,
                               block_q=32, block_k=32)
    np.testing.assert_allclose(to, jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl, jl, atol=TOL, rtol=TOL)


def test_window_implies_causal_bound():
    q, k, v = _qkv(1, 64, 2, 16, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    a = tflash.flash_attention(*t, 0.25, causal=False, window=12)
    b = tflash.flash_attention(*t, 0.25, causal=True, window=12)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_merge_partials_of_two_halves_equals_full():
    q, k, v = _qkv(1, 32, 2, 32, seed=7)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    scale = 32 ** -0.5
    o1, l1 = tflash.flash_attention_with_lse(tq, tk[:, :16], tv[:, :16],
                                             scale)
    o2, l2 = tflash.flash_attention_with_lse(tq, tk[:, 16:], tv[:, 16:],
                                             scale, kv_offset=16)
    merged, lse = tflash.merge_partials(o1, l1, o2, l2)
    full, full_lse = tflash.flash_attention_with_lse(tq, tk, tv, scale)
    torch.testing.assert_close(merged, full, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, full_lse, atol=TOL, rtol=TOL)
    # and the port's merge equals the reference's on the same partials
    jm, jlse = jflash.merge_partials(*(jnp.asarray(x.numpy())
                                       for x in (o1, l1, o2, l2)))
    np.testing.assert_allclose(merged.numpy(), np.asarray(jm), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL,
                               rtol=TOL)


def test_plain_matches_reference_attention_on_ragged_lengths():
    """The plain version takes any Tq, Tk (the CUDA kernel's tiles do
    too); against the reference's einsum attention at global positions."""
    q, k, v = _qkv(1, 37, 2, 16, seed=9, tk=53)
    o, lse = tflash.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), 0.25, q_offset=16)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
    mask = (16 + np.arange(37))[:, None] >= np.arange(53)[None, :]
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(o.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        lse.numpy(), (m + np.log(p.sum(-1, keepdims=True)))[..., 0],
        atol=TOL, rtol=TOL)


def test_argument_checks():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 48, 2, 16))
    with pytest.raises(ValueError, match="not divisible"):
        tflash.flash_attention(q, k, v, 0.25, block_q=32)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention(q, k, v, 0.25, window=-1)
    # inputs that require grad are taken (slice 2 brought the backward)
    out = tflash.flash_attention(q.requires_grad_(), k, v, 0.25)
    assert out.requires_grad and out.grad_fn is not None


def test_cpu_tensors_use_plain_version_and_count_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 32, 2, 16))
    before = tflash.flash_attention_with_lse.launches
    o, lse = tflash.flash_attention_with_lse(q, k, v, 0.25)
    po, plse = tflash.flash_attention_plain(q, k, v, 0.25)
    assert tflash.flash_attention_with_lse.launches == before
    assert torch.equal(o, po) and torch.equal(lse, plse)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: bf16 and
    float32, causal, windowed, offset and ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for tq, tk, kw in ((256, 256, {}), (200, 200, dict(window=48)),
                           (70, 130, dict(q_offset=96, kv_offset=32))):
            q = torch.randn((2, tq, 4, 64), generator=gen,
                            device="cuda").to(dt)
            k, v = (torch.randn((2, tk, 4, 64), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            before = tflash.flash_attention_with_lse.launches
            o, lse = tflash.flash_attention_with_lse(q, k, v, 0.125, **kw)
            torch.cuda.synchronize()
            assert tflash.flash_attention_with_lse.launches == before + 1
            po, plse = tflash.flash_attention_plain(q, k, v, 0.125, **kw)
            torch.testing.assert_close(o.float(), po.float(), atol=tol,
                                       rtol=0)
            torch.testing.assert_close(lse, plse, atol=max(tol, 1e-3),
                                       rtol=0)
