"""The port's flash-attention backward (K2 dQ, K3 dK/dV and their autograd
Function in kubegpu_tpu_torch.workload.kernels.flash) held against the JAX
package's Pallas backward in interpret mode, as tests/test_kernels.py runs
it on the CPU.

On the CPU the port computes with its plain versions
(`flash_attention_plain`, `flash_attention_bwd_plain`); the CUDA kernels
are held against those on the card (`test_bwd_kernels_match_plain_on_card`,
chip_smoke.py). Inputs come from numpy with a seed; float32 throughout,
atol 5e-5 / rtol 5e-4, the tolerance of the reference's own gradient test
(tests/test_kernels.py::test_gradients_match_reference).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload.kernels import flash as jflash  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload.kernels import flash as tflash  # noqa: E402

ATOL, RTOL = 5e-5, 5e-4


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=16),
    dict(causal=True, q_offset=48, kv_offset=16),
], ids=["causal", "non_causal", "window16", "offsets"])
def test_plain_bwd_matches_jax_bwd_kernel(kw):
    """`flash_attention_bwd_plain` against the JAX `_bwd` (K2 + K3 in
    interpret mode) on the same (o, lse, dO, dlse)."""
    b, t, h, d = 2, 64, 2, 32
    q, k, v, do = _arrays([(b, t, h, d)] * 4, seed=11)
    (dlse,) = _arrays([(b, h, t)], seed=12)
    scale = d ** -0.5
    cfg = jflash._Cfg(scale=scale, causal=kw["causal"], block_q=16,
                      block_k=16, interpret=True, window=kw.get("window", 0))
    offsets = jnp.asarray([[kw.get("q_offset", 0), kw.get("kv_offset", 0)]],
                          jnp.int32)
    bhtd = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v, do)]
    jo, jlse = jflash._fwd(cfg, offsets, *bhtd[:3])
    jdlse = jnp.broadcast_to(jnp.asarray(dlse)[..., None], jlse.shape)
    jdq, jdk, jdv = jflash._bwd(cfg, offsets, *bhtd[:3], jo, jlse, bhtd[3],
                                jdlse)
    mask = {key: kw[key] for key in kw}
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to = torch.from_numpy(np.asarray(jo).transpose(0, 2, 1, 3).copy())
    tlse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    got = tflash.flash_attention_bwd_plain(
        tq, tk, tv, to, tlse, tdo, torch.from_numpy(dlse), scale, **mask)
    for g, w in zip(got, (jdq, jdk, jdv)):
        _close(g.numpy(), np.asarray(w).transpose(0, 2, 1, 3))


def _grads_both(q, k, v, w_o, w_l, scale, **kw):
    """Gradients of sum(sin(o) * w_o) + sum(lse * w_l) through the JAX
    kernel (interpret mode) and through the port's Function."""

    def jloss(q, k, v):
        o, lse = jflash.flash_attention_with_lse(
            q, k, v, scale, block_q=16, block_k=16, interpret=True, **kw)
        return jnp.sum(jnp.sin(o) * w_o) + jnp.sum(lse * w_l)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tflash.flash_attention_with_lse(tq, tk, tv, scale, **kw)
    loss = (o.sin() * torch.from_numpy(w_o)).sum() \
        + (lse * torch.from_numpy(w_l)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False), dict(window=16), dict(window=64),
    dict(q_offset=96, kv_offset=32),
], ids=["causal", "non_causal", "window16", "window64", "offsets"])
@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o_and_lse"])
def test_function_grads_match_jax_grad(kw, with_lse):
    b, t, h, d = 1, 64, 2, 32
    q, k, v, w_o = _arrays([(b, t, h, d)] * 4, seed=21)
    w_l = _arrays([(b, h, t)], seed=22)[0] if with_lse \
        else np.zeros((b, h, t), np.float32)
    got, want = _grads_both(q, k, v, w_o, w_l, d ** -0.5, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_all_future_rows_give_zero_gradients():
    q, k, v, w_o = _arrays([(1, 32, 2, 16)] * 4, seed=5)
    w_l = np.zeros((1, 2, 32), np.float32)
    got, want = _grads_both(q, k, v, w_o, w_l, 0.25, q_offset=0,
                            kv_offset=1000)
    for g, w in zip(got, want):
        assert not g.any() and not w.any()


def test_gqa_gradients_through_expand_kv():
    """Grouped-query attention: K/V heads repeated by `_expand_kv` before
    the kernel, gradients summed back over each group, as JAX's."""
    cfg = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=1,
               d_ff=64, max_seq=64)
    jcfg, tcfg = jmodel.TransformerConfig(**cfg), \
        tmodel.TransformerConfig(**cfg)
    b, t, d = 2, 32, 8
    q, w_o = _arrays([(b, t, 4, d)] * 2, seed=31)
    k, v = _arrays([(b, t, 2, d)] * 2, seed=32)
    scale = d ** -0.5

    def jloss(q, k, v):
        k, v = jmodel._expand_kv(jcfg, k, v)
        o = jflash.flash_attention(q, k, v, scale, block_q=16, block_k=16,
                                   interpret=True)
        return jnp.sum(jnp.sin(o) * w_o)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ek, ev = tmodel._expand_kv(tcfg, tk, tv)
    o = tflash.flash_attention(tq, ek, ev, scale)
    got = torch.autograd.grad((o.sin() * torch.from_numpy(w_o)).sum(),
                              (tq, tk, tv))
    assert got[1].shape == (b, t, 2, d)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kw", [dict(), dict(window=5, causal=False),
                                dict(q_offset=7, kv_offset=2)],
                         ids=["causal", "window_noncausal", "offsets"])
def test_function_agrees_with_autograd_through_plain_forward(kw):
    """The Function's hand-written backward against PyTorch's autograd
    through `flash_attention_plain`, on ragged lengths (Tq 21, Tk 29)."""
    q, = _arrays([(2, 21, 3, 16)], seed=41)
    k, v = _arrays([(2, 29, 3, 16)] * 2, seed=42)
    w_o, = _arrays([(2, 21, 3, 16)], seed=43)
    w_l, = _arrays([(2, 3, 21)], seed=44)
    res = []
    for fn in (tflash.flash_attention_with_lse, tflash.flash_attention_plain):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v))
        o, lse = fn(tq, tk, tv, 0.3, **kw)
        loss = (o.cos() * torch.from_numpy(w_o)).sum() \
            + (lse * torch.from_numpy(w_l)).sum()
        res.append(torch.autograd.grad(loss, (tq, tk, tv)))
    for g, w in zip(*res):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


def test_cpu_backward_counts_no_launch_and_equals_plain():
    q, k, v, do = (torch.from_numpy(x)
                   for x in _arrays([(1, 32, 2, 16)] * 4, seed=51))
    o, lse = tflash.flash_attention_plain(q, k, v, 0.25)
    before = (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    got = tflash.flash_attention_bwd(q, k, v, o, lse, do, None, 0.25)
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, None, 0.25)
    assert (tflash.flash_bwd_dq.launches,
            tflash.flash_bwd_dkv.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the per-kernel wrappers take the same plain version on CPU tensors;
    # K2's also gives the delta K3 reads
    delta = tflash._delta(o, do, None)
    dq, dq_delta = tflash.flash_bwd_dq(q, k, v, o, do, lse, None, 0.25)
    assert torch.equal(dq, want[0])
    assert torch.equal(dq_delta, delta)
    for g, w in zip(tflash.flash_bwd_dkv(q, k, v, do, lse, delta, 0.25),
                    want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_dlse", [False, True], ids=["no_dlse", "dlse"])
def test_delta_route_matches_jax_bwd_delta(with_dlse):
    """The delta that `flash_attention_bwd` hands K3 on the CPU (K2's
    ``_delta`` + ``_dq_plain`` pair, the plain version of the sm90 K2 that
    computes delta itself) equals the JAX ``_bwd``'s formula
    (flash.py:290-294: rowsum(dO * O) in float32, minus the lse cotangent),
    and its dq equals the JAX ``_bwd``'s on the same (o, lse, dO, dlse)."""
    b, t, h, d = 2, 48, 2, 32
    q, k, v, do = _arrays([(b, t, h, d)] * 4, seed=13)
    (dlse,) = _arrays([(b, h, t)], seed=14)
    scale = d ** -0.5
    cfg = jflash._Cfg(scale=scale, causal=True, block_q=16, block_k=16,
                      interpret=True, window=0)
    offsets = jnp.zeros((1, 2), jnp.int32)
    bhtd = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v, do)]
    jo, jlse = jflash._fwd(cfg, offsets, *bhtd[:3])
    jdlse = jnp.broadcast_to(jnp.asarray(dlse)[..., None], jlse.shape) \
        if with_dlse else None
    want = jnp.sum(bhtd[3].astype(jnp.float32) * jo.astype(jnp.float32),
                   axis=-1)
    if with_dlse:
        want = want - jnp.asarray(dlse)
    jdq = jflash._bwd(cfg, offsets, *bhtd[:3], jo, jlse, bhtd[3], jdlse)[0]
    to = torch.from_numpy(np.asarray(jo).transpose(0, 2, 1, 3).copy())
    tlse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    dq, delta = tflash.flash_bwd_dq(
        tq, tk, tv, to, tdo, tlse,
        torch.from_numpy(dlse) if with_dlse else None, scale)
    assert delta.shape == (b, h, t) and delta.dtype == torch.float32
    _close(delta.numpy(), np.asarray(want))
    _close(dq.numpy(), np.asarray(jdq).transpose(0, 2, 1, 3))


@pytest.mark.cuda
def test_bwd_kernels_match_plain_on_card():
    """K2 and K3 against the plain backward on the card: bf16 (the sm90
    instances) and float32 (mma), causal, windowed, offset and ragged, with
    an lse cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        for tq, tk, kw in ((256, 256, {}), (200, 200, dict(window=48)),
                           (70, 130, dict(q_offset=96, kv_offset=32))):
            q = torch.randn((2, tq, 4, 64), generator=gen,
                            device="cuda").to(dt).requires_grad_()
            k, v = (torch.randn((2, tk, 4, 64), generator=gen,
                                device="cuda").to(dt).requires_grad_()
                    for _ in range(2))
            do = torch.randn((2, tq, 4, 64), generator=gen,
                             device="cuda").to(dt)
            dlse = torch.randn((2, 4, tq), generator=gen, device="cuda")
            o, lse = tflash.flash_attention_with_lse(q, k, v, 0.125, **kw)
            before = (tflash.flash_bwd_dq.launches,
                      tflash.flash_bwd_dkv.launches)
            got = torch.autograd.grad((o, lse), (q, k, v), (do, dlse))
            torch.cuda.synchronize()
            assert (tflash.flash_bwd_dq.launches,
                    tflash.flash_bwd_dkv.launches) == (before[0] + 1,
                                                       before[1] + 1)
            want = tflash.flash_attention_bwd_plain(
                q.detach(), k.detach(), v.detach(), o.detach(),
                lse.detach(), do, dlse, 0.125, **kw)
            for g, w in zip(got, want):
                err = (g.float() - w.float()).abs().max().item()
                assert err <= tol * w.float().abs().max().item()
