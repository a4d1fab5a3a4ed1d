"""The Hopper instances of the port's flash kernels (K1 ``flash_fwd_sm90``,
K2 ``flash_bwd_dq_sm90``, K3 ``flash_bwd_dkv_sm90``) and the shape rule
that picks them.

On the CPU the rule, the per-instance launch counts, the operand check
that lets packed q/k/v views reach the kernels uncopied, and the
profile's kernel categories are tested directly; the plain versions are
held against the JAX package's Pallas kernels (interpret mode) at the
head dims the sm90 instances take. The kernels themselves are held
against the plain versions on the card by the ``cuda``-marked test below
and by chip_smoke.py. Inputs come from numpy with a seed; float32 on the
CPU with the tolerances of tests/test_torch_flash*.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubegpu_tpu_torch.workload.kernels import flash as tflash  # noqa: E402

FWD_TOL = 2e-5                 # the reference's forward kernel tests
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4  # the reference's gradient test
ROOT = Path(__file__).resolve().parents[1]


def _jax():
    """(jax, jax.numpy, the JAX package's flash module), imported here so
    that the card test runs where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from kubegpu_tpu.workload.kernels import flash as jflash

    return jax, jax.numpy, jflash


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _all_counts():
    return [dict(fn.launches_by_instance) for fn in (
        tflash.flash_attention_with_lse, tflash.flash_bwd_dq,
        tflash.flash_bwd_dkv)]


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"),
    (torch.bfloat16, 32, "mma"),
    (torch.float32, 32, "mma"),
    (torch.float32, 64, "mma"),
    (torch.float32, 128, "mma"),
])
def test_instance_rule(dtype, d, want):
    assert tflash._instance(dtype, d) == want


@pytest.mark.parametrize("d", [16, 48, 96, 256])
def test_instance_rule_refuses_unsupported_head_dim(d):
    with pytest.raises(ValueError, match="head_dim"):
        tflash._instance(torch.bfloat16, d)


def test_instances_have_counters_and_symbols():
    assert set(tflash.flash_attention_with_lse.launches_by_instance) \
        == {"sm90", "mma"}
    assert set(tflash.flash_bwd_dkv.launches_by_instance) == {"sm90", "mma"}
    assert set(tflash.flash_bwd_dq.launches_by_instance) == {"sm90", "mma"}
    assert set(tflash._LIBS) == {"sm90", "mma"}
    for inst, libs in tflash._LIBS.items():
        assert set(libs) == {"fwd", "dq", "dkv"}
        for lib, symbol in libs.values():
            assert (ROOT / "kubegpu_tpu_torch" / "csrc" /
                    f"{lib}.cu").exists()
            assert symbol.startswith("kgt_flash_") and symbol.endswith(inst)
    assert tflash._LIBS["sm90"]["dq"][0] == "flash_bwd_dq_sm90"
    assert (ROOT / "kubegpu_tpu_torch" / "csrc" /
            "flash_bwd_dq_sm90.cu").exists()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_count_no_launch_on_any_instance(dtype):
    q, k, v, do = (torch.from_numpy(x).to(dtype).requires_grad_()
                   for x in _arrays([(1, 32, 2, 128)] * 4, seed=61))
    before = _all_counts()
    assert all(set(c) == {"sm90", "mma"} for c in before)
    launches = (tflash.flash_attention_with_lse.launches,
                tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    o, lse = tflash.flash_attention_with_lse(q, k, v, 128 ** -0.5)
    torch.autograd.grad((o, lse), (q, k, v),
                        (do.detach(), torch.ones_like(lse)))
    # K2 called directly, with its instance named too
    for inst in (None, "sm90", "mma"):
        tflash.flash_bwd_dq(q.detach(), k.detach(), v.detach(), o.detach(),
                            do.detach(), lse.detach(), None, 128 ** -0.5,
                            instance=inst)
    assert _all_counts() == before
    assert (tflash.flash_attention_with_lse.launches,
            tflash.flash_bwd_dq.launches,
            tflash.flash_bwd_dkv.launches) == launches


@pytest.mark.parametrize("d", [64, 128])
def test_packed_qkv_views_reach_the_kernel_uncopied(d):
    """Views of one [B, T, 3, H, D] bf16 tensor meet the TMA maps' terms
    (16-byte base, strides in multiples of 8 elements) and are not
    copied; an expanded view and an odd stride are."""
    qkv = torch.zeros((2, 40, 3, 4, d), dtype=torch.bfloat16)
    for x in qkv.unbind(2):
        assert tflash._kernel_operand(x) is x
        assert tflash._kernel_operand(x).data_ptr() == x.data_ptr()
    expanded = torch.zeros((2, 40, 1, d), dtype=torch.bfloat16).expand(
        2, 40, 4, d)
    copied = tflash._kernel_operand(expanded)
    assert copied is not expanded and copied.is_contiguous()
    odd = torch.zeros((2, 40, 4, d + 4), dtype=torch.bfloat16)[..., :d]
    assert tflash._kernel_operand(odd).is_contiguous()


def _profile_category():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_slice", ROOT / "tools" / "profile_torch_slice.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._category


@pytest.mark.parametrize("kernel,want", [
    ("void (anonymous namespace)::flash_fwd_sm90<128>((anonymous "
     "namespace)::Params)", "K1 flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dkv_sm90<128>((anonymous "
     "namespace)::Params)", "K3 flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_fwd_bf16<32>((anonymous "
     "namespace)::Params)", "K1 flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dkv_bf16<128>((anonymous "
     "namespace)::BwdParams)", "K3 flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dq_bf16<128>((anonymous "
     "namespace)::BwdParams)", "K2 flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dq_sm90<128>((anonymous "
     "namespace)::Params)", "K2 flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dq_sm90<64>((anonymous "
     "namespace)::Params)", "K2 flash_bwd_dq"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "gemm"),
])
def test_profile_files_sm90_kernels_under_their_kernel(kernel, want):
    assert _profile_category()(kernel) == want


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kw", [dict(), dict(causal=False),
                                dict(window=16, q_offset=8, kv_offset=8)],
                         ids=["causal", "non_causal", "window_offsets"])
def test_plain_forward_matches_jax_at_sm90_head_dims(d, kw):
    _, jnp, jflash = _jax()
    q, k, v = _arrays([(1, 48, 2, d)] * 3, seed=62)
    scale = d ** -0.5
    jo, jl = jflash.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), scale, block_q=16,
        block_k=16, interpret=True, **kw)
    to, tl = tflash.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), scale, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_plain_dkv_matches_jax_grad_at_sm90_head_dims(d):
    """K3's plain version (through the Function's backward) against the
    gradients of the JAX kernel in interpret mode, with an lse cotangent."""
    jax, jnp, jflash = _jax()
    b, t, h = 1, 48, 2
    q, k, v, w_o = _arrays([(b, t, h, d)] * 4, seed=63)
    (w_l,) = _arrays([(b, h, t)], seed=64)
    scale = d ** -0.5

    def jloss(q, k, v):
        o, lse = jflash.flash_attention_with_lse(
            q, k, v, scale, block_q=16, block_k=16, interpret=True)
        return jnp.sum(jnp.sin(o) * w_o) + jnp.sum(lse * w_l)

    want = jax.grad(jloss, argnums=(1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tflash.flash_attention_with_lse(tq, tk, tv, scale)
    loss = (o.sin() * torch.from_numpy(w_o)).sum() \
        + (lse * torch.from_numpy(w_l)).sum()
    got = torch.autograd.grad(loss, (tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


@pytest.mark.parametrize("d", [64, 128])
def test_plain_dq_matches_jax_grad_at_sm90_head_dims(d):
    """K2's plain version (through the Function's backward: `_delta`, then
    dQ) against the gradient of the JAX kernel in interpret mode, with an
    lse cotangent."""
    jax, jnp, jflash = _jax()
    b, t, h = 1, 48, 2
    q, k, v, w_o = _arrays([(b, t, h, d)] * 4, seed=65)
    (w_l,) = _arrays([(b, h, t)], seed=66)
    scale = d ** -0.5

    def jloss(q, k, v):
        o, lse = jflash.flash_attention_with_lse(
            q, k, v, scale, block_q=16, block_k=16, interpret=True)
        return jnp.sum(jnp.sin(o) * w_o) + jnp.sum(lse * w_l)

    want = jax.grad(jloss, argnums=0)(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tflash.flash_attention_with_lse(tq, tk, tv, scale)
    loss = (o.sin() * torch.from_numpy(w_o)).sum() \
        + (lse * torch.from_numpy(w_l)).sum()
    (got,) = torch.autograd.grad(loss, (tq,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)


@pytest.mark.cuda
def test_sm90_kernels_match_plain_on_card():
    """K1, K2 and K3's sm90 instances against the plain versions on the
    card at D = 128: causal on one tile and on a ragged multi-stage
    length, non-causal ragged, and strided views of a packed q/k/v tensor,
    which reach the kernels uncopied; the delta that the sm90 K2 emits
    against `_delta`, with and without an lse cotangent. bf16 tolerances
    as chip_smoke.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    for b, tq, tk, kw, strided in ((1, 64, 64, {}, False),
                                   (1, 2085, 2085, {}, False),
                                   (1, 70, 300, dict(causal=False), False),
                                   (2, 256, 256, {}, True)):
        if strided:
            q, k, v = torch.randn((b, tq, 3, 2, 128), generator=gen,
                                  device="cuda").to(bf16).unbind(2)
            for x in (q, k, v):
                assert tflash._kernel_operand(x).data_ptr() == x.data_ptr()
        else:
            q = torch.randn((b, tq, 2, 128), generator=gen,
                            device="cuda").to(bf16)
            k, v = (torch.randn((b, tk, 2, 128), generator=gen,
                                device="cuda").to(bf16) for _ in range(2))
        do = torch.randn((b, tq, 2, 128), generator=gen,
                         device="cuda").to(bf16)
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        before = _all_counts()
        o, lse = tflash.flash_attention_with_lse(q, k, v, 0.088, **kw)
        got = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        after = _all_counts()
        for was, now in zip(before, after):
            assert now == dict(was, sm90=was["sm90"] + 1)
        ro, rl = tflash.flash_attention_plain(q.detach(), k.detach(),
                                              v.detach(), 0.088, **kw)
        assert (o.float() - ro.float()).abs().max().item() <= 2e-2
        assert (lse - rl).abs().max().item() <= 1e-3
        want = tflash.flash_attention_bwd_plain(
            q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
            None, 0.088, **kw)
        for g, w in zip(got, want):
            err = (g.float() - w.float()).abs().max().item()
            assert err <= 1e-2 * w.float().abs().max().item()
        for dlse in (None, torch.randn(lse.shape, generator=gen,
                                       device="cuda")):
            dq, delta = tflash.flash_bwd_dq(
                q.detach(), k.detach(), v.detach(), o.detach(), do,
                lse.detach(), dlse, 0.088, **kw)
            ref = tflash._delta(o.detach(), do, dlse)
            err = (delta - ref).abs().max().item()
            assert err <= 1e-4 * ref.abs().max().item()
            if dlse is None:
                assert torch.equal(dq, got[0])


@pytest.mark.cuda
def test_remat_dots_step_keeps_k1_outputs_on_card():
    """A remat "dots" step through autograd on the card: one K1, K2 and K3
    launch a layer, all on the sm90 instance (the recompute returns the
    kept outputs of K1 instead of launching it again, which "full" does),
    and the gradients of "none"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    import dataclasses

    from kubegpu_tpu_torch.workload.model import (TransformerConfig,
                                                  init_params, make_loss_fn)
    from kubegpu_tpu_torch.workload.train import param_leaves

    cfg = TransformerConfig(vocab=256, d_model=256, n_heads=2, n_layers=2,
                            d_ff=512, max_seq=256, attn_impl="flash")
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    leaves = param_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    tokens = torch.randint(0, 256, (2, 257), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    grads, counts = {}, {}
    for remat in ("none", "dots", "full"):
        before = _all_counts()
        loss = make_loss_fn(dataclasses.replace(cfg, remat=remat))(params,
                                                                    tokens)
        grads[remat] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        counts[remat] = [now["sm90"] - was["sm90"]
                         for was, now in zip(before, _all_counts())]
    assert counts == {"none": [2, 2, 2], "dots": [2, 2, 2],
                      "full": [4, 2, 2]}
    for g, w in zip(grads["dots"], grads["none"]):
        err = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert err <= 1e-2


@pytest.mark.cuda
def test_sm90_kernels_at_ring_offsets_on_card():
    """K1, K2 and K3's sm90 instances at every (q_offset, kv_offset) pair a
    ring of 4 gives (blocks of 128 at D = 128), with an lse cotangent,
    against the plain versions: the blocks of the future (kv_offset >
    q_offset) see no key and give O = 0, lse <= -1e20 and zero gradients;
    the diagonal and past blocks the bf16 tolerances of chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    t, sp, scale = 128, 4, 128 ** -0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v, do = (rnd(2, t * sp, 2, 128).to(torch.bfloat16)
                   for _ in range(4))
    for i in range(sp):
        for src in range(sp):
            kw = dict(q_offset=i * t, kv_offset=src * t)
            qb, dob = (x[:, i * t:(i + 1) * t] for x in (q, do))
            kb, vb = (x[:, src * t:(src + 1) * t] for x in (k, v))
            dlse = rnd(2, 2, t)
            before = _all_counts()
            o, lse = tflash.flash_attention_with_lse(qb, kb, vb, scale, **kw)
            dq, delta = tflash.flash_bwd_dq(qb, kb, vb, o, dob, lse, dlse,
                                            scale, **kw)
            dk, dv = tflash.flash_bwd_dkv(qb, kb, vb, dob, lse, delta,
                                          scale, **kw)
            torch.cuda.synchronize()
            for was, now in zip(before, _all_counts()):
                assert now == dict(was, sm90=was["sm90"] + 1)
            grads = (dq, dk, dv)
            assert all(bool(torch.isfinite(x).all())
                       for x in (o, lse, *grads))
            if src > i:
                assert o.abs().max().item() == 0.0
                assert lse.max().item() <= -1e20
                assert all(not g.any() for g in grads)
                continue
            ro, rl = tflash.flash_attention_plain(qb, kb, vb, scale, **kw)
            assert (o.float() - ro.float()).abs().max().item() <= 2e-2
            assert (lse - rl).abs().max().item() <= 1e-3
            want = tflash.flash_attention_bwd_plain(qb, kb, vb, o, lse, dob,
                                                    dlse, scale, **kw)
            for g, w in zip(grads, want):
                err = (g.float() - w.float()).abs().max().item()
                assert err <= 1e-2 * w.float().abs().max().item()
