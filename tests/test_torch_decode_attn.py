"""The decode attention kernel's wrapper and plain version
(``kubegpu_tpu_torch/workload/kernels/decode_attn.py``, K4) and the
decode step's dispatch to it (``decode.make_forward_step``).

On the CPU: `decode_attention_plain` (and the wrapper, which takes it for
CPU tensors) equals the decode step's attention as it was written before
the kernel (`_attend_before`, copied here) at GQA widths 1, 2 and 4,
ragged per-row positions including 0 and ``S_max - 1``, a window shorter
than ``S_max`` and a scalar position, bit for bit; the forward step's
logits equal those of the step with that attention, at T = 1 and T > 1,
and launch nothing; the dispatch predicate; the limit `TOL_DECODE_REL`
passes K4's arithmetic (split, rounded as the kernel rounds) and fails
K/V stored in float8 and a dropped key at ``pos``. On the card
(``cuda``-marked, skipped without one): the kernel against the plain
version at the three serving cells' shapes and tiny ones, with and
without a window, NaN outside every row's live span, the float8 control;
`make_generate` and the speculative draft each launch checked against
the plain version; one ``DecodeServer.step()`` launching it ``chunk x
n_layers`` times. No JAX here: the card tests run where it is not
installed.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.workload import decode as tdecode  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload.kernels import \
    decode_attn as dattn  # noqa: E402

NEG_INF = -1e30
# K4 against the plain version: the largest relative L2 error of a row of
# the bf16 output, as chip_smoke.py's TOL_DECODE_REL. Both round O to bf16
# after rounding P to bf16 at different points (the kernel against its
# split's running max, the plain version after normalising): about 0.3% at
# the serving cells' shapes. K/V stored in float8 e4m3 give about 3.7%,
# and dropping the key at ``pos`` (whose V `_plant_edges` sets to 16) 20%
# or more: both fail.
TOL_DECODE_REL = 1e-2
EDGE_V = 16.0


def _attend_before(q, ck, cv, mask, scale, dt):
    """The decode step's attention before the kernel
    (``decode.make_forward_step``'s ``attend``), as it was written."""
    b, t, hq, d = q.shape
    hk = ck.shape[2]
    if hk != hq:
        rep = hq // hk
        qg = q.reshape(b, t, hk, rep, d)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck) * scale
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bgrqk,bkgd->bqgrd",
                            p.to(dt).float(), cv)
        return attn.reshape(b, t, hq, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ck) * scale
    s = s.masked_fill(~mask[:, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), cv)


def _mask_before(positions, s_max, window):
    """The step's mask before the kernel: ``positions [B, T]``."""
    kv_pos = torch.arange(s_max)
    q_pos = positions[:, :, None]
    mask = kv_pos[None, None, :] <= q_pos
    if window:
        mask &= kv_pos[None, None, :] > q_pos - window
    return mask


def _case(b, s_max, hq, hkv, d, dt, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(device=device, dtype=dt)
               for shape in ((b, 1, hq, d), (b, s_max, hkv, d),
                             (b, s_max, hkv, d)))
    return q, k, v


def _rel_err(got, want, sync=True):
    """The largest relative L2 error of a row of ``got`` (all its heads)
    against ``want``'s, in float32; a row where both are zero errs by 0.
    Per row, so rows whose output a planted edge value dominates (a small
    ``pos``) do not dilute the others."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    err = ((got - want).norm(dim=1)
           / want.norm(dim=1).clamp_min(1e-30)).max()
    return err.item() if sync else err


def _plant_edges(v, pos, window):
    """Set V at each row's ``pos`` and at the first position of its
    window to `EDGE_V`, so a kernel that drops either key errs by far
    more than `TOL_DECODE_REL`."""
    rows = torch.arange(v.shape[0], device=v.device)
    v[rows, pos] = EDGE_V
    if window:
        v[rows, (pos - window + 1).clamp(min=0)] = EDGE_V


def _outside_span(pos, s_max, window):
    """``[B, S_max]``: true where a position is not live for its row."""
    kv = torch.arange(s_max, device=pos.device)[None, :]
    out = kv > pos[:, None]
    if window:
        out |= kv <= pos[:, None] - window
    return out


# (B, S_max, Hq, Hkv, D, positions, window): GQA widths 1, 2 and 4
CASES = {
    "mha_ragged": (4, 48, 4, 4, 16, [0, 47, 13, 30], 0),
    "gqa2_ragged": (4, 40, 4, 2, 8, [39, 0, 7, 21], 0),
    "gqa4_ragged": (3, 64, 8, 2, 16, [63, 1, 0], 0),
    "gqa4_window": (4, 64, 8, 2, 16, [63, 5, 20, 40], 12),
    "gqa2_window_past_start": (2, 32, 4, 2, 8, [3, 31], 16),
    "mha_scalar": (3, 32, 2, 2, 16, 17, 0),
    "gqa4_scalar_window": (2, 48, 4, 1, 8, 47, 10),
}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_the_step_attention_before(name, dt):
    b, s_max, hq, hkv, d, pos, window = CASES[name]
    q, k, v = _case(b, s_max, hq, hkv, d, dt)
    scale = d ** -0.5
    rows = torch.full((b,), pos) if isinstance(pos, int) \
        else torch.tensor(pos)
    want = _attend_before(q, k.float(), v.float(),
                          _mask_before(rows[:, None], s_max, window), scale,
                          dt).to(dt)
    pos_arg = pos if isinstance(pos, int) else torch.tensor(pos)
    got = dattn.decode_attention_plain(q, k, v, pos_arg, scale, window)
    assert got.dtype == dt and got.shape == (b, 1, hq, d)
    assert torch.equal(got, want)
    before = dattn.decode_attention.launches
    assert torch.equal(dattn.decode_attention(q, k, v, pos_arg, scale,
                                              window), want)
    assert dattn.decode_attention.launches == before


SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64, attn_impl="xla")
VARIANTS = {"dense": {}, "gqa2": dict(n_kv_heads=2),
            "gqa4_windowed": dict(n_kv_heads=1, attn_window=8)}


def _step_before(monkeypatch, cfg):
    """The forward step with the attention as written before the kernel."""
    dt = cfg.compute_dtype()
    monkeypatch.setattr(
        tdecode, "grouped_attention",
        lambda q, ck, cv, mask, scale: _attend_before(q, ck, cv, mask,
                                                      scale, dt))
    return tdecode.make_forward_step(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_step_logits_equal_before_and_launch_nothing_on_cpu(
        monkeypatch, variant, dtype):
    """A prefill (T > 1) then single-token steps at ragged per-row and at
    scalar positions: the same logits and caches as the step with the
    attention as written before, bit for bit, and no kernel launch."""
    cfg = tmodel.TransformerConfig(**SMALL, **VARIANTS[variant], dtype=dtype)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 64, (2, 24)))
    launches = dattn.decode_attention.launches
    calls = metrics.DECODE_ATTN_KERNEL_CALLS.value
    runs = []
    for make in (tdecode.make_forward_step,
                 lambda c: _step_before(monkeypatch, c)):
        step = make(cfg)
        cache = tdecode.init_cache(cfg, 2, 32, device="cpu")
        out = [step(params, cache, toks[:, :12], 0)[0]]
        for i in range(12, 16):                      # scalar positions
            out.append(step(params, cache, toks[:, i:i + 1], i)[0])
        pos = torch.tensor([16, 16])
        for i in range(16, 20):                      # per-row positions
            out.append(step(params, cache, toks[:, i:i + 1], pos)[0])
            pos = pos + 1
        out.append(step(params, cache, toks[:, 20:24], 20)[0])   # T = 4
        runs.append((out, cache))
        monkeypatch.undo()
    (got, got_cache), (want, want_cache) = runs
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(got_cache, want_cache):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
    assert dattn.decode_attention.launches == launches
    assert metrics.DECODE_ATTN_KERNEL_CALLS.value == calls


def _cache(device, dtype=torch.bfloat16, shape=(4, 64, 8, 128)):
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           shape=shape)


@pytest.mark.parametrize("cache,heads,want", [
    (_cache("cuda"), 32, True),
    (_cache("cuda", shape=(4, 64, 8, 64)), 8, True),
    (_cache("cuda", shape=(4, 64, 2, 32)), 32, True),
    (_cache("cuda", shape=(4, 64, 1, 128)), 17, False),   # group of 17
    (_cache("cuda", shape=(4, 64, 8, 96)), 32, False),    # head_dim 96
    (_cache("cuda", shape=(4, 64, 8, 128)), 12, False),   # 12 over 8
    (_cache("cuda", dtype=torch.float32), 32, False),
    (_cache("cpu"), 32, False),
], ids=["mistral", "mha_d64", "group16_d32", "group17", "d96",
        "ragged_group", "float32", "cpu"])
def test_takes(cache, heads, want):
    assert dattn.takes(heads, cache) is want


def test_wrapper_refuses_a_negative_window():
    q, k, v = _case(1, 16, 2, 2, 8, torch.float32)
    with pytest.raises(ValueError, match="window"):
        dattn.decode_attention(q, k, v, 3, 0.1, -1)


def _split_kernel_arithmetic(q, k, v, pos, scale, window, split=256):
    """K4's arithmetic in PyTorch: per row, kv head and split of the key
    axis, float32 scores of the live keys, P = exp(s - the split's max)
    rounded to bf16 before the float32 PV sum, the splits merged by their
    maxima and O rounded to bf16 (the order of float32 sums aside)."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    out = torch.empty_like(q)
    for r in range(b):
        p = int(pos[r])
        lo = max(0, p - window + 1) if window else 0
        for h in range(hkv):
            qh = q[r, 0, h * g:(h + 1) * g].float()
            ms, ls, os_ = [], [], []
            for s0 in range(lo - lo % split, p + 1, split):
                a, e = max(s0, lo), min(s0 + split, p + 1)
                s = qh @ k[r, a:e, h].float().T * scale
                m = s.max(-1, keepdim=True).values
                pb = torch.exp(s - m)
                ms.append(m)
                ls.append(pb.sum(-1, keepdim=True))
                os_.append(pb.to(torch.bfloat16).float()
                           @ v[r, a:e, h].float())
            m = torch.stack(ms).max(0).values
            w = [torch.exp(x - m) for x in ms]
            o = sum(x * y for x, y in zip(os_, w)) \
                / sum(x * y for x, y in zip(ls, w))
            out[r, 0, h * g:(h + 1) * g] = o.to(q.dtype)
    return out


@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("s_max,hq,hkv,d", [(1024, 8, 2, 128),
                                            (600, 4, 4, 64)])
def test_the_limit_passes_split_arithmetic_and_fails_fp8_and_a_dropped_key(
        s_max, hq, hkv, d, window):
    """`TOL_DECODE_REL` against the plain version, with the edges
    planted: K4's arithmetic passes it with room, and the two faults it
    is there to catch fail it with room (K/V stored in float8 e4m3; the
    key at ``pos`` dropped)."""
    b = 4
    q, k, v = _case(b, s_max, hq, hkv, d, torch.bfloat16, seed=5)
    pos = torch.tensor([s_max - 1, s_max // 2, 700 % s_max, 257])
    _plant_edges(v, pos, window)
    scale = d ** -0.5
    want = dattn.decode_attention_plain(q, k, v, pos, scale, window)
    split = _split_kernel_arithmetic(q, k, v, pos, scale, window)
    assert _rel_err(split, want) <= TOL_DECODE_REL / 2
    k8, v8 = (x.to(torch.float8_e4m3fn).to(torch.bfloat16) for x in (k, v))
    fp8 = _split_kernel_arithmetic(q, k8, v8, pos, scale, window)
    assert _rel_err(fp8, want) >= 2 * TOL_DECODE_REL
    dropped = v.clone()
    dropped[torch.arange(b), pos] = 0.0
    assert _rel_err(dattn.decode_attention_plain(
        q, k, dropped, pos, scale, window), want) >= 2 * TOL_DECODE_REL


# -- on the card --------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _card_positions(b, s_max, seed):
    """Ragged positions over the whole cache, 0 and S_max - 1 among
    them."""
    pos = np.random.default_rng(seed).integers(0, s_max, b)
    pos[0], pos[-1] = 0, s_max - 1
    return torch.from_numpy(pos).cuda()


# (B, S_max, Hq, Hkv, D): reasoning and the chat (Mistral, 128 slots),
# longprompt (Mixtral, 64 slots), and tiny ones
CARD_SHAPES = {"mistral_128": (128, 4096, 32, 8, 128),
               "mixtral_64": (64, 4096, 32, 8, 128),
               "tiny_gqa2_d64": (3, 200, 4, 2, 64),
               "tiny_mha_d32": (2, 77, 2, 2, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(name):
    """K4 against the plain version at ragged positions, with and without
    a window shorter than S_max, within `TOL_DECODE_REL`; with NaN
    written at every position outside each row's live span it gives the
    clean cache's output, bit for bit; K/V rounded through float8 e4m3
    (the planted lower precision) err beyond the limit."""
    _need_card()
    b, s_max, hq, hkv, d = CARD_SHAPES[name]
    q, k, v = _case(b, s_max, hq, hkv, d, torch.bfloat16, device="cuda")
    pos = _card_positions(b, s_max, 1)
    scale = d ** -0.5
    for window in (0, max(1, s_max // 3)):
        vw = v.clone()
        _plant_edges(vw, pos, window)
        before = dattn.decode_attention.launches
        got = dattn.decode_attention(q, k, vw, pos, scale, window)
        torch.cuda.synchronize()
        assert dattn.decode_attention.launches == before + 1
        want = dattn.decode_attention_plain(q, k, vw, pos, scale, window)
        assert bool(torch.isfinite(got).all())
        assert _rel_err(got, want) <= TOL_DECODE_REL, (name, window)
        k8, v8 = (x.to(torch.float8_e4m3fn).to(torch.bfloat16)
                  for x in (k, vw))
        control = dattn.decode_attention(q, k8, v8, pos, scale, window)
        assert _rel_err(control, want) > TOL_DECODE_REL, (name, window)
        dk, dv = k.clone(), vw.clone()
        outside = _outside_span(pos, s_max, window)
        dk[outside], dv[outside] = float("nan"), float("nan")
        dirty = dattn.decode_attention(q, dk, dv, pos, scale, window)
        assert bool(torch.isfinite(dirty).all())
        assert torch.equal(dirty, got), (name, window)


def _check_each_launch(monkeypatch) -> list:
    """Make every K4 call of the decode step also run the plain version
    on the same operands; returns the list its relative errors (device
    scalars) are appended to."""
    errs = []
    real = tdecode.decode_attention

    def checked(q, k_cache, v_cache, pos, scale, window=0):
        out = real(q, k_cache, v_cache, pos, scale, window)
        errs.append(_rel_err(out, dattn.decode_attention_plain(
            q, k_cache, v_cache, pos, scale, window), sync=False))
        return out

    monkeypatch.setattr(tdecode, "decode_attention", checked)
    return errs


@pytest.mark.cuda
def test_generate_and_the_speculative_draft_take_the_kernel_on_card(
        monkeypatch):
    """In bf16, `make_generate` (a scalar position for the whole batch)
    and the speculative server's draft steps launch K4, and each launch
    agrees with the plain version on its own operands within
    `TOL_DECODE_REL`."""
    _need_card()
    from kubegpu_tpu_torch.workload.serve import DecodeServer

    cfg = tmodel.TransformerConfig(vocab=256, d_model=256, n_heads=4,
                                   n_kv_heads=2, n_layers=2, d_ff=512,
                                   max_seq=256, attn_window=64)
    dcfg = tmodel.TransformerConfig(vocab=256, d_model=128, n_heads=4,
                                    n_kv_heads=1, n_layers=1, d_ff=256,
                                    max_seq=256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tmodel.init_params(gen, cfg)
    draft = tmodel.init_params(gen, dcfg)
    errs = _check_each_launch(monkeypatch)
    launches = dattn.decode_attention.launches
    tokens = tdecode.make_generate(cfg)(
        params, torch.arange(2 * 40, device="cuda").reshape(2, 40) % 255 + 1,
        12)
    assert tokens.shape == (2, 12)
    assert dattn.decode_attention.launches - launches == 11 * cfg.n_layers
    launches, n_gen = dattn.decode_attention.launches, len(errs)
    srv = DecodeServer(cfg, params, slots=2, draft_params=draft,
                       draft_cfg=dcfg, lookahead=3)
    rids = [srv.submit(list(range(1, 40)), 20),
            srv.submit(list(range(5, 100)), 20)]
    srv.run()
    assert all(len(srv.result(r)) == 20 for r in rids)
    assert srv.spec_proposed > 0
    assert dattn.decode_attention.launches > launches and len(errs) > n_gen
    assert max(float(e) for e in errs) <= TOL_DECODE_REL


@pytest.mark.cuda
def test_server_step_launches_the_kernel_each_layer_and_token_on_card():
    """One fused ``DecodeServer.step()``: the admission prefill (T >= 32)
    launches nothing, the chunk ``chunk x n_layers`` kernels; its tokens
    equal the per-token oracle path's."""
    _need_card()
    import os

    from kubegpu_tpu_torch.workload.serve import DecodeServer

    cfg = tmodel.TransformerConfig(vocab=256, d_model=256, n_heads=4,
                                   n_kv_heads=2, n_layers=2, d_ff=512,
                                   max_seq=256, attn_window=64)
    params = tmodel.init_params(torch.Generator(device="cuda")
                                .manual_seed(0), cfg)
    outs = {}
    for fused in ("1", "0"):
        os.environ["KGTPU_FUSED_SERVE"] = fused
        try:
            srv = DecodeServer(cfg, params, slots=2, chunk=3)
        finally:
            os.environ.pop("KGTPU_FUSED_SERVE", None)
        rids = [srv.submit(list(range(1, 40)), 7),
                srv.submit(list(range(5, 100)), 7)]
        launches = dattn.decode_attention.launches
        calls = metrics.DECODE_ATTN_KERNEL_CALLS.value
        srv.step()
        torch.cuda.synchronize()
        per_step = srv.chunk if fused == "1" else 1
        assert dattn.decode_attention.launches - launches \
            == per_step * cfg.n_layers
        assert metrics.DECODE_ATTN_KERNEL_CALLS.value - calls \
            == per_step * cfg.n_layers
        srv.run()
        outs[fused] = [srv.result(r) for r in rids]
    assert outs["1"] == outs["0"]
