"""The port's mesh layer (kubegpu_tpu_torch.workload.spmd, ring, ulysses,
pipeline) held against the JAX package's on the CPU.

One world of 4 gloo ranks per file (`tests/torch_worlds.job_spmd4`, a
module-scoped fixture): the ranks write their results and each test
asserts one of them. The JAX side runs in this process on the virtual
8-device CPU mesh (`tests/test_workload.py`'s ``cpu8``), its flash kernel
in interpret mode. Inputs come from JAX (``init_params``) or numpy with a
seed; float32, TF32 off. Tolerances, and why:
- ring and Ulysses attention: the reference's own (tests/test_kernels.py,
  tests/test_workload.py): forward atol/rtol 1e-4 (Ulysses 2e-5),
  gradients atol 1e-4 / rtol 1e-3;
- the sharded model: loss within 1e-4 relative, gradients atol 5e-5 /
  rtol 5e-4 (ROADMAP's attention-gradient tolerance);
- the pipeline: the reference test's 1e-5.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubegpu_tpu.workload import model as jmodel  # noqa: E402
from kubegpu_tpu.workload import spmd as jspmd  # noqa: E402
from kubegpu_tpu.workload.lora import lora_pspecs as jlora_pspecs  # noqa: E402
from kubegpu_tpu.workload.ring import make_sharded_ring_attention  # noqa: E402
from kubegpu_tpu_torch.workload import model as tmodel  # noqa: E402
from kubegpu_tpu_torch.workload import ring as tring  # noqa: E402
from kubegpu_tpu_torch.workload import spmd  # noqa: E402
from kubegpu_tpu_torch.workload.lora import lora_pspecs  # noqa: E402
from tests.test_workload import cpu8  # noqa: E402,F401  (fixture reuse)
from tests.torch_worlds import run_world, single_rank_mesh  # noqa: E402

CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq=64, dtype="float32")
RING = (2, 64, 2, 16)                         # B, T, H, D of the ring cases
RING_CASES = [(sp, w, flash) for sp in (2, 4) for w in (0, 16)
              for flash in (False, True)]
MODEL_CASES = [((1, 4, 1), "ring"), ((1, 4, 1), "ulysses"),
               ((1, 1, 4), "ring"), ((1, 1, 4), "ulysses")]
N_MICRO, D_PIPE = 8, 16


def _qkv():
    rng = np.random.default_rng(11)
    return tuple(rng.standard_normal(RING).astype(np.float32)
                 for _ in range(3))


def _pipeline_x():
    return np.random.default_rng(5).standard_normal(
        (N_MICRO, 2, 4, D_PIPE)).astype(np.float32)


def _pipeline_stages(n):
    rng = np.random.default_rng(20 + n)
    return [{"w1": (rng.standard_normal((D_PIPE, D_PIPE)) * 0.3)
             .astype(np.float32),
             "b1": np.zeros(D_PIPE, np.float32),
             "w2": (rng.standard_normal((D_PIPE, D_PIPE)) * 0.3)
             .astype(np.float32)} for _ in range(n)]


@pytest.fixture(scope="module")
def jax_params():
    cfg = jmodel.TransformerConfig(**CFG)
    return cfg, jax.tree.map(np.asarray,
                             jmodel.init_params(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(3).integers(0, CFG["vocab"], (4, 33))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params, tokens):
    """Every rank's results of the 4-rank world."""
    tmp = tmp_path_factory.mktemp("spmd4")
    inputs = {
        "qkv": _qkv(), "ring_cases": RING_CASES, "cfg": CFG,
        "params": jax_params[1], "tokens": tokens,
        "model_cases": MODEL_CASES,
        "pipeline": {n: _pipeline_stages(n) for n in (2, 4)},
        "pipeline_x": _pipeline_x()}
    torch.save(inputs, tmp / "inputs.pt")
    return run_world("tests.torch_worlds.job_spmd4", 4, str(tmp),
                     str(tmp / "out"))


@pytest.fixture(scope="module")
def jax_ring(cpu8):
    """The JAX ring with its flash kernel (interpret): output and the
    gradients of sum(sin(out)), per (sp, window)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    q, k, v = (jnp.asarray(x) for x in _qkv())
    scale = RING[-1] ** -0.5
    out = {}
    for sp in (2, 4):
        mesh = Mesh(np.array(cpu8[:sp]).reshape(1, sp, 1),
                    ("data", "seq", "model"))
        sh = NamedSharding(mesh, P("data", "seq", "model", None))
        args = tuple(jax.device_put(x, sh) for x in (q, k, v))
        for window in (0, 16):
            ring = make_sharded_ring_attention(
                mesh, "data", "seq", "model", scale, use_flash=True,
                interpret=True, window=window)

            def fwd_grad(q, k, v, ring=ring):
                o, vjp = jax.vjp(ring, q, k, v)
                return o, vjp(jnp.cos(o))

            o, g = jax.jit(fwd_grad)(*args)
            out[sp, window] = (np.asarray(o), [np.asarray(x) for x in g])
    return out


def _single_shard(window):
    """The port's single-device attention on the whole sequence: output
    and the gradients of sum(sin(out))."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv())
    o = tmodel._causal_attention(q, k, v, RING[-1] ** -0.5, window=window)
    return o.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        o.sin().sum(), (q, k, v))]


def _in_process_ring(sp, window, flash):
    """Every virtual rank of the ring in this process (InProcessSeqAxis):
    the whole output and the full q/k/v gradients."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv())
    qs, ks, vs = (x.chunk(sp, 1) for x in (q, k, v))
    ring = tring.ring_flash_attention if flash else tring.ring_attention
    o = torch.cat([ring(qs[i], ks[i], vs[i],
                        tring.InProcessSeqAxis(i, ks, vs), RING[-1] ** -0.5,
                        window=window) for i in range(sp)], 1)
    return o.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        o.sin().sum(), (q, k, v))]


def _from_world(world, key):
    """The whole output and gradients from the ranks' blocks, by seq rank
    (ranks that share a seq rank hold the same block)."""
    blocks = {}
    for res in world:
        blocks.setdefault(res[key]["seq_rank"], res[key])
    ordered = [blocks[i] for i in sorted(blocks)]
    out = np.concatenate([b["out"] for b in ordered], 1)
    grads = [np.concatenate([b["grads"][j] for b in ordered], 1)
             for j in range(3)]
    return out, grads


def _close_attention(got, want, fwd_tol=1e-4):
    np.testing.assert_allclose(got[0], want[0], atol=fwd_tol, rtol=fwd_tol)
    for name, a, b in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("n", range(1, 17))
def test_factor3_matches_the_reference(n):
    assert spmd._factor3(n) == jspmd._factor3(n)


def test_make_mesh_refuses_what_it_cannot_build():
    with pytest.raises(RuntimeError, match="needs a process group"):
        spmd.make_mesh(1, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        spmd.mesh_from_env(env={}, device="cpu")
    with single_rank_mesh() as mesh:
        assert mesh.mesh_dim_names == ("data", "seq", "model")
        with pytest.raises(ValueError, match="must span the group"):
            spmd.make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match=r"dp\*sp\*tp=2"):
            spmd.make_mesh(1, 1, 1, 2, device="cpu")
        # a CUDA mesh: no GPU here, or the gloo group cannot serve it
        err = ValueError if torch.cuda.is_available() else RuntimeError
        with pytest.raises(err):
            spmd.make_mesh(1, device="cuda")
    assert not dist.is_initialized()


def test_distributed_init_from_env_forms_the_torchrun_group():
    assert spmd.distributed_init_from_env(env={}, device="cpu") is False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    try:
        assert spmd.distributed_init_from_env(env, device="cpu") is True
        assert dist.get_backend() == "gloo"
        assert spmd.distributed_init_from_env(env, device="cpu") is False
        mesh = spmd.mesh_from_env(env, device="cpu")
        assert tuple(mesh.mesh.shape) == (1, 1, 1)
    finally:
        dist.destroy_process_group()


def test_mesh_from_env_factors_the_world(world):
    names, shape, ranks = world[0]["mesh_from_env"]
    assert names == ("data", "seq", "model")
    assert shape == jspmd._factor3(4) == (1, 1, 4)
    # tp innermost: consecutive ranks are tensor-parallel neighbours
    assert ranks == np.arange(4).reshape(1, 1, 4).tolist()


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_param_pspecs_match_the_reference(kind):
    extra = {"n_experts": 4} if kind == "moe" else {}
    jcfg = jmodel.TransformerConfig(**CFG, **extra)
    tcfg = tmodel.TransformerConfig(**CFG, **extra)

    def dims(spec_tree, tree):
        if isinstance(spec_tree, dict):
            return {k: dims(spec_tree[k], tree[k]) for k in spec_tree}
        if isinstance(spec_tree, list):
            return [dims(s, t) for s, t in zip(spec_tree, tree)]
        return list(spec_tree).index("model") if "model" in spec_tree \
            else None

    specs = spmd.param_pspecs(tcfg)
    assert dims(jspmd.param_pspecs(jcfg), specs) == specs
    targets = ("wq", "wv", "wo")
    lspecs = lora_pspecs(tcfg, targets)
    assert dims(jlora_pspecs(jcfg, targets), lspecs) == lspecs


def test_tensor_parallelism_refuses_indivisible_widths():
    gqa = tmodel.TransformerConfig(**{**CFG, "n_heads": 8},
                                   n_kv_heads=2)
    with pytest.raises(ValueError, match="n_kv_heads 2"):
        spmd.check_tp(gqa, 4)
    spmd.check_tp(gqa, 2)
    with pytest.raises(ValueError, match="n_experts 3"):
        spmd.check_tp(tmodel.TransformerConfig(**CFG, n_experts=3), 2)


@pytest.mark.parametrize("via", ["group", "in_process"])
@pytest.mark.parametrize("sp,window,flash", RING_CASES,
                         ids=[f"sp{s}-w{w}-{'flash' if f else 'plain'}"
                              for s, w, f in RING_CASES])
def test_ring_matches_jax_and_single_shard(world, jax_ring, sp, window,
                                           flash, via):
    """Ring attention (the plain online softmax or the flash kernel's
    plain version at global offsets, merged), forward and gradients,
    through the process group and through the in-process seq axis,
    against the JAX flash ring and against single-device attention."""
    got = (_from_world(world, ("ring", sp, window, flash)) if via == "group"
           else _in_process_ring(sp, window, flash))
    _close_attention(got, jax_ring[sp, window])
    _close_attention(got, _single_shard(window))


def test_ulysses_matches_single_shard(world, cpu8):
    q, k, v = (jnp.asarray(x) for x in _qkv())
    scale = RING[-1] ** -0.5
    o, vjp = jax.vjp(lambda q, k, v: jmodel._causal_attention(q, k, v, scale),
                     q, k, v)
    want = np.asarray(o), [np.asarray(g) for g in vjp(jnp.cos(o))]
    _close_attention(_from_world(world, "ulysses"), want, fwd_tol=2e-5)


def test_ulysses_rejects_indivisible_heads(world):
    msg = world[0]["ulysses_refusal"]
    assert msg is not None and "heads%sp" in msg and "sp=4" in msg


@pytest.mark.parametrize("shape,impl", MODEL_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{i}"
                              for s, i in MODEL_CASES])
def test_sharded_loss_and_grads_match_jax(world, jax_params, tokens, shape,
                                          impl):
    jcfg, params = jax_params
    loss, grads = jax.value_and_grad(jmodel.make_loss_fn(jcfg))(
        params, jnp.asarray(tokens))
    losses = [res[("model", shape, impl)][0] for res in world]
    assert max(losses) == min(losses)        # one global loss, every rank
    assert abs(losses[0] - float(loss)) <= 1e-4 * abs(float(loss))
    got = world[0][("model", shape, impl)][1]
    for (path, want), have in zip(
            jax.tree_util.tree_flatten_with_path(grads)[0],
            jax.tree.leaves(got)):
        np.testing.assert_allclose(have, np.asarray(want), atol=5e-5,
                                   rtol=5e-4,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_sequential(world, stages, cpu8):
    """The GPipe schedule over ``stages`` ranks (the rest replicate it)
    equals the stages run one after another (JAX, vmapped over the
    microbatches, as tests/test_workload_parallel.py)."""
    expected = jnp.asarray(_pipeline_x())
    for p in _pipeline_stages(stages):
        p = {k: jnp.asarray(a) for k, a in p.items()}
        expected = jax.vmap(
            lambda xb, p=p: xb + jnp.tanh(xb @ p["w1"] + p["b1"])
            @ p["w2"])(expected)
    for res in world:
        np.testing.assert_allclose(res[("pipeline", stages)],
                                   np.asarray(expected), atol=1e-5,
                                   rtol=1e-5)
