"""The port's model layers (``repro_torch.models``, ``repro_torch.configs``)
held against the reference's on the CPU.

Inputs and weights are made with numpy from a seed (weights through the
port's own ``*_init``) and handed to both packages.  Tolerances, for
float32 compute: both sides compute the same operations in float32 and
differ only in summation order, so outputs agree to ``F32_RTOL`` /
``F32_ATOL`` (a bf16 computation misses them by two orders).  Integer
outputs (router indices, dispatch tables, drops) are exact.

An autouse fixture checks after every test that the state this process
shares with the reference's tests is as it was: ``repro.obs``'s switch,
hook and sources, torch's default dtype and matmul precision flags, JAX's
x64 and default matmul precision, and no new non-daemon thread.
"""
import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import cache_shapes as jcache_shapes
from repro.models import count_active_params as jcount_active
from repro.models import count_params as jcount_params
from repro.models import derive_segments as jderive_segments
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.parallel.ctx import NO_PARALLEL as JCTX
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import (ModelConfig, MoEConfig, cache_shapes,
                                count_active_params, count_params,
                                derive_segments, init_params)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.parallel import NO_PARALLEL as CTX
from repro_torch.parallel import ParallelCtx

F32_RTOL, F32_ATOL = 2e-5, 2e-5
#: the families the port serves; the rest raise until their slices
SERVED = ("smollm-360m", "granite-34b", "chatglm3-6b", "stablelm-1.6b",
          "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "jamba-1.5-large-398b")


def _shared_state():
    m = torch.backends.cuda.matmul
    return (ref_obs.is_enabled(), ref_obs.hook_installed(), set(ref_obs._SOURCES),
            torch.get_default_dtype(), torch.get_float32_matmul_precision(),
            m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32, jax.config.jax_enable_x64,
            jax.config.jax_default_matmul_precision)


@pytest.fixture(autouse=True)
def shared_state_untouched():
    """The state shared with the reference's tests, as it was before."""
    before = _shared_state()
    threads = set(threading.enumerate())
    yield
    assert _shared_state() == before
    left = [t for t in threading.enumerate()
            if t not in threads and t.is_alive() and not t.daemon]
    assert not left, left


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small eager ops run faster on one thread than on a loaded machine's
    many; the caller's thread count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def tree_numpy(p):
    """A port parameter module (or dict) -> the reference's dict of numpy."""
    if isinstance(p, torch.Tensor):
        return p.detach().numpy()
    return {k: tree_numpy(v) for k, v in p.items()}


def tree_jax(p):
    return jax.tree.map(jnp.asarray, tree_numpy(p))


def reference_params(cfg, params):
    """The port's per-layer modules -> the reference's parameter tree, each
    segment's blocks stacked over its repeats, and the MTP head (numpy
    leaves)."""
    layers = [tree_numpy(blk) for blk in params["layers"]]
    segments, i = [], 0
    for pattern, repeats in derive_segments(cfg):
        per = len(pattern)
        segments.append([jax.tree.map(lambda *xs: np.stack(xs),
                                      *[layers[i + r * per + j] for r in range(repeats)])
                         for j in range(per)])
        i += per * repeats
    tree = {"embed": tree_numpy(params["embed"]), "segments": segments,
            "final_norm": tree_numpy(params["final_norm"])}
    if "mtp" in params:  # the reference stacks its one block on an axis of 1
        mtp = tree_numpy(params["mtp"])
        tree["mtp"] = {**mtp, "block": jax.tree.map(lambda x: x[None], mtp["block"])}
    return tree


def close(got, want, rtol=F32_RTOL, atol=F32_ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _cfg(**kw):
    d = dict(name="t", family="dense", num_layers=1, d_model=32, num_heads=4,
             num_kv_heads=2, d_ff=64, vocab_size=64, head_dim=8, attn_chunk=8,
             compute_dtype="float32")
    d.update(kw)
    return ModelConfig(**d)


# ---------------------------------------------------------------------------
# configs, counts, shapes
# ---------------------------------------------------------------------------


def _shapes(tree):
    """A cache_shapes tree with dtypes as names, comparable across packages."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    shape, dtype = tree
    name = (str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).name)
    return (tuple(shape), name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_counts_and_cache_shapes_match_the_reference(arch):
    for mine, ref in ((get_config(arch), jget_config(arch)),
                      (get_smoke(arch), jget_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert ([(tuple(dataclasses.astuple(s) for s in pat), r)
                 for pat, r in derive_segments(mine)]
                == [(tuple(dataclasses.astuple(s) for s in pat), r)
                    for pat, r in jderive_segments(ref)])
        assert count_params(mine) == jcount_params(ref)
        assert count_active_params(mine) == jcount_active(ref)
        assert _shapes(cache_shapes(mine, 2, 64)) == _shapes(jcache_shapes(ref, 2, 64))


@pytest.mark.parametrize("arch", SERVED)
def test_init_params_counts_and_converts_back(arch):
    """The port's parameters: ``count_params`` of them, float32 on the CPU,
    fan-in scaled, and the reference's tree of them converts back to the
    very same modules."""
    cfg = get_smoke(arch)
    params = init_params(gen(), cfg, device="cpu")
    assert sum(p.numel() for p in params.parameters()) == count_params(cfg)
    assert {p.dtype for p in params.parameters()} == {torch.float32}
    attn = next(blk for blk, spec in zip(params["layers"], cfg.layer_specs())
                if spec.mixer == "attn")
    wq = attn["mixer"]["wdq" if cfg.attention == "mla" else "wq"]
    assert float(wq.detach().abs().max()) <= 2.0 / math.sqrt(cfg.d_model)
    back = dict(model_params_from_numpy(cfg, reference_params(cfg, params),
                                        device="cpu").named_parameters())
    mine = dict(params.named_parameters())
    assert sorted(back) == sorted(mine)
    assert all(torch.equal(back[name], p) for name, p in mine.items())
    # the seed decides the weights
    again = init_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), params.parameters()))


@pytest.mark.parametrize("arch", sorted(set(ARCH_IDS) - set(SERVED)))
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        init_params(0, get_smoke(arch), device="cpu")


def test_init_params_raises_without_a_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, get_smoke("smollm-360m"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ParallelCtx(mesh=object())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_exact_products_hold_until_the_last_concurrent_caller_leaves():
    """Two threads inside ``exact_products`` at once: the first to leave
    does not restore the caller's settings under the other; the last does."""
    m = torch.backends.cuda.matmul
    before = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    first_in, second_in, first_left = (threading.Event() for _ in range(3))
    seen = []

    def first():
        with tlayers.exact_products():
            first_in.set()
            second_in.wait()
        first_left.set()

    def second():
        first_in.wait()
        with tlayers.exact_products():
            second_in.set()
            first_left.wait()
            seen.append((m.allow_tf32, m.allow_bf16_reduced_precision_reduction))

    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = True
    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert seen == [(False, False)]
        assert (m.allow_tf32, m.allow_bf16_reduced_precision_reduction) == (True, True)
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = before


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_apply(norm, dtype):
    cfg = _cfg(norm=norm)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    jx = jnp.asarray(x, dtype)
    got = tlayers.norm_apply(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                             torch.as_tensor(np.array(jx.astype(jnp.float32))).to(
                                 getattr(torch, dtype)))
    want = jax.jit(lambda *a: jlayers.norm_apply(cfg, *a))(p, jx)
    # bf16 outputs: one rounding of the same f32 value, or the next bf16
    tol = (F32_RTOL, F32_ATOL) if dtype == "float32" else (2**-7, 2**-7)
    assert got.dtype == getattr(torch, dtype)
    close(got, want.astype(jnp.float32), *tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
def test_apply_rope(fraction):
    cfg = _cfg(rope_fraction=fraction, rope_theta=500.0)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    for pos in (np.arange(7, dtype=np.int32),
                rng.integers(0, 300, (2, 7)).astype(np.int32)):
        got = tlayers.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(pos))
        want = jax.jit(lambda a, b: jlayers.apply_rope(cfg, a, b))(x, pos)
        close(got, want, what=f"fraction {fraction}, positions {pos.shape}")
    rot = int(16 * fraction) // 2 * 2
    assert torch.equal(got[..., rot:], torch.as_tensor(x)[..., rot:])


def test_sinusoidal_pos():
    for length, d in ((9, 32), (40, 96), (3, 2)):
        want = jax.jit(jlayers.sinusoidal_pos, static_argnums=(0, 1))(length, d)
        close(tlayers.sinusoidal_pos(length, d), want)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False), ("relu_sq", True)])
def test_mlp_apply(act, gated):
    cfg = _cfg(act=act, mlp_gated=gated)
    p = tlayers.mlp_init(gen(3), cfg)
    x = np.random.default_rng(3).normal(size=(2, 5, 32)).astype(np.float32)
    got = tlayers.mlp_apply(cfg, CTX, p, torch.as_tensor(x))
    close(got, jax.jit(lambda *a: jlayers.mlp_apply(cfg, JCTX, *a))(tree_jax(p), x))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


ATTN_CASES = [  # (t, s, hq, hkv, chunk, causal, kv_len, dtype)
    (16, 16, 4, 2, 4, True, None, "float32"),   # GQA groups, several chunks
    (33, 33, 2, 1, 8, True, None, "float32"),   # MQA, padded q and kv chunks
    (12, 20, 6, 3, 5, False, None, "float32"),  # not causal, padded chunks
    (10, 24, 4, 4, 8, False, 13, "float32"),    # ragged kv_len
    (16, 16, 4, 2, 8, True, None, "bfloat16"),  # bf16 operands, f32 scores
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunked_causal_attention(case):
    t, s, hq, hkv, chunk, causal, kv_len, dtype = case
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, n, h, 8)).astype(np.float32)
               for n, h in ((t, hq), (s, hkv), (s, hkv)))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    got = tattn.chunked_causal_attention(tq, tk, tv, chunk=chunk, causal=causal,
                                         kv_len=kv_len)
    want = jax.jit(lambda a, b, c: jattn.chunked_causal_attention(
        a, b, c, chunk=chunk, causal=causal, kv_len=kv_len))(jq, jk, jv)
    assert got.dtype == getattr(torch, dtype)
    # bf16: the f32 results round to bf16 on both sides (at most a bf16 step)
    tol = (F32_RTOL, F32_ATOL) if dtype == "float32" else (2**-7, 2**-7)
    close(got, want.astype(jnp.float32), *tol)


def test_decode_attention():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 1, 6, 8)).astype(np.float32)
    kc, vc = (rng.normal(size=(3, 11, 2, 8)).astype(np.float32) for _ in range(2))
    ref = jax.jit(jattn.decode_attention)
    for length in (1, 7, 11):
        got = tattn.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                                     torch.as_tensor(vc), length)
        close(got, ref(q, kc, vc, length))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_gqa_apply_and_decode(qkv_bias):
    cfg = _cfg(qkv_bias=qkv_bias, rope_fraction=0.5)
    p = tattn.gqa_init(gen(6), cfg)
    if qkv_bias:  # non-zero biases, so that they are exercised
        with torch.no_grad():
            for name in ("bq", "bk", "bv"):
                p[name].normal_(generator=gen(7))
    jp = tree_jax(p)
    rng = np.random.default_rng(6)
    t = 10
    x = rng.normal(size=(2, t, 32)).astype(np.float32)
    pos = np.tile(np.arange(t, dtype=np.int32), (2, 1))
    with torch.no_grad():
        got, (k, v) = tattn.gqa_apply(cfg, CTX, p, torch.as_tensor(x), torch.as_tensor(pos))
    want, (jk, jv) = jax.jit(lambda *a: jattn.gqa_apply(cfg, JCTX, *a))(jp, x, pos)
    close(got, want)
    close(k, jk)
    close(v, jv)

    ck, cv = torch.zeros((2, t, 2, 8)), torch.zeros((2, t, 2, 8))
    jck, jcv = jnp.zeros((2, t, 2, 8)), jnp.zeros((2, t, 2, 8))
    ref_decode = jax.jit(lambda *a: jattn.gqa_decode(cfg, JCTX, *a))
    for i in range(t):
        with torch.no_grad():
            y, ck, cv = tattn.gqa_decode(cfg, CTX, p, torch.as_tensor(x[:, i:i + 1]),
                                         ck, cv, i)
        jy, jck, jcv = ref_decode(jp, x[:, i:i + 1], jck, jcv, jnp.int32(i))
        close(y, jy, what=f"step {i}")
    close(ck, jck)
    close(cv, jcv)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_cfg(**kw):
    m = dict(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0)
    m.update(kw)
    return _cfg(family="moe", moe_pattern=(True,), moe=MoEConfig(**m))


@pytest.mark.parametrize("metric", ["angular", "cosine"])
def test_router_scores(metric):
    m = MoEConfig(num_experts=6, top_k=2, d_ff_expert=8, router_metric=metric)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(12, 32)).astype(np.float32)
    w = rng.normal(size=(6, 32)).astype(np.float32)
    got = tmoe.router_scores(m, torch.as_tensor(x), torch.as_tensor(w))
    want = jax.jit(lambda *a: jmoe.router_scores(m, *a))(x, w)
    # dots: 1e-5 |q||c| (summation order; ROADMAP.md §3); cosines: 1e-5
    scale = (np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(w, axis=1)[None, :]
             if metric == "angular" else 1.0)
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-5 * scale)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_router_topk_and_ties(router):
    m = MoEConfig(num_experts=8, top_k=3, d_ff_expert=8, router=router,
                  route_scale=2.5 if router == "sigmoid" else 1.0)
    s = np.random.default_rng(9).normal(size=(7, 8)).astype(np.float32)
    s[2] = 0.5  # a row of ties: the lowest expert ids, ascending
    s[4, [1, 5, 6]] = 3.0  # a tie at the top
    w, idx, aux = tmoe.router_topk(m, torch.as_tensor(s))
    jw, jidx, jaux = jax.jit(lambda a: jmoe.router_topk(m, a))(s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[2].tolist() == [0, 1, 2] and idx[4].tolist() == [1, 5, 6]
    close(w, jw)
    close(aux, jaux)


def _dispatch_oracle(experts, e, capacity):
    """Slots by a running count per expert, token-major; past capacity
    dropped.  Returns the (E, C) table (``n`` where empty) and the drops."""
    n, k = experts.shape
    table = np.full((e, capacity), n)
    count = np.zeros(e, int)
    drops = 0
    for tok in range(n):
        for j in range(k):
            ex = experts[tok, j]
            if count[ex] < capacity:
                table[ex, count[ex]] = tok
            else:
                drops += 1
            count[ex] += 1
    return table, drops


def test_moe_local_tables_and_drops():
    cfg = _moe_cfg(top_k=1, capacity_factor=0.26)  # capacity 8 of 64 tokens
    p = tmoe.moe_init(gen(10), cfg)
    x = np.random.default_rng(10).normal(size=(64, 32)).astype(np.float32)
    tx = torch.as_tensor(x)
    with torch.no_grad():
        w, idx, _ = tmoe.router_topk(cfg.moe, tmoe.router_scores(cfg.moe, tx, p["router"]))
        cap = tmoe._capacity(cfg.moe, 64)
        table, gather_w, src = tmoe.moe_dispatch(64, w, idx, 4, 0, cap)
        got = tmoe.moe_local(cfg, tx, w, idx, p["wi"], p["wg"], p["wo"], 0, cap)
    want_table, want_drops = _dispatch_oracle(idx.numpy(), 4, cap)
    assert want_drops > 0
    np.testing.assert_array_equal(table.numpy(), want_table)
    assert int((src == 4 * cap).sum()) == want_drops
    kept = src < 4 * cap
    assert torch.equal(gather_w.reshape(-1)[src[kept]], w.reshape(-1)[kept])
    assert torch.equal(table.reshape(-1)[src[kept]], torch.arange(64)[kept])
    jp = tree_jax(p)
    want = jax.jit(lambda *a: jmoe.moe_local(cfg, *a, 0, cap))(
        x, w.numpy(), idx.numpy().astype(np.int32), jp["wi"], jp["wg"], jp["wo"])
    close(got, want)
    dropped = src.reshape(64) == 4 * cap
    assert torch.all(got[dropped] == 0)


def test_moe_apply_with_a_shared_expert():
    cfg = _moe_cfg(num_shared=1)
    p = tmoe.moe_init(gen(11), cfg)
    x = np.random.default_rng(11).normal(size=(2, 6, 32)).astype(np.float32)
    with torch.no_grad():
        got, aux = tmoe.moe_apply(cfg, CTX, p, torch.as_tensor(x))
    want, jaux = jax.jit(lambda *a: jmoe.moe_apply(cfg, JCTX, *a))(tree_jax(p), x)
    close(got, want)
    close(aux, jaux)
