"""DeepSeek-V3 in the port (MLA, sigmoid top-8 routing, the MoE combine,
the MTP head's parameters) held against the reference on the CPU.

Everything runs in float32 at the ``deepseek-smoke`` widths (4 MLA heads,
q_lora 32, kv_lora 16, nope / rope / v 16 / 8 / 16) and at a variant of it
with 16 experts and top-8 routing.  Weights are the port's, drawn from a
seed, stacked into the reference's tree.  Tolerances: the MLA functions and
blocks at ``F32_RTOL`` / ``F32_ATOL`` of ``tests/test_torch_models.py``
(the same operations in float32, another summation order); the serving
path at ``TOL["float32"]`` of ``tests/test_torch_lm_serving.py``; router
indices exact.

The combine is held bitwise.  ``moe_local`` adds each token's expert
outputs onto 0 in ascending (expert, slot) order, as the reference's
scatter-add does; with eight addends a token's sum depends on that order.
The expert GEMMs themselves sum in another order than XLA's (a standing
difference held to a tolerance elsewhere), so the bitwise test feeds the
experts small integers whose products and sums are exact in float32, with
gate pre-activations of 112 or more (where ``silu`` is the identity in
float32): both packages then hold the very same expert outputs, and any
difference left is the combine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.parallel.ctx import NO_PARALLEL as JCTX
from repro.serving import Engine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.convert import cache_from_numpy
from repro_torch.launch import serve
from repro_torch.models import MoEConfig, decode_step, init_cache, init_params, prefill
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import train_loss
from repro_torch.parallel import NO_PARALLEL as CTX
from repro_torch.serving import Engine
from test_torch_lm_serving import TOL, _caches_close, _close
from test_torch_models import (  # noqa: F401  (autouse fixtures)
    close,
    gen,
    one_torch_thread,
    reference_params,
    shared_state_untouched,
)

ARCH = "deepseek-v3-671b"
B, T, STEPS, NEW, MAX_LEN = 2, 12, 4, 6, 24


def _configs(variant: str, absorb: bool = False):
    """(the port's, the reference's) config: ``smoke`` as published,
    ``top8`` with 16 experts and top-8 routing; float32 compute."""
    out = []
    for cfg in (get_smoke(ARCH), jget_smoke(ARCH)):
        kw = {"compute_dtype": "float32",
              "mla": dataclasses.replace(cfg.mla, absorb=absorb)}
        if variant == "top8":
            kw["moe"] = dataclasses.replace(cfg.moe, num_experts=16, top_k=8)
        out.append(dataclasses.replace(cfg, **kw))
    return tuple(out)


@pytest.fixture(scope="module")
def models():
    """Each variant's weights, drawn once for the module: the port's
    modules and the reference's tree of them."""
    out = {}
    for variant in ("smoke", "top8"):
        cfg, _ = _configs(variant)
        params = init_params(gen(0), cfg, device="cpu")
        out[variant] = params, jax.tree.map(jnp.asarray, reference_params(cfg, params))
    return out


# ---------------------------------------------------------------------------
# the combine and the router
# ---------------------------------------------------------------------------


def _exact_experts(rng, n, d, f, e):
    """Tokens and expert weights whose gated MLP is exact in float32:
    integers, gate pre-activations >= 16 * 7 = 112 (silu(g) = g there)."""
    x = rng.integers(1, 4, (n, d)).astype(np.float32)
    wi = rng.integers(-3, 4, (e, d, f)).astype(np.float32)
    wg = rng.integers(7, 10, (e, d, f)).astype(np.float32)
    wo = rng.integers(-3, 4, (e, f, d)).astype(np.float32)
    return x, wi, wg, wo


@pytest.mark.parametrize("top_k", [8, 2])
def test_moe_local_combine_bit_equal_to_the_reference(top_k):
    """64 tokens over 16 experts of capacity 24, drops included: the port's
    ``moe_local`` bit-equal to the reference's on every row.  At top-8 a
    sum in choice order (the port's combine before) differs from it; at
    top-2 it is the same sum, so nothing changes there."""
    n, d, f, e = 64, 16, 8, 16
    cap = 24 if top_k == 8 else 8
    cfg, jcfg = _configs("top8")  # read for nothing but the expert MLP's dtype
    rng = np.random.default_rng(26)
    x, wi, wg, wo = _exact_experts(rng, n, d, f, e)
    experts = np.argsort(rng.normal(size=(n, e)), 1)[:, :top_k]
    weights = rng.uniform(0.05, 1.0, (n, top_k)).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: jmoe.moe_local(jcfg, *a, 0, cap))(
        x, weights, experts.astype(np.int32), wi, wg, wo))
    args = [torch.as_tensor(a) for a in (x, weights, experts, wi, wg, wo)]
    with torch.no_grad():
        got = tmoe.moe_local(cfg, *args, 0, cap)
        table, gather_w, src = tmoe.moe_dispatch(n, args[1], args[2], e, 0, cap)
        ys = tmoe._expert_ffn(cfg, args[3], args[4], args[5], torch.cat(
            [args[0], args[0].new_zeros((1, d))])[table]) * gather_w[..., None]
    assert int((src == e * cap).sum()) > 0
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the choice-order sum of the same expert outputs
    parts = torch.cat([ys.reshape(-1, d), ys.new_zeros((1, d))])[src].reshape(n, top_k, d)
    choice = torch.zeros((n, d))
    for j in range(top_k):
        choice = choice + parts[:, j]
    same = (choice.numpy().view(np.int32) == want.view(np.int32)).all(1)
    assert same.all() if top_k == 2 else not same.all()


def test_router_topk_sigmoid_top8_with_ties():
    """Sigmoid gating at top-8 over 16 experts, scaled by 2.5: indices equal
    to ``jax.lax.top_k``'s, ties in ascending expert order; weights and
    the auxiliary loss within ``F32_*``."""
    m = MoEConfig(num_experts=16, top_k=8, d_ff_expert=8, router="sigmoid",
                  route_scale=2.5)
    s = np.random.default_rng(8).normal(size=(9, 16)).astype(np.float32)
    s[2] = 0.25  # all tied: experts 0..7
    s[4, [1, 5, 6, 9, 12, 13, 14, 15, 3]] = 3.0  # nine tied at the top
    s[6, 8:] = s[6, :8]  # each value twice
    w, idx, aux = tmoe.router_topk(m, torch.as_tensor(s))
    jw, jidx, jaux = jax.jit(lambda a: jmoe.router_topk(m, a))(s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[2].tolist() == list(range(8))
    assert idx[4].tolist() == [1, 3, 5, 6, 9, 12, 13, 14]
    close(w, jw)
    close(aux, jaux)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _inputs(cfg, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, t, cfg.d_model)).astype(np.float32)
    return x, np.tile(np.arange(t, dtype=np.int32), (B, 1))


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_qkv_apply_and_decode(models, absorb):
    """``_mla_qkv``, ``mla_apply`` and ``mla_decode`` step by step from an
    empty latent cache, against the reference: outputs and caches."""
    cfg, jcfg = _configs("smoke", absorb)
    params, jparams = models["smoke"]
    p, jp = params["layers"][0]["mixer"], jparams["segments"][0][0]["mixer"]
    jp = jax.tree.map(lambda a: a[0], jp)
    x, pos = _inputs(cfg, T, 1)
    with torch.no_grad():
        got = tattn._mla_qkv(cfg, p, torch.as_tensor(x), torch.as_tensor(pos))
        out, (c_kv, k_rope) = tattn.mla_apply(cfg, CTX, p, torch.as_tensor(x),
                                              torch.as_tensor(pos))
    want = jax.jit(lambda *a: jattn._mla_qkv(jcfg, *a))(jp, x, pos)
    for name, g, w in zip(("q_nope", "q_rope", "c_kv", "k_rope"), got, want, strict=True):
        close(g, w, what=name)
    jout, (jc_kv, jk_rope) = jax.jit(lambda *a: jattn.mla_apply(jcfg, JCTX, *a))(jp, x, pos)
    close(out, jout, what="mla_apply")
    close(c_kv, jc_kv)
    close(k_rope, jk_rope)

    m = cfg.mla
    ckv, krope = torch.zeros((B, T, m.kv_lora_rank)), torch.zeros((B, T, m.qk_rope_head_dim))
    jckv, jkrope = jnp.zeros(ckv.shape), jnp.zeros(krope.shape)
    ref_decode = jax.jit(lambda *a: jattn.mla_decode(jcfg, JCTX, *a))
    for i in range(T):
        with torch.no_grad():
            y, ckv, krope = tattn.mla_decode(cfg, CTX, p, torch.as_tensor(x[:, i:i + 1]),
                                             ckv, krope, i)
        jy, jckv, jkrope = ref_decode(jp, x[:, i:i + 1], jckv, jkrope, jnp.int32(i))
        close(y, jy, what=f"mla_decode step {i}")
    close(ckv, jckv)
    close(krope, jkrope)
    # decode over the cache agrees with the full-sequence pass
    close(y, out[:, -1:], what="last decode step against mla_apply")


@pytest.mark.parametrize("layer", [0, 1], ids=["dense", "moe"])
def test_mla_block_prefill_fills_the_cache_and_decode_matches(models, layer):
    """``block_apply`` of an MLA block: a prefill of ``T - 1`` tokens fills
    the latent cache (zeros after), then one decode step; hidden states and
    both cache buffers against the reference's."""
    cfg, jcfg = _configs("smoke")
    params, jparams = models["smoke"]
    spec = cfg.layer_specs()[layer]
    seg = 0 if layer < cfg.moe_first_dense else 1
    jp = jax.tree.map(lambda a: a[layer - (0 if seg == 0 else cfg.moe_first_dense)],
                      jparams["segments"][seg][0])
    x, pos = _inputs(cfg, T, 2)
    m = cfg.mla
    cache = {"ckv": torch.full((B, T, m.kv_lora_rank), 7.0),
             "krope": torch.full((B, T, m.qk_rope_head_dim), 7.0)}
    jcache = {k: jnp.zeros(v.shape) for k, v in cache.items()}
    ref = jax.jit(lambda p, h, pos, c, n, mode: jtransformer.block_apply(
        jcfg, JCTX, spec, p, h, pos, mode, c, n, None), static_argnums=(5,))
    with torch.no_grad():
        h, _, _ = ttransformer.block_apply(cfg, CTX, spec, params["layers"][layer],
                                           torch.as_tensor(x[:, :-1]),
                                           torch.as_tensor(pos[:, :-1]), "prefill",
                                           cache, None, None)
    jh, jcache, _ = ref(jp, x[:, :-1], pos[:, :-1], jcache, 0, "prefill")
    close(h, jh, what="prefill hidden")
    for name in cache:
        close(cache[name], jcache[name], what=f"prefill cache {name}")
        assert bool((cache[name][:, T - 1:] == 0).all())
    with torch.no_grad():
        h, _, _ = ttransformer.block_apply(cfg, CTX, spec, params["layers"][layer],
                                           torch.as_tensor(x[:, -1:]), None, "decode",
                                           cache, T - 1, None)
    jh, jcache, _ = ref(jp, x[:, -1:], None, jcache, jnp.int32(T - 1), "decode")
    close(h, jh, what="decode hidden")
    for name in cache:
        close(cache[name], jcache[name], what=f"decode cache {name}")


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,absorb", [("smoke", False), ("smoke", True),
                                            ("top8", False)])
def test_prefill_decode_and_generate_match_the_reference(models, variant, absorb):
    """``prefill``, ``STEPS`` teacher-forced ``decode_step``s and
    ``Engine.generate`` against the reference's jitted engine, float32:
    logits and caches within ``TOL``, greedy tokens equal."""
    cfg, jcfg = _configs(variant, absorb)
    params, jparams = models[variant]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN)
    want = np.array(jeng.generate(jnp.asarray(toks), NEW))
    tol = TOL["float32"]
    jl, jc = jeng._prefill(jparams, {"tokens": jnp.asarray(toks)},
                           jinit_cache(jcfg, B, MAX_LEN))
    tl, tc = prefill(cfg, CTX, params, {"tokens": torch.as_tensor(toks)},
                     init_cache(cfg, B, MAX_LEN, device="cpu"))
    _close(tl, jl, tol, "prefill logits")
    _caches_close(tc, jc, tol, "prefill")
    for i in range(STEPS):
        tok = want[:, i:i + 1]
        jl, jc = jeng._decode(jparams, jc, jnp.asarray(tok))
        tl, tc = decode_step(cfg, CTX, params, tc, torch.as_tensor(tok))
        _close(tl, jl, tol, f"decode step {i} logits")
    _caches_close(tc, jc, tol, "decode")
    got = Engine(cfg, params, max_len=MAX_LEN).generate(torch.as_tensor(toks), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_references_tree_and_cache_load_into_the_port(models):
    """``convert`` at DeepSeek-V3's smoke config: the port's parameters in
    the reference's layout have the very tree of shapes the reference's
    ``init_params`` makes (the MTP head's block stacked on an axis of 1),
    and the reference's latent cache after a prefill, loaded through
    ``cache_from_numpy``, gives one decode step of the port equal to the
    reference's next step (float32, ``TOL``), logits and cache."""
    cfg, jcfg = _configs("smoke")
    params, jparams = models["smoke"]
    want = jax.eval_shape(lambda key: jinit_params(key, jcfg), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, want) == jax.tree.map(jnp.shape, jparams)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN)
    _, jc = jeng._prefill(jparams, {"tokens": jnp.asarray(toks)},
                          jinit_cache(jcfg, B, MAX_LEN))
    tc = cache_from_numpy(cfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert sorted(tc["segs"][0][0]) == ["ckv", "krope"] and tc["len"] == T
    jl, jc = jeng._decode(jparams, jc, jnp.asarray(toks[:, :1]))
    tl, tc = decode_step(cfg, CTX, params, tc, torch.as_tensor(toks[:, :1]))
    _close(tl, jl, TOL["float32"], "decode logits from the reference's cache")
    _caches_close(tc, jc, TOL["float32"], "decode from the reference's cache")


def test_mtp_parameters_carried_and_training_refused(models):
    """The MTP head: the reference's tree (``proj``, ``norm_h``, ``norm_e``,
    one dense MLA block, ``final_norm``) and nothing reads it in serving;
    training, its one reader, raises naming ``ROADMAP.md``."""
    cfg, _ = _configs("smoke")
    params, jparams = models["smoke"]
    assert sorted(jparams["mtp"]) == ["block", "final_norm", "norm_e", "norm_h", "proj"]
    assert params["mtp"]["proj"].shape == (2 * cfg.d_model, cfg.d_model)
    assert "wdq" in params["mtp"]["block"]["mixer"]
    assert "router" not in params["mtp"]["block"]["ffn"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1, item 1.5"):
        train_loss(cfg, CTX, params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_launch_serve_runs_deepseek_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--new", "3"])
    out = capsys.readouterr().out
    assert "arch=deepseek-smoke" in out and "generated (2, 3)" in out
