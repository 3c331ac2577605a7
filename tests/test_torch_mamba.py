"""The Mamba mixer and the Jamba hybrid in the port held against the
reference on the CPU.

Weights are the port's, drawn from a seed (the mixer's zero / one inits
redrawn, so that every parameter counts), stacked into the reference's
tree; the reference's own ``init_params`` is only traced (its jit takes
seconds at ``jamba-smoke``).  Inputs come from a numpy seed.  Tolerances:

- the mixer's functions (``_conv1d``, ``_ssm_params``, ``selective_scan``,
  ``mamba_apply``) in float32 at ``F32_RTOL`` / ``F32_ATOL`` of
  ``tests/test_torch_models.py`` (the same operations, another summation
  order); in bf16 at ``TOL["bfloat16"]`` of
  ``tests/test_torch_lm_serving.py`` (roundings at other places);
- decode step by step against the full sequence, within the port, at the
  reference's own tolerance for the same check (``tests/test_models.py``
  ``test_mamba_stepwise_equals_full``: rtol 2e-3, atol 2e-4);
- blocks, ``prefill``, ``decode_step`` and ``Engine.generate`` of
  ``jamba-smoke`` (8 layers: attention at 4, MoE at the odd layers, scan
  chunks of 8) at ``TOL[dtype]``; greedy tokens equal in float32.

The reference's engine is compiled once per dtype for the module, by the
first test that asks for that dtype, at one batch and prompt length, and
every test that needs it reuses it.  It is compiled with XLA's excess
precision off (``xla_allow_excess_precision``): left on, XLA's CPU
backend drops some of the program's bf16 roundings (an f32 -> bf16 ->
f32 convert pair inside a fusion), so where it rounds depends on how it
fused: a block's second norm reads the residual sum before its rounding,
and a decode step's skip term reads the conv's silu before its rounding,
which moves a Mamba layer's output by up to 0.009 (3e-3 of it).  Off,
every bf16 value rounds where the program rounds it, as the port's do,
and jamba-smoke's bf16 logits agree within 0.018 (0.07 with it on, past
``TOL``).  float32 has no rounding to drop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import mamba as jmamba
from repro.models import transformer as jtransformer
from repro.parallel.ctx import NO_PARALLEL as JCTX
from repro.serving import Engine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.convert import cache_from_numpy, model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import (ModelConfig, MambaConfig, decode_step, init_cache,
                                init_params, prefill)
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as ttransformer
from repro_torch.parallel import NO_PARALLEL as CTX
from repro_torch.serving import Engine
from test_torch_lm_serving import TOL, _caches_close, _close, _f32, greedy_agreement
from test_torch_models import (  # noqa: F401  (autouse fixtures)
    close,
    gen,
    one_torch_thread,
    reference_params,
    shared_state_untouched,
)

ARCH = "jamba-1.5-large-398b"
B, T, NEW, MAX_LEN = 2, 20, 6, 32


def _redraw(params):
    """Every Mamba mixer's zero / one parameters (conv bias, skip, the
    three inner norm scales) drawn anew, so that each one counts."""
    g = gen(27)
    with torch.no_grad():
        for blk in params["layers"]:
            mix = blk["mixer"]
            if "a_log" not in mix:
                continue
            for t in (mix["conv_b"], mix["d_skip"], mix["dt_norm"]["scale"],
                      mix["b_norm"]["scale"], mix["c_norm"]["scale"]):
                t.copy_(torch.empty_like(t).uniform_(0.5, 1.5, generator=g))
    return params


class _Models(dict):
    """Per compute dtype: the port's and the reference's config, the port's
    weights, their reference tree and the reference's engine over it, its
    prefill and decode step compiled with XLA's excess precision off (see
    the module's docstring).  Each dtype is built on its first use, so that
    a worker that runs only one dtype's tests compiles only its engine."""

    def __missing__(self, dtype):
        opts = {"xla_allow_excess_precision": False}
        cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=dtype)
        jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype=dtype)
        params = _redraw(init_params(gen(0), cfg, device="cpu"))
        jparams = jax.tree.map(jnp.asarray, reference_params(cfg, params))
        jeng = JEngine(jcfg, jparams, max_len=MAX_LEN)
        batch = {"tokens": jnp.asarray(_prompts(cfg))}
        jeng._prefill = jeng._prefill.lower(jparams, batch, jinit_cache(
            jcfg, B, MAX_LEN)).compile(compiler_options=opts)
        _, cache = jeng._prefill(jparams, batch, jinit_cache(jcfg, B, MAX_LEN))
        jeng._decode = jeng._decode.lower(jparams, cache, batch["tokens"][:, :1]).compile(
            compiler_options=opts)
        self[dtype] = cfg, jcfg, params, jparams, jeng
        return self[dtype]


@pytest.fixture(scope="module")
def models():
    """The module's ``_Models``: each dtype built once, when first asked for."""
    return _Models()


def _prompts(cfg, b=B, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, T)).astype(np.int32)


def _as(x: np.ndarray, dtype: str):
    """The same values in both packages, rounded to ``dtype``."""
    j = jnp.asarray(x, dtype)
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_ssm_params_scan_and_mamba_apply(models, dtype):
    """Layer 0's mixer, each function on the same inputs in both packages:
    ``_conv1d`` from zeros and from a state, ``_ssm_params``,
    ``selective_scan`` over 13 steps (chunks of 8, the last padded) from a
    nonzero state, and ``mamba_apply`` from both states."""
    cfg, jcfg, params, jparams, _ = models[dtype]
    p = params["layers"][0]["mixer"]
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0][0]["mixer"])
    d_in, n, _ = tmamba.mamba_dims(cfg)
    t = 13
    rng = np.random.default_rng(5)
    x, tx = _as(rng.normal(size=(B, t, cfg.d_model)), dtype)
    xi, txi = _as(rng.normal(size=(B, t, d_in)), dtype)
    cs, tcs = _as(rng.normal(size=(B, cfg.mamba.d_conv - 1, d_in)), dtype)
    h0 = rng.normal(size=(B, d_in, n)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, (B, t, d_in)).astype(np.float32)
    b, c = (rng.normal(size=(B, t, n)).astype(np.float32) for _ in range(2))

    def ref(jp, x, xi, cs, h0, dt, b, c):
        return {"conv": jmamba._conv1d(jp, xi),
                "conv state": jmamba._conv1d(jp, xi, cs),
                "ssm params": jmamba._ssm_params(jcfg, jp, xi),
                "scan": jmamba.selective_scan(jcfg, dt, b, c, xi, jp, h0),
                "apply": jmamba.mamba_apply(jcfg, JCTX, jp, x),
                "apply state": jmamba.mamba_apply(jcfg, JCTX, jp, x, ssm_state=h0,
                                                  conv_state=cs)}
    want = jax.jit(ref)(jp, x, xi, cs, h0, dt, b, c)
    th0, tdt, tb, tc = (torch.as_tensor(a) for a in (h0, dt, b, c))
    with torch.no_grad():
        got = {"conv": tmamba._conv1d(p, txi),
               "conv state": tmamba._conv1d(p, txi, tcs),
               "ssm params": tmamba._ssm_params(cfg, p, txi),
               "scan": tmamba.selective_scan(cfg, tdt, tb, tc, txi, p, th0),
               "apply": tmamba.mamba_apply(cfg, CTX, p, tx),
               "apply state": tmamba.mamba_apply(cfg, CTX, p, tx, ssm_state=th0,
                                                 conv_state=tcs)}
    for name, outs in got.items():
        for i, (g, w) in enumerate(zip(jax.tree.leaves(outs), jax.tree.leaves(want[name]),
                                       strict=True)):
            assert g.dtype == getattr(torch, str(w.dtype)), (name, i)
            if dtype == "float32":
                close(g, w, what=f"{name} output {i}")
            else:
                _close(g, w, TOL[dtype], f"{name} output {i}")
    # the new conv state is the input's last rows, before the silu
    for name in ("conv", "conv state"):
        assert torch.equal(got[name][1], txi[:, -(cfg.mamba.d_conv - 1):])


def test_scan_is_the_recurrence_and_underflows_nowhere():
    """The chunked log-depth scan equals the plain recurrence h_t = a_t
    h_{t-1} + bx_t step by step (float64 witness), with decays that a
    closed form's running product would take below float32's range."""
    cfg = ModelConfig(name="t", family="ssm", num_layers=1, d_model=8, num_heads=1,
                      num_kv_heads=1, d_ff=16, vocab_size=16, layer_pattern=("mamba",),
                      mamba=MambaConfig(d_state=3, d_conv=2, expand=2, chunk=16))
    rng = np.random.default_rng(6)
    t, d_in, n = 37, 16, 3
    dt = rng.uniform(0.5, 3.0, (1, t, d_in)).astype(np.float32)
    b, c = (rng.normal(size=(1, t, n)).astype(np.float32) for _ in range(2))
    xc = rng.normal(size=(1, t, d_in)).astype(np.float32)
    a_log = np.log(rng.uniform(1.0, 16.0, (d_in, n))).astype(np.float32)
    p = {"a_log": torch.as_tensor(a_log), "d_skip": torch.zeros(d_in)}
    y, h = tmamba.selective_scan(cfg, *(torch.as_tensor(v) for v in (dt, b, c, xc)), p)
    a = -np.exp(a_log.astype(np.float64))
    hw, ys = np.zeros((d_in, n)), []
    for i in range(t):
        hw = np.exp(dt[0, i, :, None] * a) * hw + (dt[0, i] * xc[0, i])[:, None] * b[0, i]
        ys.append(hw @ c[0, i])
    # the decays' product over one chunk is far below float32's least normal
    assert np.exp((dt[0, :16, :, None] * a).sum(0)).min() < 1e-45
    np.testing.assert_allclose(y[0].numpy(), np.stack(ys), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h[0].numpy(), hw, rtol=1e-5, atol=1e-5)


def test_decode_step_by_step_equals_the_full_sequence():
    """``mamba_decode`` token by token from zero states against one
    ``mamba_apply`` over the sequence (the reference's own test, its
    config and tolerance): outputs and both final states."""
    cfg = ModelConfig(name="t", family="ssm", num_layers=1, d_model=16, num_heads=1,
                      num_kv_heads=1, d_ff=32, vocab_size=64, layer_pattern=("mamba",),
                      mamba=MambaConfig(d_state=4, d_conv=3, expand=2, chunk=4))
    p = tmamba.mamba_init(gen(4), cfg)
    t = 11
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(2, t, 16)).astype(np.float32))
    conv_s, ssm_s = tmamba.mamba_state_shapes(cfg, 2)
    conv, ssm = torch.zeros(conv_s), torch.zeros(ssm_s)
    with torch.no_grad():
        y_full, (conv_full, ssm_full) = tmamba.mamba_apply(cfg, CTX, p, x)
        outs = []
        for i in range(t):
            y, conv, ssm = tmamba.mamba_decode(cfg, CTX, p, x[:, i:i + 1], conv, ssm)
            outs.append(y)
    for got, want in ((torch.cat(outs, 1), y_full), (conv, conv_full), (ssm, ssm_full)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-4)


def test_mamba_block_prefill_fills_the_caches_and_decode_matches(models):
    """``block_apply`` of layer 1 (Mamba and MoE), float32: a prefill of
    ``T - 1`` tokens writes ``conv`` / ``ssm`` in place over stale values,
    then one decode step reads and rewrites them; hidden states and both
    buffers against the reference's."""
    cfg, jcfg, params, jparams, _ = models["float32"]
    spec = cfg.layer_specs()[1]
    assert spec.mixer == "mamba" and spec.moe
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0][1])
    x = np.random.default_rng(2).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    conv_s, ssm_s = tmamba.mamba_state_shapes(cfg, B)
    cache = {"conv": torch.full(conv_s, 7.0), "ssm": torch.full(ssm_s, 7.0)}
    jcache = {k: jnp.zeros(v.shape) for k, v in cache.items()}
    ref = jax.jit(lambda p, h, c, n, mode: jtransformer.block_apply(
        jcfg, JCTX, spec, p, h, None, mode, c, n, None), static_argnums=(4,))
    for mode, xs, n in (("prefill", x[:, :-1], None), ("decode", x[:, -1:], T - 1)):
        with torch.no_grad():
            h, _, _ = ttransformer.block_apply(cfg, CTX, spec, params["layers"][1],
                                               torch.as_tensor(xs), None, mode, cache, n,
                                               None)
        jh, jcache, _ = ref(jp, xs, jcache, None if n is None else jnp.int32(n), mode)
        close(h, jh, what=f"{mode} hidden")
        for name in cache:
            close(cache[name], jcache[name], what=f"{mode} cache {name}")


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_and_generate_match_the_reference(models, dtype):
    """``prefill`` of 20 tokens (three scan chunks, the last padded), ``NEW``
    teacher-forced ``decode_step``s and ``Engine.generate`` against the
    reference's engine: logits and every cache buffer (``k`` / ``v`` of the
    attention layer, ``conv`` / ``ssm`` of the seven Mamba layers) within
    ``TOL``; greedy tokens equal in float32, and in bf16 at every step
    whose reference top-2 margin exceeds ``TOL``."""
    cfg, jcfg, params, jparams, jeng = models[dtype]
    tol = TOL[dtype]
    toks = _prompts(cfg)
    want = np.array(jeng.generate(jnp.asarray(toks), NEW))
    jl, jc = jeng._prefill(jparams, {"tokens": jnp.asarray(toks)},
                           jinit_cache(jcfg, B, MAX_LEN))
    tl, tc = prefill(cfg, CTX, params, {"tokens": torch.as_tensor(toks)},
                     init_cache(cfg, B, MAX_LEN, device="cpu"))
    assert [sorted(blk) for seg in tc["segs"] for blk in seg] == (
        [["conv", "ssm"]] * 2 + [["k", "v"]] + [["conv", "ssm"]] * 3)
    _close(tl, jl, tol, "prefill logits")
    _caches_close(tc, jc, tol, "prefill")
    ref_logits = [_f32(jl)[:, -1]]
    for i in range(NEW):
        tok = want[:, i:i + 1]
        jl, jc = jeng._decode(jparams, jc, jnp.asarray(tok))
        tl, tc = decode_step(cfg, CTX, params, tc, torch.as_tensor(tok))
        _close(tl, jl, tol, f"decode step {i} logits")
        ref_logits.append(_f32(jl)[:, -1])
    _caches_close(tc, jc, tol, "decode")
    got = Engine(cfg, params, max_len=MAX_LEN).generate(torch.as_tensor(toks), NEW)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    greedy_agreement(got.numpy(), want, ref_logits, tol)
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)


def test_batch_chunk_equals_the_references_chunks(models):
    """``batch_chunk=2`` over 3 prompts (the last chunk padded with its row
    0): each chunk's greedy tokens equal the reference engine's on that
    chunk (what its own chunked generate computes) and the port's on the
    chunk alone."""
    cfg, _, params, _, jeng = models["float32"]
    toks = _prompts(cfg, b=3, seed=1)
    got = Engine(cfg, params, max_len=MAX_LEN, batch_chunk=2).generate(
        torch.as_tensor(toks), NEW)
    alone = Engine(cfg, params, max_len=MAX_LEN)
    for lo, rows in ((0, [0, 1]), (2, [2, 2])):
        n = min(2, 3 - lo)
        want = np.asarray(jeng.generate(jnp.asarray(toks[rows]), NEW))[:n]
        np.testing.assert_array_equal(got[lo:lo + n].numpy(), want)
        assert torch.equal(got[lo:lo + n],
                           alone.generate(torch.as_tensor(toks[rows]), NEW)[:n])


def test_the_references_tree_and_cache_load_into_the_port(models):
    """``convert`` at Jamba's smoke config: the reference's ``init_params``
    makes the very tree of shapes the port's weights stack into (every
    Mamba block's nested norm scales included), which converts back to the
    same modules; the reference's cache after a prefill (``conv``, ``ssm``,
    ``k``, ``v``), loaded through ``cache_from_numpy``, gives one decode step
    of the port equal to the reference's next step (float32, ``TOL``)."""
    cfg, jcfg, params, jparams, jeng = models["float32"]
    want = jax.eval_shape(lambda key: jinit_params(key, jcfg), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, want) == jax.tree.map(jnp.shape, jparams)
    assert sorted(want["segments"][0][0]["mixer"]["dt_norm"]) == ["scale"]
    back = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    mine = dict(params.named_parameters())
    assert sorted(dict(back.named_parameters())) == sorted(mine)
    assert all(torch.equal(p, mine[k]) for k, p in back.named_parameters())
    toks = _prompts(cfg, seed=4)
    _, jc = jeng._prefill(jparams, {"tokens": jnp.asarray(toks)},
                          jinit_cache(jcfg, B, MAX_LEN))
    # before the decode step, which donates the reference's cache
    tc = cache_from_numpy(cfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["len"] == T and tc["segs"][0][0]["ssm"].dtype == torch.float32
    jl, jc = jeng._decode(jparams, jc, jnp.asarray(toks[:, :1]))
    tl, tc = decode_step(cfg, CTX, params, tc, torch.as_tensor(toks[:, :1]))
    _close(tl, jl, TOL["float32"], "decode logits from the reference's cache")
    _caches_close(tc, jc, TOL["float32"], "decode from the reference's cache")


def test_launch_serve_runs_jamba_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--new", "3"])
    out = capsys.readouterr().out
    assert "arch=jamba-smoke" in out and "generated (2, 3)" in out
