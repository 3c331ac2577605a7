"""The port's LM serving path (``prefill``, ``decode_step``,
``serving.Engine``, ``launch.serve``) held against the reference's on the
CPU, at the smoke sizes of the four GQA configs it serves first.

Both packages compute with the same weights (the port's, drawn from a
seed, stacked into the reference's tree).  The reference's engine generates
greedily; then both packages step through the reference's own tokens
(teacher forcing), so every step's logits and the caches compare like
with like.  Tolerances on logits and cache entries: ``TOL[dtype]``.  In
float32 both sides differ only in summation order (at most 3.1e-6 measured,
at logits up to 3.7; a bf16 computation misses 1e-4 by two orders).  In
bf16 they round at different places (XLA may keep an f32 intermediate that
PyTorch rounds): at most 0.033 measured (0.039 while the port's silu rounded
once, not after each op as ``jax.nn.silu``), 2 bf16 steps at that scale;
the tolerance is 4 steps (2^-4).  Greedy tokens must agree at every step whose reference top-1 /
top-2 margin exceeds the tolerance; a row that differs at a closer step
is left out from there on, and the test counts those steps.
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
from repro.serving import Engine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.convert import cache_from_numpy, model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.parallel import NO_PARALLEL as CTX
from repro_torch.serving import Engine
from test_torch_models import (  # noqa: F401  (autouse fixtures)
    gen,
    one_torch_thread,
    reference_params,
    shared_state_untouched,
)

ARCHS = ("phi3.5-moe-42b-a6.6b", "smollm-360m", "chatglm3-6b", "granite-34b")
B, T, NEW, MAX_LEN = 3, 20, 8, 32
TOL = {"float32": 1e-4, "bfloat16": 0.0625}


def _pair(arch, dtype="float32"):
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=dtype)
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype=dtype)
    params = init_params(gen(0), cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, reference_params(cfg, params))
    return cfg, jcfg, params, jparams


def _prompts(cfg, b=B, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, T)).astype(np.int32)


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _close(got, want, tol, what):
    err = np.abs(_f32(got) - _f32(want)).max()
    assert err <= tol, f"{what}: max |err| {err} > {tol}"


def _caches_close(tc, jc, tol, what):
    assert tc["len"] == int(jc["len"])
    for si, (tseg, jseg) in enumerate(zip(tc["segs"], jc["segs"], strict=True)):
        for tblk, jblk in zip(tseg, jseg, strict=True):
            assert sorted(tblk) == sorted(jblk)
            for name in tblk:
                assert tblk[name].dtype == getattr(torch, str(jblk[name].dtype))
                _close(tblk[name], jblk[name], tol, f"{what} cache segment {si} {name}")


def greedy_agreement(got, want, ref_logits, tol):
    """Fail unless ``got`` equals ``want`` at every step whose reference
    top-1 / top-2 margin exceeds ``tol``; a row is left out from its first
    differing (close) step on.  Returns the steps left out."""
    left_out = 0
    for r in range(want.shape[0]):
        for i in range(want.shape[1]):
            if got[r, i] == want[r, i]:
                continue
            top2 = np.sort(ref_logits[i][r])[-2:]
            assert top2[1] - top2[0] <= tol, (
                f"row {r} step {i}: token {got[r, i]} against {want[r, i]} at a "
                f"margin of {top2[1] - top2[0]}")
            left_out += want.shape[1] - i
            break
    return left_out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_the_reference(arch, dtype):
    cfg, jcfg, params, jparams = _pair(arch, dtype)
    tol = TOL[dtype]
    toks = _prompts(cfg)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN)
    want = np.array(jeng.generate(jnp.asarray(toks), NEW))

    jl, jc = jeng._prefill(jparams, {"tokens": jnp.asarray(toks)},
                           jinit_cache(jcfg, B, MAX_LEN))
    tl, tc = prefill(cfg, CTX, params, {"tokens": torch.as_tensor(toks)},
                     init_cache(cfg, B, MAX_LEN, device="cpu"))
    assert tl.shape == (B, 1, cfg.vocab_size) and tl.dtype == getattr(torch, dtype)
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
    left_out = greedy_agreement(got.numpy(), want, ref_logits, tol)
    print(f"{arch} {dtype}: greedy tokens compared at {B * NEW - left_out} of "
          f"{B * NEW} steps")
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "chatglm3-6b"])
def test_the_references_weights_and_cache_load_into_the_port(arch):
    """The reference's own parameters (``repro.models.init_params``) and its
    cache after a prefill, loaded through ``convert``: one decode step of
    the port from that cache equals the reference's next step (float32,
    ``TOL``), logits and cache."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    # jitted: the reference's eager init of an MoE smoke config takes seconds
    jparams = jax.jit(lambda key: jinit_params(key, jcfg))(jax.random.PRNGKey(3))
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    toks = _prompts(cfg, seed=3)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN)
    _, jc = jeng._prefill(jparams, {"tokens": jnp.asarray(toks)},
                          jinit_cache(jcfg, B, MAX_LEN))
    # before the decode step, which donates the reference's cache
    tc = cache_from_numpy(cfg, jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["len"] == T
    tok = toks[:, :1]
    jl, jc = jeng._decode(jparams, jc, jnp.asarray(tok))
    tl, tc = decode_step(cfg, CTX, params, tc, torch.as_tensor(tok))
    _close(tl, jl, TOL["float32"], "decode logits from the reference's cache")
    _caches_close(tc, jc, TOL["float32"], "decode from the reference's cache")


def test_batch_chunk_equals_each_chunk_alone_and_the_reference():
    """Chunks of 2 over 5 prompts (the last padded with its row 0): under
    MoE a chunk routes as that chunk alone, as in the reference."""
    cfg, jcfg, params, jparams = _pair("phi3.5-moe-42b-a6.6b")
    toks = torch.as_tensor(_prompts(cfg, b=5, seed=1))
    got = Engine(cfg, params, max_len=MAX_LEN, batch_chunk=2).generate(toks, 4)
    want = JEngine(jcfg, jparams, max_len=MAX_LEN, batch_chunk=2).generate(
        jnp.asarray(toks.numpy()), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    alone = Engine(cfg, params, max_len=MAX_LEN)
    for lo, rows in ((0, [0, 1]), (2, [2, 3]), (4, [4, 4])):
        n = 2 if lo < 4 else 1
        assert torch.equal(got[lo:lo + n], alone.generate(toks[rows], 4)[:n])


def test_max_len_error_empty_batch_and_batch_chunk_validation():
    eng = Engine(cfg=None, params=None, max_len=8)  # checked before the model
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(torch.zeros((1, 6), dtype=torch.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="batch_chunk"):
        Engine(cfg=None, params=None, batch_chunk=0)
    cfg, _, params, _ = _pair("smollm-360m")
    out = Engine(cfg, params, max_len=16, batch_chunk=2).generate(
        torch.zeros((0, 8), dtype=torch.int32), max_new_tokens=4)
    assert out.shape == (0, 4) and out.dtype == torch.int32


def test_seeded_sampling_is_deterministic_and_in_range():
    cfg, _, params, _ = _pair("phi3.5-moe-42b-a6.6b")
    toks = torch.as_tensor(_prompts(cfg, b=4, seed=2))
    eng = Engine(cfg, params, max_len=MAX_LEN, batch_chunk=2)
    a = eng.generate(toks, 6, temperature=0.8, rng=7)
    assert torch.equal(a, eng.generate(toks, 6, temperature=0.8, rng=7))
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(eng.generate(toks, 6, temperature=0.8, rng=g1),
                       eng.generate(toks, 6, temperature=0.8, rng=g2))
    # each chunk draws its own noise: one prompt in two chunks samples two
    # continuations
    same = toks[:1].expand(4, -1)
    s = eng.generate(same, 6, temperature=1.0, rng=7)
    assert not torch.equal(s[0], s[2])
    # without a seed, sampling falls back to greedy, as in the reference
    assert torch.equal(eng.generate(toks, 6, temperature=0.8), eng.generate(toks, 6))


def test_launch_serve_runs_on_the_cpu(capsys):
    serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new", "4", "--temperature", "0.5"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "device=cpu" in out
