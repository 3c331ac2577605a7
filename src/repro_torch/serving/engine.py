"""Serving engine: batched prefill + greedy / temperature decode loop.

One prefill over the prompt, then one decode step per new token, each
writing the KV cache in place at its length (a host integer, so a step
reads nothing back from the device).  Greedy decoding takes the first
maximal logit (``argmax``).  Sampled decoding draws Gumbel noise from a
``torch.Generator`` seeded per call: the ``rng`` argument (a seed, or a
generator that one seed is drawn from) and, for a chunked batch, each
chunk's row offset, so every chunk draws from a stream of its own.
``jax.random`` cannot be reproduced, so sampled tokens are not the
reference's.

``batch_chunk=`` streams oversized request batches through fixed-size
microbatches: one KV cache of ``batch_chunk`` rows lives at a time, and the
last chunk is padded by repeating its row 0.  Under a MoE model the rows
are not independent (an expert's capacity follows the number of tokens in
the batch, and the padded rows compete for it), so a chunk's tokens equal
that chunk's rows generated alone as a batch of ``batch_chunk``, not the
one-shot batch's.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import ModelConfig, decode_step, init_cache, prefill
from ..models.model import params_device
from ..parallel.ctx import NO_PARALLEL, ParallelCtx

_MASK63 = (1 << 63) - 1


def _fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``data`` (splitmix64)."""
    z = (seed + 0x9E3779B97F4A7C15 * (data + 1)) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK63


class Engine:
    def __init__(self, cfg: ModelConfig, params, ctx: ParallelCtx = NO_PARALLEL,
                 max_len: int = 512, batch_chunk: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.ctx = ctx
        self.max_len = max_len
        if batch_chunk is not None:
            batch_chunk = int(batch_chunk)
            if batch_chunk < 1:
                raise ValueError(
                    f"batch_chunk must be >= 1, got {batch_chunk!r}")
        self.batch_chunk = batch_chunk

    def generate(self, tokens, max_new_tokens: int = 16,
                 temperature: float = 0.0, rng=None) -> torch.Tensor:
        """tokens (B, T) int prompt.  Returns (B, max_new_tokens) int32 on
        the parameters' device.  ``rng``: an int seed or a
        ``torch.Generator`` for sampled decoding (``temperature > 0``);
        without it decoding is greedy."""
        b, t = tokens.shape
        if t + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt length {t} + max_new_tokens {max_new_tokens} "
                f"exceeds max_len {self.max_len}; construct the Engine "
                f"with a larger max_len")
        device = params_device(self.params)
        if b == 0:
            return torch.zeros((0, max_new_tokens), dtype=torch.int32, device=device)
        tokens = torch.as_tensor(tokens).to(device)
        seed = rng
        if isinstance(rng, torch.Generator):
            seed = int(torch.randint(0, _MASK63, (), generator=rng, device=rng.device))
        if self.batch_chunk is not None and b > self.batch_chunk:
            return self._generate_chunked(tokens, max_new_tokens, temperature, seed)
        return self._generate(tokens, max_new_tokens, temperature, seed)

    def _generate(self, tokens, max_new_tokens, temperature, seed):
        cfg, ctx, params = self.cfg, self.ctx, self.params
        gen = None
        if temperature > 0.0 and seed is not None:
            gen = torch.Generator(device=tokens.device).manual_seed(int(seed))
        cache = init_cache(cfg, tokens.shape[0], self.max_len, device=tokens.device)
        logits, cache = prefill(cfg, ctx, params, {"tokens": tokens}, cache)
        out = []
        tok = self._sample(logits[:, -1], temperature, gen)
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = decode_step(cfg, ctx, params, cache, tok)
            tok = self._sample(logits[:, -1], temperature, gen)
        return torch.cat(out, dim=-1)

    def _generate_chunked(self, tokens, max_new_tokens, temperature, seed):
        """Fixed-size microbatches: every chunk has exactly ``batch_chunk``
        rows (the last padded by repeating its row 0); outputs are sliced
        back and concatenated in request order."""
        b = tokens.shape[0]
        chunk = self.batch_chunk
        outs = []
        for lo in range(0, b, chunk):
            tok = tokens[lo:lo + chunk]
            n = tok.shape[0]
            if n < chunk:  # pad the tail chunk by repeating its row 0
                tok = torch.cat([tok, tok[:1].expand(chunk - n, -1)])
            chunk_seed = None if seed is None else _fold_in(int(seed), lo)
            out = self._generate(tok, max_new_tokens, temperature, chunk_seed)
            outs.append(out[:n])
        return torch.cat(outs, dim=0)

    @staticmethod
    def _sample(logits, temperature, gen):
        if gen is None:
            return logits.argmax(-1)[:, None].to(torch.int32)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(torch.float32).tiny)))
        return (logits.float() / temperature + gumbel).argmax(-1)[:, None].to(torch.int32)
