"""Model configuration: one dataclass family covering all 10 assigned archs.

The port's own copy of the reference's ``models/config.py``, field for
field.  A config is pure data -- every architecture in
``repro_torch.configs`` is an instance of :class:`ModelConfig`.  The layer
stack is described by a repeating ``layer_pattern`` (mixer kind per
position) and ``moe_pattern`` (whether the FFN at that position is MoE),
from which :func:`derive_segments` produces homogeneous *segments*: the
reference scans each with stacked params, the port loops over its layer
modules in the same order and keeps the decode cache in the segments'
stacked layout.  The lowering-shape switches (``scan_layers``,
``scan_seq``, ``attn_unroll``, ``remat``) are XLA's and the port reads
none of them; they stay so that a config is the same data in both
packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # always-on shared expert(s), deepseek-style
    router: str = "softmax"  # 'softmax' | 'sigmoid' (deepseek v3 gating)
    capacity_factor: float = 1.25
    router_metric: str = "angular"  # datapath mode for scores: 'angular'|'cosine'
    route_scale: float = 1.0  # deepseek routed_scaling_factor
    combine_dtype: str = "float32"  # EP psum payload; 'bfloat16' halves the
    # per-MoE-layer combine traffic (outputs are bf16 anyway) -- a Perf lever


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    absorb: bool = False  # decode-time weight absorption (perf variant)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 128  # time-chunk for the selective-scan


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    gate_lora: int = 0  # 0 -> d_model // 8 (unused placeholder for variants)
    chunk: int = 64  # time-chunk (chunked wkv: MXU form; 0 = pure recurrence)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec archs; the modality frontend is a STUB —
    ``input_specs`` feeds precomputed frame/patch embeddings."""

    num_layers: int
    seq_len: int  # e.g. whisper: 1500 mel-frame embeddings


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    attention: str = "gqa"  # 'gqa' | 'mla'
    layer_pattern: Tuple[str, ...] = ("attn",)  # mixer per position, cycled
    moe_pattern: Tuple[bool, ...] = (False,)  # FFN-is-MoE per position, cycled
    moe_first_dense: int = 0  # leading layers forced dense (deepseek: 3)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # fraction of head_dim rotated (chatglm .5)
    pos_emb: str = "rope"  # 'rope' | 'sinusoidal' | 'none'
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    causal: bool = True  # False: bidirectional self-attention (encoders)
    act: str = "silu"
    mlp_gated: bool = True  # SwiGLU-style gated MLP
    qkv_bias: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision_tokens: int = 0  # VLM: stub patch embeddings prepended
    mtp_depth: int = 0  # deepseek multi-token-prediction heads
    mtp_weight: float = 0.3
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    logit_chunk: int = 1024  # seq chunk for the (chunked) LM loss
    attn_chunk: int = 512  # q/kv chunk for flash-style chunked attention
    remat: str = "block"  # 'none' | 'block' (checkpoint each scanned block)
    # Lowering-shape switches.  XLA's cost_analysis counts a while-loop body
    # ONCE (measured; see benchmarks/roofline.py), so the roofline harness
    # lowers *unrolled* per-layer bodies for exact FLOP/byte/collective
    # accounting while production lowering keeps scans (small HLO):
    scan_layers: bool = True  # lax.scan over stacked layer params
    scan_seq: bool = True  # lax.scan over time-chunks (ssm/rwkv/attn/loss)
    attn_unroll: bool = False  # python-unroll the kv-chunk loop (costing)

    # ---- derived ---------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def dt_rank_(self) -> int:
        assert self.mamba is not None
        return self.mamba.dt_rank or -(-self.d_model // 16)

    def layer_specs(self) -> list["LayerSpec"]:
        """Fully unrolled per-layer spec list (len == num_layers)."""
        out = []
        for i in range(self.num_layers):
            mixer = self.layer_pattern[i % len(self.layer_pattern)]
            is_moe = (self.moe is not None
                      and i >= self.moe_first_dense
                      and self.moe_pattern[i % len(self.moe_pattern)])
            out.append(LayerSpec(mixer=mixer, moe=is_moe))
        return out

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6ND math."""
        from . import model  # lazy; avoids cycle
        return model.count_params(self)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # 'attn' | 'mamba' | 'rwkv'
    moe: bool


def derive_segments(cfg: ModelConfig) -> list[tuple[Tuple[LayerSpec, ...], int]]:
    """Group layers into (pattern, repeats) segments with identical structure.

    The forward pass scans each segment with stacked params: one segment for
    uniform stacks, [dense-prefix, moe-rest] for deepseek, one 8-layer
    pattern x 9 for jamba.
    """
    specs = cfg.layer_specs()
    segments: list[tuple[Tuple[LayerSpec, ...], int]] = []
    i = 0
    while i < len(specs):
        # Pick the period p whose repeated prefix covers the most layers;
        # only genuinely-repeating periods (r >= 2, or p == 1) count, so a
        # trailing one-shot "period = everything" never wins and params stay
        # stackable for lax.scan.
        best = (1, 1)  # (period, repeats)
        rest = specs[i:]
        for p in range(1, len(rest) // 2 + 2):
            pat = rest[:p]
            r = 1
            while (r + 1) * p <= len(rest) and rest[r * p:(r + 1) * p] == pat:
                r += 1
            if r >= 2 or p == 1:
                if r * p > best[0] * best[1] or (
                        r * p == best[0] * best[1] and p < best[0]):
                    best = (p, r)
        p, r = best
        segments.append((tuple(rest[:p]), r))
        i += p * r
    assert sum(len(pat) * r for pat, r in segments) == cfg.num_layers
    return segments


def lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
