"""jamba-1.5-large-398b — hybrid Mamba + attention MoE LM.

[arXiv:2403.19887 (Jamba), 2408.12570 (1.5); hf:ai21labs/AI21-Jamba-1.5-Large]
72L, d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 24576,
vocab 65536.  Layer pattern: 1 attention : 7 mamba per 8-layer period
(attention at position 4); MoE (16 experts, top-2, expert d_ff = d_ff)
every other layer.  No explicit positional encoding (mamba provides order).
Mamba: d_state 16, d_conv 4, expand 2.
"""
from repro_torch.models import MambaConfig, ModelConfig, MoEConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba",
            "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    layer_pattern=_PATTERN, moe_pattern=(False, True),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    pos_emb="none",
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    layer_pattern=_PATTERN, moe_pattern=(False, True),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2, chunk=8),
    pos_emb="none", attn_chunk=16, logit_chunk=32,
)
