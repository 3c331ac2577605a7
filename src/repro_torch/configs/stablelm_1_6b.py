"""stablelm-1.6b — StableLM-2 1.6B dense LM (full MHA).

[hf:stabilityai/stablelm-2-1_6b; unverified tier per assignment]
24L, d_model 2048, 32 heads (kv=32 — full multi-head, head_dim 64),
d_ff 5632, vocab 100352.  LayerNorm, SwiGLU, partial rotary (25%).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, head_dim=64,
    norm="layernorm", rope_fraction=0.25,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=256, head_dim=32,
    norm="layernorm", rope_fraction=0.25, attn_chunk=16, logit_chunk=32,
)
