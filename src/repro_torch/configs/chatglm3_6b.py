"""chatglm3-6b — GLM-family dense LM with partial (2d) RoPE and GQA.

[arXiv:2406.12793; hf:THUDM/chatglm3-6b]
28L, d_model 4096, 32 heads (GQA kv=2, head_dim 128), d_ff 13696,
vocab 65024.  RMSNorm, SwiGLU, QKV bias, RoPE over half the head dim
(rope_fraction=0.5 — the GLM "2d" rotary).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rope_fraction=0.5, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="chatglm3-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32,
    rope_fraction=0.5, qkv_bias=True, attn_chunk=16, logit_chunk=32,
)
