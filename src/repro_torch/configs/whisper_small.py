"""whisper-small — encoder-decoder speech model (backbone only).

[arXiv:2212.04356; hf:openai/whisper-small]
12L encoder + 12L decoder, d_model 768, 12 heads (kv=12, head_dim 64),
d_ff 3072, vocab 51865.  LayerNorm, GELU, QKV bias, sinusoidal positions,
cross-attention from decoder to the 1500-frame encoder memory.

The conv mel frontend is a STUB per the assignment: ``input_specs`` feeds
precomputed (B, 1500, 768) frame embeddings.
"""
from repro_torch.models import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    norm="layernorm", act="gelu", mlp_gated=False, qkv_bias=True,
    pos_emb="sinusoidal", encoder=EncoderConfig(num_layers=12, seq_len=1500),
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=96, num_heads=3, num_kv_heads=3,
    d_ff=192, vocab_size=256, head_dim=32,
    norm="layernorm", act="gelu", mlp_gated=False, qkv_bias=True,
    pos_emb="sinusoidal", encoder=EncoderConfig(num_layers=2, seq_len=24),
    attn_chunk=16, logit_chunk=32,
)
