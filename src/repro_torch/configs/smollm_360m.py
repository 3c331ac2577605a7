"""smollm-360m — llama-arch small dense LM.

[hf:HuggingFaceTB/SmolLM-360M; family per assignment]
32L, d_model 960, 15 heads (GQA kv=5, head_dim 64), d_ff 2560, vocab 49152.
Tied embeddings, RMSNorm, SwiGLU, full RoPE.

TP note: 15 q-heads / 5 kv-heads do not divide the 16-way model axis — the
sharding rules fall back to replicated attention weights for this arch
(d_ff 2560 = 160/chip and vocab 49152 = 3072/chip still shard).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    num_layers=2, d_model=96, num_heads=3, num_kv_heads=1,
    d_ff=256, vocab_size=256, head_dim=32,
    tie_embeddings=True, attn_chunk=16, logit_chunk=32,
)
