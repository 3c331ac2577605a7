"""internvl2-2b — InternViT + InternLM2-1.8B VLM (backbone only).

[arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B]
24L, d_model 2048, 16 heads (GQA kv=8, head_dim 128), d_ff 8192,
vocab 92553.  RMSNorm, SwiGLU, full RoPE.

The InternViT vision tower is a STUB per the assignment: ``input_specs``
feeds 256 precomputed patch embeddings per image, prepended to the text
tokens (so total sequence = assigned seq_len).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    vision_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32,
    vision_tokens=8, attn_chunk=16, logit_chunk=32,
)
