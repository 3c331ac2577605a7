"""granite-34b — IBM Granite Code 34B (GPT-BigCode-style dense, MQA).

[arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base]
88L, d_model 6144, 48 heads (MQA kv=1, head_dim 128), d_ff 24576,
vocab 49152.  LayerNorm, GELU, non-gated MLP.

Deviation (recorded): upstream uses learned absolute positions; we use the
fixed sinusoidal table (the assignment treats positional scheme as
backbone detail; no parameter-shape impact beyond dropping the table).
"""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    norm="layernorm", act="gelu", mlp_gated=False, pos_emb="sinusoidal",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    num_layers=3, d_model=128, num_heads=4, num_kv_heads=1,
    d_ff=512, vocab_size=256, head_dim=32,
    norm="layernorm", act="gelu", mlp_gated=False, pos_emb="sinusoidal",
    attn_chunk=16, logit_chunk=32,
)
