"""phi3.5-moe-42b-a6.6b — Microsoft Phi-3.5-MoE (16 experts, top-2).

[hf:microsoft/Phi-3.5-MoE-instruct]
32L, d_model 4096, 32 heads (GQA kv=8, head_dim 128), expert d_ff 6400,
vocab 32064.  Every layer's FFN is MoE (16e top-2).  LayerNorm (upstream),
SwiGLU experts, full RoPE.

Deviation (recorded): upstream routes with SparseMixer-v2; we use standard
top-2 softmax gating over the datapath's angular-mode scores.
"""
from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064, head_dim=128,
    norm="layernorm",
    moe_pattern=(True,),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=32,
    norm="layernorm",
    moe_pattern=(True,),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    attn_chunk=16, logit_chunk=32,
)
