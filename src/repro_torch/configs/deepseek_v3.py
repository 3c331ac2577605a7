"""deepseek-v3-671b — MLA + 256-expert MoE + MTP.

[arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]
61L, d_model 7168, 128 MLA heads, vocab 129280.  First 3 layers dense
(d_ff 18432); remaining 58 layers MoE: 1 shared + 256 routed experts,
top-8, expert d_ff 2048 (the assignment's d_ff=2048 is the expert width),
sigmoid gating with routed scaling 2.5.  MLA: q_lora 1536, kv_lora 512,
nope/rope head dims 128/64, v_head 128.  One MTP depth-1 head.

Deviations (recorded in DESIGN.md): capacity-based top-k dispatch instead
of dropless aux-loss-free balancing; no node-limited routing (the EP scheme
here keeps tokens local and psum-combines instead of all-to-all).
"""
from repro_torch.models import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe_pattern=(True,), moe_first_dense=3,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1,
                  router="sigmoid", route_scale=2.5),
    mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=256,
    attention="mla",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe_pattern=(True,), moe_first_dense=1,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, num_shared=1,
                  router="sigmoid", route_scale=2.5),
    mtp_depth=1, attn_chunk=16, logit_chunk=32,
)
