"""rwkv6-7b — RWKV-6 "Finch": attention-free linear RNN with
data-dependent decay.

[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b]
32L, d_model 4096 (64 heads of size 64), d_ff 14336, vocab 65536.
Time-mix (wkv) + channel-mix blocks; decay lora rank 64.
"""
from repro_torch.models import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
    layer_pattern=("rwkv",), pos_emb="none",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, chunk=64),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    layer_pattern=("rwkv",), pos_emb="none",
    rwkv=RWKVConfig(head_size=16, decay_lora=8, chunk=8),
    logit_chunk=32,
)
