"""Qwen2 1.5B — dense, GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    mlp_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    name="qwen2-1.5b-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=768,
    vocab_size=512,
)
