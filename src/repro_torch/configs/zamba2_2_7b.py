"""Zamba2 2.7B — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242].  The shared attention+MLP block (weights reused, one KV
cache per application) is applied every 6 Mamba2 layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    mlp_type="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
)

SMOKE = CONFIG.replace(
    name="zamba2-2.7b-smoke",
    num_layers=4,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=16,
    attn_every=2,
)
