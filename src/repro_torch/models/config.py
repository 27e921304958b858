"""Unified model configuration (a copy of the reference's ``models/config.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config class covers all six architecture families.

    ``family`` selects the assembly path in :mod:`repro_torch.models.zoo`:
      dense | moe | ssm | hybrid | vlm | audio
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: Optional[int] = None  # default: d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # None = full causal attention
    # mlp
    mlp_type: str = "swiglu"  # swiglu | squared_relu | gelu
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0  # llama4-style shared expert
    router_aux_weight: float = 0.01
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2-style): one shared attention block applied every k layers
    attn_every: int = 0  # 0 = no interleaved shared attention
    # xLSTM
    slstm_every: int = 2  # in ssm family 'xlstm': every k-th block is sLSTM
    xlstm_proj_factor: float = 1.3
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    num_frames: int = 1500  # audio frontend stub output length
    # VLM early fusion
    num_patches: int = 0  # vision frontend stub output length (0 = text only)
    # training
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # perf knobs (§Perf hillclimb; defaults are the paper-faithful baseline)
    seq_parallel: bool = False  # shard the residual stream's seq dim over model
    grad_accum_dtype: str = "float32"  # bf16 halves accumulator memory
    attn_chunk: int = 0  # >0: flash-style chunked attention for S > attn_chunk
    moe_group_size: int = 512  # dispatch group size (bytes/flops ∝ group size)
    moe_impl: str = "gspmd"  # gspmd (grouped one-hot) | shard_map (all-to-all)
    moe_pin_layouts: bool = False  # constrain() the dispatch/expert layouts
    attn_pin_kv: bool = False  # pin KV-head dim to model axis in attention
    opt_moment_dtype: str = "float32"  # bf16 halves optimizer-state memory
    kd_chunk: int = 0  # >0: vocab-chunked online distillation loss
    # block variant for xlstm: "xlstm" uses mLSTM/sLSTM stack instead of attn
    block_type: str = "attention"  # attention | xlstm

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    microbatches: int = 1  # gradient-accumulation steps for train shapes


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train", microbatches=4)
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
