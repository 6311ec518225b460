"""Model configurations (Llama-3 family + MoE + tiny test sizes).

The port's counterpart of ``skypilot_tpu/models/config.py``: the same
fields, defaults and registered configs, with torch dtypes in place of
jnp dtypes. ``paged_block_k`` is kept for field parity only: it shapes
TPU VMEM blocks and the port's kernels ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.utils.registry import MODEL_REGISTRY


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    rope_theta: float = 500_000.0
    # Llama-3.1-style NTK rope scaling; factor == 0 disables.
    rope_scaling_factor: float = 0.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    max_seq_len: int = 8192
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE (0 experts = dense)
    num_experts: int = 0
    experts_per_token: int = 2
    moe_dispatch: str = 'dense'
    capacity_factor: float = 1.25
    moe_group_size: int = 4096
    router_aux_loss_coeff: float = 0.01

    def __post_init__(self) -> None:
        if self.moe_dispatch not in ('dense', 'capacity'):
            raise ValueError(
                f'unknown moe_dispatch {self.moe_dispatch!r} '
                "(expected 'dense' or 'capacity')")
    # gated-MLP activation: 'silu' (llama/mixtral/qwen) or 'gelu_tanh'
    activation: str = 'silu'
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat_policy: str = 'full'
    attention_impl: str = 'auto'
    decode_attention_impl: Optional[str] = None
    # TPU VMEM shaping of the Pallas paged kernel; ignored by the port.
    paged_block_k: int = 0
    # KV cache storage: 'compute' (= compute_dtype) | 'int8' (per-row
    # fp32 scales, dequantized inside the attention kernel).
    kv_cache_dtype: str = 'compute'
    use_iota_embed: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def rope_scaling(self) -> Optional[Tuple[float, float, float, int]]:
        """(factor, low_freq, high_freq, original_max_pos) or None."""
        if not self.rope_scaling_factor:
            return None
        return (self.rope_scaling_factor, self.rope_low_freq_factor,
                self.rope_high_freq_factor,
                self.rope_original_max_position)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def params_count(self) -> int:
        """Exact dense-param count (used for MFU accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.is_moe:
            mlp = 3 * d * f * self.num_experts + d * self.num_experts
        else:
            mlp = 3 * d * f
        norms = 2 * d
        per_layer = attn + mlp + norms
        embed = v * d
        head = 0 if self.tie_embeddings else d * v
        return self.n_layers * per_layer + embed + head + d

    def flops_per_token(self, seq_len: int) -> float:
        """Approx training FLOPs/token: 6*N_active + attention term.

        6*N for fwd+bwd matmuls; attention adds 12*L*hd*H*seq (qk+av,
        fwd+bwd, causal halves it) -- the standard PaLM-style accounting.
        """
        n_active = self.params_count()
        if self.is_moe:
            d, f = self.d_model, self.d_ff
            dense_mlp_all = 3 * d * f * self.num_experts * self.n_layers
            dense_mlp_active = (3 * d * f * self.experts_per_token *
                                self.n_layers)
            n_active = n_active - dense_mlp_all + dense_mlp_active
        attn_flops = (12 * self.n_layers * self.n_heads *
                      self.resolved_head_dim * seq_len) / 2
        return 6 * n_active + attn_flops


def _register(cfg: ModelConfig) -> ModelConfig:
    MODEL_REGISTRY.register(cfg.name)(cfg)
    return cfg


LLAMA3_8B = _register(ModelConfig(
    name='llama3-8b', vocab_size=128_256, d_model=4096, n_layers=32,
    n_heads=32, n_kv_heads=8, d_ff=14336, rope_theta=500_000.0))

LLAMA3_70B = _register(ModelConfig(
    name='llama3-70b', vocab_size=128_256, d_model=8192, n_layers=80,
    n_heads=64, n_kv_heads=8, d_ff=28672))

LLAMA2_7B = _register(ModelConfig(
    name='llama2-7b', vocab_size=32_000, d_model=4096, n_layers=32,
    n_heads=32, n_kv_heads=32, d_ff=11008, rope_theta=10_000.0,
    max_seq_len=4096))

MIXTRAL_8X7B = _register(ModelConfig(
    name='mixtral-8x7b', vocab_size=32_000, d_model=4096, n_layers=32,
    n_heads=32, n_kv_heads=8, d_ff=14336, rope_theta=1_000_000.0,
    num_experts=8, experts_per_token=2))

GEMMA_7B = _register(ModelConfig(
    name='gemma-7b', vocab_size=256_128, d_model=3072, n_layers=28,
    n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576,
    rope_theta=10_000.0, activation='gelu_tanh', tie_embeddings=True))

QWEN2_7B = _register(ModelConfig(
    name='qwen2-7b', vocab_size=152_064, d_model=3584, n_layers=28,
    n_heads=28, n_kv_heads=4, d_ff=18944, rope_theta=1_000_000.0,
    max_seq_len=32768))

DEEPSEEK_MOE_16B = _register(ModelConfig(
    name='deepseek-moe-16b', vocab_size=102_400, d_model=2048,
    n_layers=28, n_heads=16, n_kv_heads=16, d_ff=1408,
    rope_theta=10_000.0, num_experts=64, experts_per_token=6,
    max_seq_len=4096))

GPT_OSS_20B = _register(ModelConfig(
    name='gpt-oss-20b', vocab_size=201_088, d_model=2880,
    n_layers=24, n_heads=64, n_kv_heads=8, head_dim=64, d_ff=2880,
    rope_theta=150_000.0, num_experts=32, experts_per_token=4,
    max_seq_len=131_072))

TINY = _register(ModelConfig(
    name='tiny', vocab_size=512, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, d_ff=128, max_seq_len=128, remat_policy='none'))

TINY_MOE = _register(ModelConfig(
    name='tiny-moe', vocab_size=512, d_model=64, n_layers=2, n_heads=4,
    n_kv_heads=2, d_ff=128, max_seq_len=128, num_experts=4,
    experts_per_token=2, remat_policy='none'))

SMALL_1B = _register(ModelConfig(
    name='small-1b', vocab_size=32_000, d_model=2048, n_layers=16,
    n_heads=16, n_kv_heads=8, d_ff=5504, max_seq_len=2048))

BENCH_700M = _register(ModelConfig(
    name='bench-700m', vocab_size=32_000, d_model=2048, n_layers=12,
    n_heads=16, n_kv_heads=8, d_ff=5504, max_seq_len=2048))

BENCH_1B7 = _register(ModelConfig(
    name='bench-1b7', vocab_size=32_000, d_model=2560, n_layers=22,
    n_heads=20, n_kv_heads=4, d_ff=6912, max_seq_len=2048))


def with_int8_kv_cache(cfg: ModelConfig) -> ModelConfig:
    """Engine helper: the int8-KV-cache variant of a config."""
    return dataclasses.replace(cfg, kv_cache_dtype='int8')


def get_model_config(name: str, **overrides) -> ModelConfig:
    cfg: ModelConfig = MODEL_REGISTRY.get(name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def list_models() -> Tuple[str, ...]:
    return tuple(MODEL_REGISTRY.keys())
