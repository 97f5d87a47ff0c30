"""grok-1-314b — MoE transformer [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=32768, 8 experts top-2,
vocab=131072. Optimizer moments in bf16 so the 314B configuration fits the
16 GiB/chip production mesh (DESIGN.md §5).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    rope_theta=1e4,
    norm_eps=1e-5,
    moment_dtype="bfloat16",
    train_microbatches=8,
    grad_accum_dtype="bfloat16",
))
