"""mixtral-8x22b — MoE transformer with sliding-window attention
[arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=16384, 8 experts top-2,
vocab=32768, SWA window 4096 (per the assignment; the rolling cache makes
long_500k decode run at constant memory). bf16 optimizer moments (141B
total parameters).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    top_k=2,
    swa_window=4096,
    rope_theta=1e6,
    norm_eps=1e-5,
    moment_dtype="bfloat16",
    train_microbatches=4,
))
