"""qwen2.5-3b — dense GQA transformer [hf:Qwen/Qwen2.5 family].

36L d_model=2048 16H (GQA kv=2, head_dim 128) d_ff=11008 vocab=151936,
QKV bias, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    norm_eps=1e-6,
))
