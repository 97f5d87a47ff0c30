"""qwen1.5-0.5b — dense transformer [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (MHA: kv=16) d_ff=2816 vocab=151936, QKV bias,
tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    norm_eps=1e-6,
))
