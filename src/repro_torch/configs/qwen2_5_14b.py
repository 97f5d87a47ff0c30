"""qwen2.5-14b — dense GQA transformer [hf:Qwen/Qwen2.5 family].

48L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=13824 vocab=152064,
QKV bias, RoPE theta 1e6.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    norm_eps=1e-6,
    train_microbatches=2,
))
