"""internvl2-76b — VLM: InternViT frontend (stub) + 76B LM backbone
[arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=28672 vocab=128256.
The InternViT vision tower is a STUB: ``input_specs`` provides 256
precomputed patch embeddings per sample which replace the first 256 token
positions (labels masked there).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    frontend="vision",
    vis_tokens=256,
    rope_theta=5e5,
    norm_eps=1e-5,
    moment_dtype="bfloat16",
    train_microbatches=4,
))
