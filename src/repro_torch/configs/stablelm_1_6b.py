"""stablelm-1.6b — dense transformer [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (MHA: kv=32) d_ff=5632 vocab=100352.
(StableLM-2's partial-rotary detail is simplified to full RoPE; noted in
DESIGN.md hardware-adaptation notes.)
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    rope_theta=1e4,
    norm_eps=1e-5,
))
