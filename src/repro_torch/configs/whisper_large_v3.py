"""whisper-large-v3 — encoder-decoder audio transformer [arXiv:2212.04356].

32L encoder + 32L decoder, d_model=1280, 20H (MHA), d_ff=5120 (plain GELU
MLP), vocab=51866. The conv audio frontend is a STUB: ``input_specs``
provides precomputed frame embeddings [B, 1500, 1280]. Positional encoding
is RoPE in this implementation (Whisper's learned/sinusoidal embeddings are
an equivalent-capacity substitution; DESIGN.md §4).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    enc_layers=32,
    enc_seq=1500,
    frontend="audio",
    rope_theta=1e4,
    norm_eps=1e-5,
))
