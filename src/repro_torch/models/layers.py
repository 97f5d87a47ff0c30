"""Shared layer primitives: norms, MLPs, rotary embeddings, initializers.

Parameters are plain nested dicts of tensors, as in the reference
(`repro.models.layers`); all functions are pure. Norm and rotary math
runs in float32 whatever the activation dtype, and the result is cast
back. Projections are `torch.matmul`: the reference leaves them to XLA,
outside any kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int8": torch.int8,
           "float64": torch.float64}    # float64: the port's gradient checks


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype, device=None) -> torch.Tensor:
    """``scale`` times a standard normal draw (float32), cast to ``dtype``;
    drawn on the generator's device and then moved to ``device`` (default:
    the generator's)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x.mul_(scale)).to(dtype).to(device or gen.device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def init_rms_norm(d: int, device: torch.device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(float(theta), expo)      # no host-to-device copy


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, [..., seq, 1, head_dim // 2] f32,
    for positions [..., seq]. Every layer of a forward shares them."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs    # [..., seq, half]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos_sin: tuple) -> torch.Tensor:
    """Split-half rotation of x [..., seq, heads, head_dim] by
    `rope_cos_sin`'s angles; math in f32, cast back."""
    cos, sin = cos_sin
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to
    [..., seq]. Split-half convention (Llama / Qwen / NeoX), math in f32."""
    return rotate(x, rope_cos_sin(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# dense MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, device=None,
             gated: bool = True) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    pdt = _dtype(cfg.param_dtype)
    scale_out = 0.02 / (2 * cfg.n_layers) ** 0.5
    p = {"w1": normal_init(gen, (d, f), 0.02, pdt, device),
         "w2": normal_init(gen, (f, d), scale_out, pdt, device)}
    if gated:
        p["w3"] = normal_init(gen, (d, f), 0.02, pdt, device)
    return p


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig,
        act: str = "silu") -> torch.Tensor:
    """SwiGLU when ``w3`` is present, else a plain ``act`` MLP (whisper's
    gelu: `jax.nn.gelu`'s default, the tanh approximation)."""
    cdt = _dtype(cfg.dtype)
    h = torch.matmul(x, p["w1"].to(cdt))
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    if "w3" in p:
        a = a * torch.matmul(x, p["w3"].to(cdt))
    return torch.matmul(a, p["w2"].to(cdt))


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embeddings(gen: torch.Generator, cfg: ModelConfig,
                    device=None) -> dict:
    pdt = _dtype(cfg.param_dtype)
    p = {"tok": normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, pdt,
                            device)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal_init(gen, (cfg.d_model, cfg.vocab), 0.02, pdt,
                                   device)
    return p


def embed(tokens: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["tok"].to(_dtype(cfg.dtype)))


def unembed(h: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits in the activation dtype, then cast to ``cfg.logit_dtype``
    (at bf16 they are rounded to bf16 before the cast, as in the
    reference)."""
    cdt = _dtype(cfg.dtype)
    w = p["tok"].to(cdt).t() if cfg.tie_embeddings \
        else p["unembed"].to(cdt)
    return torch.matmul(h, w).to(_dtype(cfg.logit_dtype))
