"""Shared layer primitives: norms, MLPs, rotary embeddings, initializers.

Parameters are plain nested dicts of tensors, as in the reference
(`repro.models.layers`); all functions are pure. Norm and rotary math
runs in float32 whatever the activation dtype, and the result is cast
back. Projections are `torch.matmul`: the reference leaves them to XLA,
outside any kernel.

Under a live mesh (`repro_torch.parallel.axes.use_sharding`) tensors are
DTensors and the reference's ``constrain`` points place them. The port
adds the points GSPMD would choose for itself: a weight is gathered over
``data`` at use (its fsdp shard, ZeRO-3 style) by constraining it to its
logical axes without ``embed_p``, and an activation is gathered over the
sequence before a column-parallel product, so that every DTensor
operation finds its operands already placed and moves no data itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.axes import (constrain, current_mesh, from_local,
                                       is_dtensor, local, shard_offsets)

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
    out = xf * torch.rsqrt(var + eps) * constrain(scale, None).float()
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
    if is_dtensor(x):
        cos, sin = (constrain(t, *(("batch",) + (None,) * (t.ndim - 1)))
                    for t in cos_sin)
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
    x = constrain(x, "batch", None, None)
    h = torch.matmul(x, constrain(p["w1"], None, "ffn").to(cdt))
    h = constrain(h, "batch", None, "ffn")
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    if "w3" in p:
        a = a * torch.matmul(x, constrain(p["w3"], None, "ffn").to(cdt))
    return row_parallel(a, constrain(p["w2"], "ffn", None), cdt)


def row_parallel(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype
                 ) -> torch.Tensor:
    """a @ w for a product whose contraction may be split over ranks
    (``a``'s last and ``w``'s first dimension over ``model``). On one
    device: in ``cdt``. Under a mesh the result comes in float32, so that
    the ranks' partial products are summed (by the caller's
    ``constrain``) before the one rounding to ``cdt`` that a single
    matmul makes; the caller casts the reduced result back. Without
    autograd the operands stay in ``cdt`` and only the accumulation and
    the output are float32 (`matmul_f32` on each rank's shards, placed
    by `_product_placements`); under autograd both operands are widened
    and DTensor's matmul places the product."""
    if current_mesh() is None:
        return torch.matmul(a, w.to(cdt))
    w = w.to(cdt)
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad) \
            or not (is_dtensor(a) and is_dtensor(w)):
        return torch.matmul(a.float(), w.float())
    out = matmul_f32(local(a), local(w))
    return from_local(out, a.device_mesh, _product_placements(a, w),
                      tuple(a.shape[:-1]) + (w.shape[-1],))


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [..., K] @ w [K, N] (or batched: a [E, M, K] @ w [E, K, N]),
    accumulated and returned in float32. On the card bf16 / fp16
    operands stay as they are (cuBLAS's float32 output); elsewhere they
    are widened, which gives the same products (a product of two bf16
    or fp16 numbers is exact in float32)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and w.dtype == a.dtype:
        if w.ndim == 3:
            return torch.bmm(a, w, out_dtype=torch.float32)
        out = torch.mm(a.reshape(-1, a.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return torch.matmul(a.float(), w.float())


def _product_placements(a, w) -> tuple:
    """The placements of DTensor a [..., K] @ w [K, N] from its operands'
    on each mesh axis: K split on both -> Partial, a row dimension split
    -> the same, N split -> the last, neither -> Replicate."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    k = a.ndim - 1
    out = []
    for pa, pw in zip(a.placements, w.placements):
        if pa.is_shard(k) and pw.is_shard(0):
            out.append(Partial())
        elif pa.is_shard() and pw.is_replicate():
            out.append(Shard(pa.dim))
        elif pa.is_replicate() and pw.is_shard(1):
            out.append(Shard(k))
        elif pa.is_replicate() and pw.is_replicate():
            out.append(Replicate())
        else:
            raise ValueError(f"row_parallel: operands placed {pa} and "
                             f"{pw} on one mesh axis")
    return tuple(out)


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
    """Rows of the token table. Under a live mesh the table is sharded
    over the vocabulary: each rank looks up the tokens in its range and
    the result is a partial sum over those ranks (``Partial``), which the
    caller's ``constrain`` reduces."""
    cdt = _dtype(cfg.dtype)
    if current_mesh() is None:
        return F.embedding(tokens.long(), p["tok"].to(cdt))
    from torch.distributed.tensor import Partial, Replicate, Shard

    tok = constrain(p["tok"], "vocab", None)
    ids = constrain(tokens, "batch", None)
    table, n = local(tok), local(tok).shape[0]
    idl = local(ids).long() - shard_offsets(tok)[0]
    hit = (idl >= 0) & (idl < n)
    out = F.embedding(idl.clamp(0, n - 1), table.to(cdt)) \
        * hit[..., None].to(cdt)
    placements = [Partial() if isinstance(t, Shard) else
                  Shard(0) if isinstance(i, Shard) else Replicate()
                  for t, i in zip(tok.placements, ids.placements)]
    return from_local(out, tok.device_mesh, placements,
                      tuple(tokens.shape) + (tok.shape[1],))


def unembed(h: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits in the activation dtype, then cast to ``cfg.logit_dtype``
    (at bf16 they are rounded to bf16 before the cast, as in the
    reference)."""
    cdt = _dtype(cfg.dtype)
    w = constrain(p["tok"], "vocab", None).to(cdt).t() \
        if cfg.tie_embeddings \
        else constrain(p["unembed"], None, "vocab").to(cdt)
    logits = torch.matmul(constrain(h, "batch", None, None), w)
    logits = constrain(logits, "batch", None, "vocab")
    return logits.to(_dtype(cfg.logit_dtype))
