"""Architecture + shape configuration system.

Every assigned architecture registers a ``ModelConfig`` (exact
public-literature dimensions) via its module in
``repro_torch/configs/<id>.py``.
Shapes are the assigned LM shape set; `runnable_cells` encodes the
skip rules (long_500k only for sub-quadratic archs; see DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                   # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    # sliding-window attention (0 = full)
    swa_window: int = 0
    # hybrid (zamba2): shared attention block applied every k SSM blocks
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # modality frontend stub: None | 'audio' | 'vision'
    frontend: Optional[str] = None
    vis_tokens: int = 256          # patch embeddings for 'vision' frontend
    # numerics / performance knobs
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "bfloat16"
    moment_dtype: str = "float32"  # optimizer moments (bf16 for >=100B)
    logit_dtype: str = "float32"
    remat: str = "full"            # none | full | dots
    attn_impl: str = "xla"         # xla (blockwise online-softmax) | pallas
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    kv_cache_dtype: str = "bfloat16"  # int8 enables quantised KV (opt)
    kv_cache_align: int = 0        # store caches with KV heads replicated
                                   # to this count (Megatron GQA layout for
                                   # decode: even head sharding, no cache
                                   # reshard collectives; 0 = n_kv_heads)
    loss_chunk: int = 512          # seq-chunked cross-entropy (0 = off):
                                   # never materialises [B,S,V] logits
    train_microbatches: int = 1    # gradient accumulation (per train step)
    grad_accum_dtype: str = "float32"  # bf16 halves the accumulator (the
                                   # largest single state tensor of a 314B
                                   # train step) at ~1-2 mantissa bits of
                                   # accumulation error over <=16 terms

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def cache_heads(self) -> int:
        """KV-head count as stored in decode caches (>= n_kv_heads)."""
        if self.kv_cache_align and self.n_kv_heads \
                and self.kv_cache_align > self.n_kv_heads \
                and self.n_heads % self.kv_cache_align == 0 \
                and self.kv_cache_align % self.n_kv_heads == 0:
            return self.kv_cache_align
        return self.n_kv_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM state, hybrid with
        TP-sharded shared-attn KV, or sliding-window attention.)"""
        return self.family in ("ssm", "hybrid") or self.swa_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def replace(self, **kw) -> "ShapeSpec":
        return dataclasses.replace(self, **kw)


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "mamba2-1.3b",
    "qwen2.5-14b",
    "stablelm-1.6b",
    "qwen1.5-0.5b",
    "qwen2.5-3b",
    "zamba2-1.2b",
    "whisper-large-v3",
    "grok-1-314b",
    "mixtral-8x22b",
    "internvl2-76b",
]

ARCH_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_REGISTRY:
        mod = arch.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return ARCH_REGISTRY[arch]


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if the (arch, shape) cell must run; else the documented reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (see DESIGN.md §6)")
    return None


def runnable_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if cell_skip_reason(cfg, shape) is None:
                cells.append((arch, shape.name))
    return cells
