"""Optimizer substrate: AdamW, schedules, clipping, gradient compression
(the quantise / de-quantise round trip and its mean over a mesh axis)."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.compress import (compressed_pmean, dequantize,
                                        init_error_feedback, quantize_int8)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = [
    "AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm", "constant", "warmup_cosine",
    "compressed_pmean", "init_error_feedback", "quantize_int8",
    "dequantize",
]
