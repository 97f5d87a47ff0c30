"""The LLM model stack: configs in `repro_torch.configs`, the dense
family's layers, attention and assembly here (the serving path)."""

from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      params_from_numpy, prefill)

__all__ = [
    "init_params",
    "params_from_numpy",
    "prefill",
    "decode_step",
    "init_cache",
]
