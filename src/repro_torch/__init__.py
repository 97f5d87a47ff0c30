"""PyTorch/CUDA port of `repro` (the JAX reference package).

Module paths and public names mirror the reference
(`repro_torch.fleet.engine` <-> `repro.fleet.engine`). The port imports
neither JAX nor the reference package. Entry points take ``device=None``,
meaning ``"cuda"``, and raise without CUDA unless ``device="cpu"`` is
passed (`repro_torch.device.resolve_device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
