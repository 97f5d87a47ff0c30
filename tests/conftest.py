import gc

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess/multi-device tests (deselect with "
        "-m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one (run on "
        "the card with `python -m pytest -m gpu tests/test_torch_*.py`)")


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_executables():
    """Free jitted executables between test modules.

    Every compiled XLA executable holds mmap'd JIT code regions, and a
    full-suite run accumulates enough of them to exhaust the kernel's
    default ``vm.max_map_count`` (65530) — at which point the next
    compile segfaults inside XLA. Tests never share compiled programs
    across module boundaries, so clearing there bounds the map count at
    the single-module high-water mark for free."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()
