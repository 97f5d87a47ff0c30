"""Build and load the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with `ctypes`.
The build happens on first use and is keyed by a hash of the source, the
``csrc/`` headers it includes and the flags, so a changed source or
header is rebuilt and an unchanged one is loaded from
``build/repro_torch_kernels/`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
# in a checkout (src/ layout) the libraries go to <root>/build/, which git
# ignores; an installed package builds into its own directory
BUILD_DIR = (_HERE.parents[2] / "build" / "repro_torch_kernels"
             if _HERE.parents[1].name == "src" else _HERE / "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source only: the soft-dispatch and soft-scan kernels round
# every float32 (and float64) operation as their plain versions (and the
# soft scan's segmented mirrors) do, with no fused multiply-add
SOURCE_FLAGS = {"soft_dispatch": ("-fmad=false",),
                "soft_scan": ("-fmad=false",)}

_loaded: dict[str, ctypes.CDLL] = {}   # one CDLL per library per process
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels are built from source on first use")
    return found


def flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu`` (``csrc/`` on the include path,
    so that a copy of a source built elsewhere finds its headers)."""
    return NVCC_FLAGS + ("-I", str(CSRC)) + SOURCE_FLAGS.get(name, ())


def _source_bytes(path: Path, seen: set) -> bytes:
    """The file's bytes followed by those of each ``csrc/`` header it
    includes with quotes, recursively, each once."""
    text = path.read_bytes()
    out = [text]
    for inc in _LOCAL_INCLUDE.findall(text):
        header = CSRC / inc.decode()
        if header not in seen:
            seen.add(header)
            out.append(_source_bytes(header, seen))
    return b"".join(out)


def library_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu", set())
    # the flags without the include path, which names this checkout
    key_flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
    key = hashlib.sha256(src + " ".join(key_flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into `library_path`; returns nvcc's
    output (with ``-Xptxas -v``: registers, shared memory and spills of
    each kernel) and raises with it if the build fails."""
    lib_path = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: no half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        lib_path = library_path(name)
        if not lib_path.exists():
            build(name)
        _loaded[name] = ctypes.CDLL(str(lib_path))
    return _loaded[name]


def kernels_launched(name: str) -> int:
    """How many kernels the library built from ``csrc/<name>.cu`` has
    launched in this process: its C entries count each launch they issue,
    so a wrapper reads this before and after its call to count the
    kernels that call put on the card."""
    fn = load(name).kernels_launched
    fn.argtypes, fn.restype = [], ctypes.c_ulonglong
    return fn()
