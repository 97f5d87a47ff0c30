#!/usr/bin/env python3
"""Where the soft ledger pair (`soft_ledger_fwd` / `soft_ledger_bwd`,
``src/repro_torch/kernels/csrc/queue_scan.cu``) spends its time, on one
GPU.

    python3 ledger_probe.py [--parent DIR]

Builds ``queue_scan.cu`` as it is and in variants (each a text
substitution of the source, built by nvcc in parallel into
``build/ledger_probe/``), loads each in place of the package's library
and times the pair through the package's own wrappers with
`chip_smoke.py`'s device-only CUDA events (L2 flushed for the shapes of
more than one row, medians):

- float32 at the tuner's 256 x 2190 h, d 4; at `workload_fleet`'s 16
  rows; at one row (the serial floor: one row's chain alone); at d 48
  (a two-day deadline);
- float64 at 256 x 2190 h, d 4.

The variants change the float32 transcendentals of the smoothclips and
their sigmoids: where the source takes them in float64 and rounds once
("float32 exp / log1p": CUDA's expf / log1pf instead), or where it takes
them in float32 ("float64 exp / log1p": the float64 functions, rounded
once, instead); "hard clips (timing only)" replaces every smoothclip by
clip(z, 0, w), so its time is the chain without the clips' arithmetic
and its outputs mean nothing. A source that holds the text of neither
transcendental form, or not that of the clip, stops the probe with an
error: the substitutions below then need updating. Each variant's outputs are held against the source as it is
(max |difference| over max(1, max |as built|)).

``--parent DIR`` also times another checkout (for example the parent
commit, unpacked with `git archive`) through its own package, in turns
with this tree's: parent, this tree, this tree, parent, each in a
process of its own. Prints one line a measurement and needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ledger_probe"

# the float32 instantiation's exp / log1p: in float64, rounded once (the
# earlier design) or CUDA's float32 functions
F64_EXP = "  return (float)exp((double)x);\n"
F64_LOG1P = "  return (float)log1p((double)x);\n"
F32_EXP = "  return expf(x);\n"
F32_LOG1P = "  return log1pf(x);\n"
# every clip hard: the soft kernels' smoothclips become clip(z, 0, w)
HARD_CLIP = "  if (HARD) {\n    const T lo"

SHAPES = (("float32", 256, 2190, 4), ("float32", 16, 2190, 4),
          ("float32", 1, 2190, 4), ("float32", 256, 2190, 48),
          ("float64", 256, 2190, 4))
TAU, BOUND = 0.3, 4.0


def variants(src: str) -> dict[str, str]:
    """name -> source: as built, its float32 instantiation's exp / log1p
    in the other form, and every clip hard; raises when the source holds
    the text of neither form or not the clip's."""
    out = {"as built": src}
    if F64_EXP in src and F64_LOG1P in src:
        out["float32 exp / log1p"] = src.replace(F64_EXP, F32_EXP).replace(
            F64_LOG1P, F32_LOG1P)
    elif F32_EXP in src and F32_LOG1P in src:
        out["float64 exp / log1p"] = src.replace(F32_EXP, F64_EXP).replace(
            F32_LOG1P, F64_LOG1P)
    else:
        raise SystemExit("ledger_probe: queue_scan.cu's float32 exp / log1p "
                         "match neither F64_* nor F32_*; update them")
    if HARD_CLIP not in src:
        raise SystemExit("ledger_probe: queue_scan.cu's clip does not "
                         "match HARD_CLIP; update it")
    out["hard clips (timing only)"] = src.replace(
        HARD_CLIP, HARD_CLIP.replace("HARD", "true"))
    return out


def _build(build, text: str) -> Path:
    """nvcc the source text with the package's flags; cached by content."""
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    lib = OUT / f"libqueue_scan-{key}.so"
    if lib.exists():
        return lib
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"queue_scan-{key}.cu"
    src.write_text(text)
    proc = subprocess.run([build.nvcc_path(), *build.flags("queue_scan"),
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return lib


def _inputs(dtype: str, b: int, t: int, dev):
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    a = torch.as_tensor(rng.uniform(0.0, 1.5, (b, t)), device=dev).to(dt)
    c = torch.as_tensor(rng.uniform(0.0, 2.0, (b, t)), device=dev).to(dt)
    g = torch.as_tensor(rng.normal(size=(4, b)), device=dev).to(dt)
    tau = torch.tensor([TAU], dtype=dt, device=dev)
    return a, c, g.contiguous(), tau


def worker(src_dir: Path, tag: str) -> None:
    sys.path.insert(0, str(src_dir))
    sys.path.insert(1, str(ROOT))
    from repro_torch.kernels import build
    from repro_torch.kernels import queue_scan as qs

    import chip_smoke as cs
    if not Path(qs.__file__).resolve().is_relative_to(src_dir.resolve()):
        raise AssertionError(f"probe: imported {qs.__file__}, not {src_dir}")
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    texts = variants((build.CSRC / "queue_scan.cu").read_text())
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(lambda s: _build(build, s),
                                        texts.values())))
    base = {}
    for name, lib in libs.items():
        build._loaded["queue_scan"] = ctypes.CDLL(str(lib))
        for dtype, b, t, d in SHAPES:
            a, c, g, tau = _inputs(dtype, b, t, dev)
            kw = dict(deadline=d, bound=BOUND)
            fwd = qs.soft_ledger_fwd(a, c, tau, **kw)
            bwd = qs.soft_ledger_bwd(a, c, tau, fwd[1], g, **kw)
            outs = [fwd[0], fwd[2], *bwd]
            key = (dtype, b, t, d)
            if name == "as built":
                base[key] = outs
                err = 0.0
            else:
                err = max(float((x - y).abs().max())
                          / max(1.0, float(y.abs().max()))
                          for x, y in zip(outs, base[key]))
            big = b > 1
            runs = 3 if d > 8 or b == 1 else 5
            f_ms = cs._cuda_ms(lambda: qs.soft_ledger_fwd(a, c, tau, **kw),
                               runs=runs, flush=flush if big else None,
                               device_only=True)
            hist = fwd[1]
            b_ms = cs._cuda_ms(lambda: qs.soft_ledger_bwd(
                a, c, tau, hist, g, want_demand=False, **kw), runs=runs,
                flush=flush if big else None, device_only=True)
            n0 = qs.soft_ledger_bwd.device_launches
            qs.soft_ledger_bwd(a, c, tau, hist, g, want_demand=False, **kw)
            kernels = qs.soft_ledger_bwd.device_launches - n0
            print(f"[probe] {tag} | {name} | {dtype} {b} x {t} h, d {d}: "
                  f"soft_ledger_fwd {f_ms:.4f} ms, soft_ledger_bwd "
                  f"{b_ms:.4f} ms ({kernels} kernels); max scaled "
                  f"difference from as built {err:.3g}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ledger_probe: CUDA is not available", file=sys.stderr)
        return 1
    if args.worker is not None:
        worker(args.worker, args.tag)
        return 0
    print("[probe] " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    runs = [("tree", ROOT)]
    if args.parent is not None:
        runs = [("parent", args.parent), ("tree", ROOT), ("tree", ROOT),
                ("parent", args.parent)]
    for tag, root in runs:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", str(root / "src"), "--tag", tag],
                              check=False)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
