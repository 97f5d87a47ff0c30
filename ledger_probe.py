#!/usr/bin/env python3
"""Where the work ledger's kernels (``src/repro_torch/kernels/csrc/
queue_scan.cu``) spend their time, on one GPU.

    python3 ledger_probe.py [--only hard,soft] [--parent DIR]

Builds ``queue_scan.cu`` as it is and in variants (each a text
substitution of the source, built by nvcc in parallel into
``build/ledger_probe/``), loads each in place of the package's library
and times the kernels through the package's own wrappers with
`chip_smoke.py`'s device-only CUDA events (L2 flushed for the shapes of
more than one row, medians).

The hard ledger (`workload_ledger_fwd`), without and with telemetry
(``hourly=True``), at 256 rows x 4096 h x 8 draws, d 4 (the chip
check's benchmark shape, 8 markets read through the index); on one
lane (the serial floor); at `workload_fleet`'s 16 x 2190 h x 32 draws;
at d 9 (the queue in device memory). Its variants split the hour and are
for timing only (their outputs mean nothing and are not compared):
"no ledger" skips the queue's hour (the loads, the shutdown states and
the sums stay), "no loads" takes each hour's price and demand from a
register instead of memory (the queue's chain stays), "no draw sum"
writes one draw's value in place of each hourly sum over the draws (with
telemetry only). The substitutions are written for two designs of the
kernel, the plain hour loop (loads in the hour, telemetry summed behind
two barriers an hour) and the windowed one; a source that holds the text
of neither stops the probe with an error.

The soft pair (`soft_ledger_fwd` / `soft_ledger_bwd`):

- float32 at the tuner's 256 x 2190 h, d 4; at `workload_fleet`'s 16
  rows; at one row (the serial floor: one row's chain alone); at d 48
  (a two-day deadline);
- float64 at 256 x 2190 h, d 4.

Its variants change the float32 transcendentals of the smoothclips and
their sigmoids: where the source takes them in float64 and rounds once
("float32 exp / log1p": CUDA's expf / log1pf instead), or where it takes
them in float32 ("float64 exp / log1p": the float64 functions, rounded
once, instead); "hard clips (timing only)" replaces every smoothclip by
clip(z, 0, w), so its time is the chain without the clips' arithmetic
and its outputs mean nothing. A source that holds the text of neither
transcendental form, or not that of the clip, stops the probe with an
error: the substitutions below then need updating. Each soft variant's
outputs are held against the source as it is (max |difference| over
max(1, max |as built|)).

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

# The hard kernel's variants, for each design: name -> [(text, replacement)]
# (timing only). The hour loop: each hour loads its price and demand,
# runs hour_fwd and, with telemetry, sums the draws behind two barriers.
HOUR_LOOP = {
    "no ledger": [(
        "      hour_fwd<true, D>(q, d, a, cmwh * cap, bound, 0.f, served, "
        "dropped,\n                        bl);\n",
        "      served = cmwh * cap;\n      dropped = a;\n"
        "      bl = served - a;\n")],
    "no loads": [
        ("  const float cmwh = cap_mwh[rw], dtb = dt[rw];\n",
         "  const float cmwh = cap_mwh[rw], dtb = dt[rw];\n"
         "  const float p_reg = prow[0], d_reg = drow[0];\n"),
        ("      const float p = prow[t];\n",
         "      const float p = p_reg + (float)(t & 31);\n"),
        ("      a = dtb * drow[t];\n", "      a = dtb * d_reg;\n")],
    "no draw sum": [(
        "          for (int j = 0; j < G; ++j) s = s + tel[qq * nt + rr * G "
        "+ j];\n",
        "          s = tel[qq * nt + rr * G];\n")],
}
# The windowed design: a window's loads issued a window ahead, its
# shutdown states first, each hour the closed form on the queue's prefix
# sums, telemetry summed from a shared ring once a window.
WINDOWED = {
    "no ledger": [(
        "        hard_hour<D>(P, d, a, cw[h], bnd, served, dropped, bl);\n",
        "        served = cw[h];\n        dropped = a;\n"
        "        bl = served - a;\n")],
    "no loads": [
        ("  const float cmwh = cap_mwh[rw], dtb = dt[rw];\n",
         "  const float cmwh = cap_mwh[rw], dtb = dt[rw];\n"
         "  const float p_reg = prow[0], d_reg = drow[0];\n"),
        ("      pn[h] = t < T ? prow[t] : 0.f;\n"
         "      dn[h] = t < T ? drow[t] : 0.f;\n",
         "      pn[h] = p_reg + (float)(t & 31);\n      dn[h] = d_reg;\n")],
    "no draw sum": [(
        "  for (int j = 0; j < G; ++j) acc = acc + x[j * LS];\n",
        "  acc = x[0];\n"),
        ("      acc[i].x = acc[i].x + v.x;\n      acc[i].y = acc[i].y + v.y;\n"
         "      acc[i].z = acc[i].z + v.z;\n      acc[i].w = acc[i].w + v.w;\n",
         "      acc[i] = v;\n")],
}
HARD_DESIGNS = {"hour loop": HOUR_LOOP, "windowed": WINDOWED}
# rows, markets, draws, hours, deadline
HARD_SHAPES = (("256 x 4096 h x 8 draws", 256, 8, 8, 4096, 4),
               ("one lane", 1, 1, 1, 4096, 4),
               ("16 x 2190 h x 32 draws", 16, 16, 32, 2190, 4),
               ("d 9", 256, 8, 8, 4096, 9))
HARD_BOUND = 4.0

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


def hard_variants(src: str) -> dict[str, str]:
    """name -> source: the hard kernel as built and its timing variants
    for the design whose texts the source holds; raises when it holds
    those of no design."""
    for design, subs in HARD_DESIGNS.items():
        if all(old in src for pairs in subs.values() for old, _ in pairs):
            out = {"as built": src}
            for name, pairs in subs.items():
                text = src
                for old, new in pairs:
                    text = text.replace(old, new)
                out[f"{name} ({design})"] = text
            return out
    raise SystemExit("ledger_probe: queue_scan.cu's hard kernel matches no "
                     "design in HARD_DESIGNS; update them")


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


def _hard_inputs(b: int, n: int, g: int, t: int, dev):
    rng = np.random.default_rng(7)
    p_off = rng.uniform(40.0, 160.0, b).astype(np.float32)
    arrays = (rng.normal(80.0, 40.0, (n, t)).astype(np.float32),
              p_off * np.float32(0.9), p_off,
              rng.uniform(0.0, 0.6, b).astype(np.float32),
              rng.uniform(1.0, 4.0, b).astype(np.float32),
              rng.uniform(0.0, 3.0, (g, t)).astype(np.float32),
              np.ones(b, np.float32))
    args = [torch.as_tensor(a, device=dev) for a in arrays]
    return args, torch.arange(b, device=dev) % n


def hard_section(libs: dict, build, qs, cs, tag: str, flush) -> None:
    dev = flush.device
    for name, lib in libs.items():
        build._loaded["queue_scan"] = ctypes.CDLL(str(lib))
        for label, b, n, g, t, d in HARD_SHAPES:
            args, midx = _hard_inputs(b, n, g, t, dev)
            big = b > 1

            def call(hourly, args=args, midx=midx, d=d):
                return qs.workload_ledger_fwd(
                    *args, deadline=d, bound=HARD_BOUND, market_idx=midx,
                    hourly=hourly)
            ms = {}
            for hourly in (False, True):
                if hourly or not name.startswith("no draw sum"):
                    ms[hourly] = cs._cuda_ms(
                        lambda h=hourly: call(h), runs=5,
                        flush=flush if big else None, device_only=True)
            print(f"[probe] {tag} | hard | {name} | {label}, d {d}: "
                  + (f"workload_ledger_fwd {ms[False]:.4f} ms, "
                     if False in ms else "")
                  + f"with telemetry {ms[True]:.4f} ms"
                  + ("" if name == "as built" else " (timing only)"),
                  flush=True)


def soft_section(libs: dict, build, qs, cs, tag: str, flush) -> None:
    dev = flush.device
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


def worker(src_dir: Path, tag: str, only: set) -> None:
    sys.path.insert(0, str(src_dir))
    sys.path.insert(1, str(ROOT))
    from repro_torch.kernels import build
    from repro_torch.kernels import queue_scan as qs

    import chip_smoke as cs
    if not Path(qs.__file__).resolve().is_relative_to(src_dir.resolve()):
        raise AssertionError(f"probe: imported {qs.__file__}, not {src_dir}")
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    src = (build.CSRC / "queue_scan.cu").read_text()
    sets = {"hard": hard_variants(src) if "hard" in only else {},
            "soft": variants(src) if "soft" in only else {}}
    texts = sorted({x for v in sets.values() for x in v.values()})
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda x: _build(build, x), texts)))
    if "hard" in only:
        hard_section({k: built[x] for k, x in sets["hard"].items()}, build,
                     qs, cs, tag, flush)
    if "soft" in only:
        soft_section({k: built[x] for k, x in sets["soft"].items()}, build,
                     qs, cs, tag, flush)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--only", default="hard,soft",
                    help="the kernels to probe: hard, soft or both")
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ledger_probe: CUDA is not available", file=sys.stderr)
        return 1
    only = set(args.only.split(","))
    if not only or only - {"hard", "soft"}:
        ap.error(f"--only takes hard, soft or both, got {args.only!r}")
    if args.worker is not None:
        worker(args.worker, args.tag, only)
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
                               "--worker", str(root / "src"), "--tag", tag,
                               "--only", args.only],
                              check=False)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
