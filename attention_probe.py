#!/usr/bin/env python3
"""Where the bf16 attention kernels spend their time, on one GPU.

    python3 attention_probe.py

Builds `src/repro_torch/kernels/csrc/attention.cu` as it is and in
variants with one part taken out (each a text substitution of the source
that must match, built by nvcc in parallel into
`build/attention_probe/`), then times each variant with `chip_smoke.py`'s
device-only CUDA events (L2 flushed, medians of 10 runs):

- flash at qwen2.5-3b's prefill shape (Sq = Skv 1024, causal, 16 heads /
  2 groups, Dh 128, bf16), and with 2 heads (32 blocks, one an SM, 16 KV
  tiles each, non-causal): that time over 16 is a lone block's time a
  64-key tile;
- decode at the serving pool (8 slots x 2048, linear mask, bf16).

A variant computes garbage where a part is gone; only its time means
anything. Prints one line a variant and needs CUDA.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# the next tile's copies, issued after the scores; moved before them
COPIES = ("    if (t < t_hi) {\n"
          "      if (t == t_lo) __syncthreads();        "
          "// every warp's q is in registers\n"
          "      load_kv(t + 1, st ^ 1);\n"
          "      cp_async_commit();\n"
          "    }\n")
SCORES = ("    // S = Q K^T: column tiles 2 np and 2 np + 1 from one "
          "ldmatrix.x4\n")
SOFTMAX_START = "    // online softmax in registers, in base 2"
SOFTMAX_END = "    // O += P V: p rounded to bf16"
FLASH_MMA = ["        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);\n",
             "        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);\n",
             "        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);\n",
             "        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);\n"]
FOLD = ("  fold_if_last<bf16, DH>(a, b, g, "
        "reinterpret_cast<float*>(smem_f4));\n")


def variants(src: str) -> dict[str, tuple[str, int]]:
    """name -> (source, decode split in slots)."""
    def sub(text, pairs):
        for old, new in pairs:
            if old not in text:
                raise AssertionError(f"probe: {old[:60]!r} not in the source")
            text = text.replace(old, new, 1)
        return text

    fl = src.index("flash_mma_kernel(const Args a)")
    softmax = src[src.index(SOFTMAX_START, fl):src.index(SOFTMAX_END, fl)]
    return {
        "as built": (src, 256),
        "flash, copies before the scores": (
            sub(src, [(COPIES, ""), (SCORES, COPIES + SCORES)]), 256),
        "flash, no copies after the first tile": (
            sub(src, [(COPIES, COPIES.replace("if (t < t_hi)", "if (false)")),
                      ("const int st = (t - t_lo) & 1;",
                       "const int st = 0;")]), 256),
        "flash, no mma": (sub(src, [(m, "") for m in FLASH_MMA]), 256),
        "flash, no softmax": (sub(src, [(softmax, "")]), 256),
        "decode, no fold": (sub(src, [(FOLD, "")]), 256),
        "decode, 128-slot splits": (
            sub(src, [("constexpr int kSplit = 256;",
                       "constexpr int kSplit = 128;")]), 128),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    out = ROOT / "build" / "attention_probe"
    out.mkdir(parents=True, exist_ok=True)
    todo = variants((build.CSRC / "attention.cu").read_text())

    def compile_one(item):
        i, (name, (text, _)) = item
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        proc = subprocess.run([build.nvcc_path(), *build.flags("attention"),
                               "-o", str(so), str(cu)],
                              capture_output=True, text=True, check=False)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        return so

    with ThreadPoolExecutor(len(todo)) as pool:
        libs = list(pool.map(compile_one, enumerate(todo.items())))

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.phase_device()
    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    shapes = {h: cs._attn_inputs([(1, 1024, h, 128), (1, 1024, 2, 128),
                                  (1, 1024, 2, 128)], cs.BF16, dev, 900)
              for h in (16, 2)}
    q, k, v = cs._attn_inputs([(8, 1, 16, 128), (8, 2048, 2, 128),
                               (8, 2048, 2, 128)], cs.BF16, dev, 950)
    valid = cs._decode_valid(8, 2048, "linear", dev, 951)
    split = dmod.DECODE_SPLIT
    try:
        for (name, (_, d_split)), so in zip(todo.items(), libs):
            build._loaded["attention"] = ctypes.CDLL(str(so))
            dmod.DECODE_SPLIT = d_split       # the wrapper's scratch size
            f16 = cs._cuda_ms(lambda: flash_attention(*shapes[16],
                                                      causal=True),
                              flush=flush, device_only=True)
            f2 = cs._cuda_ms(lambda: flash_attention(*shapes[2],
                                                     causal=False),
                             flush=flush, device_only=True)
            dec = cs._cuda_ms(lambda: decode_attention(q, k, v, valid),
                              flush=flush, device_only=True)
            torch.cuda.synchronize()
            for buf in dmod._counters.values():   # a variant without the
                buf.zero_()                       # fold leaves tickets
            print(f"[probe] {name}: flash 1024 causal, 16 heads "
                  f"{f16:.4f} ms; lone block {f2 / 16 * 1e3:.2f} us a "
                  f"tile; decode 8 x 2048 {dec:.4f} ms", flush=True)
    finally:
        dmod.DECODE_SPLIT = split
        build._loaded.pop("attention", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
