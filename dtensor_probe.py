#!/usr/bin/env python3
"""DTensor's own redistribution under gloo on CUDA tensors, on one GPU.

    python3 dtensor_probe.py

The model mesh never calls DTensor's own redistribution
(``DTensor.redistribute``, its functional collectives): every placement
change goes through the port's transport (`repro_torch.parallel.axes`),
and `chip_smoke.py`'s `phase_model_mesh` refuses DTensor's own path. This
probe shows why: it tries each redistribution the model mesh needs once,
in 2 fresh gloo ranks on cuda:0, and prints "ok", "wrong values" or how
the ranks ended (the all-gather, Shard -> Replicate: a SIGSEGV with
torch 2.11.0+cu128 on an H100). A rank that dies is the result, not an
error. Exits non-zero without CUDA.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

REDISTRIBUTIONS = ("Shard->Replicate", "Partial->Shard",
                   "Shard(seq)->Shard(heads)")


def _dtensor_own_rank(rank: int, world: int, rendezvous: str, work: str,
                      what: str) -> None:
    """DTensor's own redistribution (``DTensor.redistribute``, its
    functional collectives) of a [2, 8, world, 16] CUDA tensor over gloo:
    "ok" if it returns the right values; the process may die instead."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = DeviceMesh("cuda", torch.arange(world))
        full = torch.randn(2, 8, world, 16, generator=torch.Generator()
                           .manual_seed(0)).to(dev)
        src, dst = {"Shard->Replicate": (Shard(1), Replicate()),
                    "Partial->Shard": (Partial(), Shard(2)),
                    "Shard(seq)->Shard(heads)": (Shard(1), Shard(2))}[what]
        loc = full / world if isinstance(src, Partial) \
            else full.chunk(world, dim=1)[rank]
        d = DTensor.from_local(loc.contiguous(), mesh, [src],
                               run_check=False)
        got = d.redistribute(mesh, [dst]).to_local()
        want = full if isinstance(dst, Replicate) \
            else full.chunk(world, dim=dst.dim)[rank]
        ok = bool(torch.allclose(got, want, atol=1e-6))
        torch.save("ok" if ok else "wrong values",
                   Path(work) / f"own{rank}.pt")
    finally:
        dist.destroy_process_group()


def probe() -> dict:
    """Each of REDISTRIBUTIONS tried once in 2 fresh gloo ranks on the
    card: "ok", "wrong values", or how the ranks ended."""
    out = {}
    for what in REDISTRIBUTIONS:
        work = Path(tempfile.mkdtemp(prefix="dtensor_own_"))
        try:
            torch.multiprocessing.start_processes(
                _dtensor_own_rank, args=(2, str(work / "rv"), str(work),
                                         what),
                nprocs=2, join=True, start_method="spawn")
            out[what] = torch.load(work / "own0.pt")
        except Exception as e:             # a rank that died is the result
            out[what] = f"{type(e).__name__}: {str(e)[:80]}"
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("dtensor_probe: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    out = probe()
    print(f"DTensor's own redistribution under gloo on CUDA tensors (torch "
          f"{torch.__version__}, {torch.cuda.get_device_name(0)}), 2 ranks: "
          f"{out} ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
