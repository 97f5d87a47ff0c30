"""Multi-pod dry run: prove the distribution config is coherent (mirrors
`repro.launch.dryrun`).

For every (architecture x input shape) cell and both production meshes
(16 x 16 one pod, 2 x 16 x 16 two pods) the dry run

  1. joins a fake process group of 256 or 512 ranks in this one process
     (``torch.testing``'s ``FakeStore``: collectives return at once and
     move nothing) and builds the production mesh over it, as rank 0;
  2. builds the cell's step with production shardings
     (`repro_torch.launch.steps.build_step`): its arguments are meta
     DTensors, so nothing is allocated;
  3. runs the step once on them: a layout that does not divide, a
     placement the transport cannot reach or an unsupported collective
     fails here, which is what the dry run is for;
  4. records the rank's argument, output, temporary and peak bytes
     (`torch.distributed._tools.mem_tracker.MemTracker` over the step, the
     arguments' local shards tracked as external), whether the peak fits
     an H100's 80 GB, and the step's counted work
     (`repro_torch.launch.hlo_analysis.analyze`: FLOPs, bytes, collective
     counts and bytes) into a JSON record per cell.

Records go to ``--out`` (default: a new temporary directory), never into
the repository.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --mesh pod
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import traceback
from pathlib import Path

HBM_PER_CARD = 80 * 10 ** 9          # NVIDIA H100 80GB


def _tensor_bytes(tree) -> int:
    from repro_torch.launch.hlo_analysis import _local_bytes
    from repro_torch.optim.adamw import tree_leaves

    return sum(_local_bytes(t) for t in tree_leaves(tree))


def init_fake_world(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (a
    process-wide default group: the dry run's process only)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(cfg, shape, mesh, mesh_name: str, out_dir: Path) -> dict:
    """Build and run one cell's step on meta DTensors; returns (and
    writes) its record."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.steps import build_step
    from repro_torch.optim.adamw import tree_leaves

    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
           "mesh_shape": mesh_shape(mesh), "kind": shape.kind}
    t0 = time.time()
    try:
        step, args, _ = build_step(cfg, shape, mesh)
        rec["build_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves(args)
                                 if t is not None])
        with tracker:
            rep, result = analyze(step, *args)
        rec["run_s"] = round(time.time() - t1, 2)
        peak = sum(v["Total"] for v in
                   tracker.get_tracker_snapshot("peak").values())
        arg_b, out_b = _tensor_bytes(args), _tensor_bytes(result)
        rec["memory"] = {
            "argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": max(peak - arg_b - out_b, 0),
            "peak_bytes": max(peak, arg_b),
            "hbm_per_card": HBM_PER_CARD}
        rec["fits"] = rec["memory"]["peak_bytes"] <= HBM_PER_CARD
        rec["hlo"] = rep.as_dict()
        rec["ok"] = True
    except Exception as e:                     # the dry run's job is to
        rec["ok"] = False                      # surface these
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cfg.name}__{shape.name}.json").write_text(
        json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    from repro_torch.configs.base import (SHAPES, cell_skip_reason,
                                          get_config, list_archs)
    from repro_torch.launch.mesh import (describe, make_production_mesh,
                                         mesh_devices_required)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, help="one shape name")
    ap.add_argument("--mesh", default="both",
                    choices=["both", "pod", "multipod"])
    ap.add_argument("--out", default=None,
                    help="record directory (default: a new temporary one)")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for conv in (int, float):
            try:
                v = conv(v)
                break
            except ValueError:
                pass
        overrides[k] = v
    out = Path(args.out or tempfile.mkdtemp(prefix="dryrun_"))
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [m for m in ("pod", "multipod") if args.mesh in ("both", m)]

    n_fail = 0
    for which in meshes:
        multi = which == "multipod"
        init_fake_world(mesh_devices_required(multi))
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        name = "pod2x16x16" if multi else "pod16x16"
        print(f"=== mesh {describe(mesh)} -> {out / name}")
        for arch in archs:
            cfg = get_config(arch)
            if overrides:
                cfg = cfg.replace(**overrides)
            for shape_name in shapes:
                skip = cell_skip_reason(cfg, SHAPES[shape_name])
                if skip:
                    print(f"  SKIP {arch} x {shape_name}: {skip}")
                    continue
                rec = run_cell(cfg, SHAPES[shape_name], mesh, name,
                               out / name)
                if rec["ok"]:
                    mem = rec["memory"]
                    print(f"  OK   {arch} x {shape_name}: run "
                          f"{rec['run_s']}s  peak/rank "
                          f"{mem['peak_bytes'] / 2**30:.2f} GiB "
                          f"(fits={rec['fits']})  flops/rank "
                          f"{rec['hlo']['flops']:.2e}")
                else:
                    n_fail += 1
                    print(f"  FAIL {arch} x {shape_name}: {rec['error']}")
    print(f"done; {n_fail} failures; records in {out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
