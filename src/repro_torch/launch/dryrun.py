"""Dry run on one H100: every (arch x shape) cell's step run once at full
width on the meta device (nothing is allocated, no card is needed), its
FLOPs, bytes and memory counted, and the three roofline terms on the H100's
constants; counterpart of ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--json out.jsonl] [--jobs 4]

The mesh is one H100 (``1x1:data,model``); the dry run on the
production meshes (16 x 16 and 2 x 16 x 16) is not ported yet. A cell fits when its arguments and its peak of
new bytes (``per_device_bytes``) fit the card's memory: on the card
``torch.cuda.get_device_properties``, elsewhere the H100's 80 GB. Exit code
0 only if every requested cell runs.
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import sys
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.hlo_analysis import memory_analysis_dict
from repro_torch.distributed.roofline import HBM_BYTES, RooflineTerms
from repro_torch.launch.mesh import MULTI_POD_TODO, Mesh, mesh_name
from repro_torch.models.config import SHAPES, cell_supported, get_shape
from repro_torch.runtime.step_builder import build_step, model_flops_for_cell

# one H100, described: the dry run lowers on the meta device and runs nothing
DRYRUN_MESH = Mesh(("data", "model"), (1, 1))


@functools.lru_cache(maxsize=None)
def device_bytes() -> float:
    """The card's memory where one is present, else the H100's 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    verbose: bool = True,
    rules_overrides: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> Dict[str, Any]:
    """Lower one cell on the meta device; returns its record. The
    reference's ``multi_pod`` picks its 2 x 16 x 16 production mesh, which
    the port has not yet (``MULTI_POD_TODO``): True raises."""
    if multi_pod:
        raise NotImplementedError(f"run_cell(multi_pod=True): {MULTI_POD_TODO}")
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": why}

    mesh = DRYRUN_MESH
    chips = mesh.size
    lowered = build_step(cfg, shape, mesh, rules_overrides=rules_overrides).lower()
    costs = lowered.costs
    mem = memory_analysis_dict(lowered)
    # the port's temp holds the step's new outputs, so the arguments and the
    # temp peak are what the step needs at once
    per_dev_bytes = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    capacity = device_bytes()
    model_flops = model_flops_for_cell(cfg, shape)
    terms = RooflineTerms(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name(mesh),
        chips=chips,
        hlo_flops=costs.flops * chips,
        hlo_bytes=costs.bytes * chips,
        model_flops=model_flops,
    )
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(mesh),
        "status": "ok",
        "chips": chips,
        "meta_s": round(lowered.seconds, 2),
        "memory_analysis": mem,
        "per_device_bytes": per_dev_bytes,
        "device_bytes": capacity,
        "fits": per_dev_bytes <= capacity,
        "hlo_flops": costs.flops * chips,
        "hlo_bytes": costs.bytes * chips,
        "kernels": {k: {"calls": v.calls, "flops": v.flops, "bytes": v.bytes, "bound_s": v.bound_s}
                    for k, v in costs.kernels.items()},
        "model_flops": model_flops,
        "roofline": terms.row(),
        "step_time_s": terms.step_time_s,
    }
    if verbose:
        print(f"=== {arch} x {shape_name} @ {mesh_name(mesh)} ===")
        print(f"  meta run {lowered.seconds:.2f}s")
        print(f"  memory_analysis: {mem}")
        print(f"  per-device bytes: {per_dev_bytes / 1e9:.3f} GB (card {capacity / 1e9:.1f} GB)"
              f"{'' if record['fits'] else '  DOES NOT FIT'}")
        print(f"  totals: flops={costs.flops:.3e} bytes={costs.bytes:.3e} "
              f"kernels={ {k: v.calls for k, v in costs.kernels.items()} }")
        print(f"  roofline: {terms.render()}")
    return record


def _safe_cell(cell: Tuple[str, str], verbose: bool = True) -> Dict[str, Any]:
    """``run_cell``, with a failure turned into an ``error`` record."""
    arch, shape = cell
    try:
        return run_cell(arch, shape, verbose=verbose)
    except Exception as e:  # noqa: BLE001 - every failing cell is reported, then the exit code
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "status": "error", "error": f"{type(e).__name__}: {e}"}


def _quiet_cell(cell: Tuple[str, str]) -> Dict[str, Any]:
    return _safe_cell(cell, verbose=False)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=ARCHS)
    p.add_argument("--shape", choices=[s.name for s in SHAPES])
    p.add_argument("--all", action="store_true", help="every (arch x shape)")
    p.add_argument("--json", help="append JSONL records here")
    p.add_argument("--jobs", type=int, default=1, help="cells run at once, each in its own process")
    args = p.parse_args()

    if args.all:
        cells = [(a, s.name) for a in ARCHS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    if args.jobs > 1:
        # spawned workers: no state (a CUDA context among it) is shared
        with ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            records = list(pool.map(_quiet_cell, cells))
        for r in records:
            if r["status"] == "ok":
                print(f"{r['arch']:24s} {r['shape']:12s} meta {r['meta_s']:6.2f}s "
                      f"{r['per_device_bytes'] / 1e9:9.3f} GB fits={r['fits']} "
                      f"C={r['roofline']['compute_s']}s M={r['roofline']['memory_s']}s "
                      f"dom={r['roofline']['dominant']}")
            else:
                print(f"{r['arch']:24s} {r['shape']:12s} {r['status']}: {r.get('reason') or r.get('error')}")
    else:
        records = [_safe_cell(c) for c in cells]
    if args.json:
        with open(args.json, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")

    n_ok = sum(1 for r in records if r["status"] == "ok")
    n_skip = sum(1 for r in records if r["status"] == "skipped")
    failures = sum(1 for r in records if r["status"] == "error")
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {failures} failed")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
