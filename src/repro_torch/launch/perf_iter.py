"""Perf iteration: lower one cell on the meta device with config
overrides and print the roofline terms, the kernels' calls with their
bounds, and the ops that move the most bytes (the port's steps move no
collective bytes on one device); counterpart of ``repro.launch.perf_iter``.

    PYTHONPATH=src python -m repro_torch.launch.perf_iter --arch X --shape Y \
        [--set remat_policy=dots] [--set ssm_chunk=128]
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.hlo_analysis import memory_analysis_dict
from repro_torch.distributed.hlo_costs import ModuleCosts
from repro_torch.distributed.roofline import RooflineTerms
from repro_torch.launch.dryrun import DRYRUN_MESH
from repro_torch.launch.mesh import MULTI_POD_TODO, mesh_name
from repro_torch.models.config import SHAPES, ShapeConfig, get_shape
from repro_torch.runtime.step_builder import build_step, model_flops_for_cell


def run_iteration(
    arch: str,
    shape_name: Union[str, ShapeConfig],
    overrides: Optional[Dict[str, Any]] = None,
    rules_overrides: Optional[Dict[str, Tuple[str, ...]]] = None,
    multi_pod: bool = False,
    top: int = 8,
    verbose: bool = True,
) -> Tuple[RooflineTerms, ModuleCosts, float]:
    """One cell (a shape name of ``SHAPES`` or a ``ShapeConfig``): its
    terms, its costs and its bytes per device, as the reference counts
    them: arguments + outputs - aliased + temp. ``multi_pod`` (the
    reference's 2 x 16 x 16 mesh) is not ported yet: True raises."""
    if multi_pod:
        raise NotImplementedError(f"run_iteration(multi_pod=True): {MULTI_POD_TODO}")
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = get_shape(shape_name) if isinstance(shape_name, str) else shape_name
    mesh = DRYRUN_MESH
    lowered = build_step(cfg, shape, mesh, rules_overrides=rules_overrides).lower()
    costs = lowered.costs
    mem = memory_analysis_dict(lowered)
    per_dev = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
               - mem["alias_size_in_bytes"] + mem["temp_size_in_bytes"])
    terms = RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_name(mesh), chips=mesh.size,
        hlo_flops=costs.flops * mesh.size, hlo_bytes=costs.bytes * mesh.size,
        model_flops=model_flops_for_cell(cfg, shape),
    )
    if verbose:
        print(f"--- {arch} x {shape.name} overrides={overrides} rules={rules_overrides} ---")
        print(f"  HBM/dev: {per_dev / 1e9:.1f} GB (temp {mem['temp_size_in_bytes'] / 1e9:.3f} GB)"
              f"   {terms.render()}")
        print("  kernels: " + "; ".join(f"{k}: n={v.calls} flops={v.flops:.3e} bytes={v.bytes / 1e9:.2f}GB "
                                        f"bound={v.bound_s * 1e3:.3f}ms"
                                        for k, v in sorted(costs.kernels.items())))
        by_bytes = sorted(costs.bytes_by_op.items(), key=lambda kv: -kv[1])[:top]
        for name, nbytes in by_bytes:
            print(f"    {nbytes / 1e9:9.2f} GB  {name} (n={costs.census[name]})")
    return terms, costs, per_dev


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS, required=True)
    p.add_argument("--shape", choices=[s.name for s in SHAPES], required=True)
    p.add_argument("--set", action="append", default=[], help="cfg override k=v")
    args = p.parse_args()
    overrides = {}
    for kv in getattr(args, "set"):
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass
        overrides[k] = v
    run_iteration(args.arch, args.shape, overrides or None)


if __name__ == "__main__":
    main()
