"""Render the roofline table from dry-run JSONL records; counterpart of
``repro.launch.roofline_table``.

    PYTHONPATH=src python -m repro_torch.launch.roofline_table dryrun.jsonl
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List

from repro_torch.distributed.roofline import RooflineTerms

MESH = "1x1"  # the one mesh the port's dry run describes: one H100


def load(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def to_terms(r: Dict) -> RooflineTerms:
    return RooflineTerms(
        arch=r["arch"],
        shape=r["shape"],
        mesh=r["mesh"],
        chips=r["chips"],
        hlo_flops=r["hlo_flops"],
        hlo_bytes=r["hlo_bytes"],
        model_flops=r["model_flops"],
    )


def render_table(recs: List[Dict], mesh_filter: str = MESH, fits: bool = False) -> str:
    """The reference's table; with ``fits``, a last column says whether the
    cell fits the card's memory."""
    cols = 9 + fits
    header = (
        "| arch | shape | C (s) | M (s) | X (s) | dominant | HBM GB/dev | "
        "useful | RF |" + (" fits |" if fits else "")
    )
    rows = [header, "|" + "---|" * cols]
    seen = set()
    for r in recs:
        if r["status"] == "skipped":
            key = (r["arch"], r["shape"])
            if key not in seen:
                seen.add(key)
                rows.append(
                    f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | — |"
                    + (" — |" if fits else "")
                )
            continue
        if r["status"] != "ok" or not r["mesh"].startswith(mesh_filter):
            continue
        t = to_terms(r)
        gb = r.get("per_device_bytes", 0) / 1e9
        rows.append(
            f"| {t.arch} | {t.shape} | {t.compute_s:.4f} | {t.memory_s:.4f} | "
            f"{t.collective_s:.4f} | {t.dominant} | {gb:.1f} | "
            f"{t.useful_flops_fraction:.3f} | {t.roofline_fraction:.3f} |"
            + (f" {'yes' if r['fits'] else 'no'} |" if fits else "")
        )
    return "\n".join(rows)


def pick_hillclimb(recs: List[Dict], mesh_filter: str = MESH) -> None:
    """The train cell furthest from its roofline. (The reference also names
    the most collective-bound cell: on one device none moves collective
    bytes.)"""
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"].startswith(mesh_filter)
          and r["shape"].startswith("train")]
    terms = [(to_terms(r), r) for r in ok]
    worst_rf = min(terms, key=lambda t: t[0].roofline_fraction)
    print("\nworst roofline fraction:", worst_rf[0].arch, worst_rf[0].shape,
          f"RF={worst_rf[0].roofline_fraction:.4f}")


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit("usage: python -m repro_torch.launch.roofline_table DRYRUN.jsonl")
    recs = load(sys.argv[1])
    print(render_table(recs, fits=True))
    pick_hillclimb(recs)


if __name__ == "__main__":
    main()
