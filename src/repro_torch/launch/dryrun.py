"""The dry run: every (architecture x input shape) cell of the production
meshes counted for one rank on the meta device — parameters, optimizer
state, cache, the activation peak, operations, bytes and collectives — and
its roofline terms on an H100 (``repro.launch.dryrun``'s counterpart).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod1

It needs no card and never initialises CUDA: the step runs on meta tensors
under ``launch.cost.CostCounter`` (the reference lowers and compiles for
512 placeholder devices instead).  Train cells recompute each unit in the
backward (``remat="full"``), as the reference's dry run trains.  Records
land in ``build/dryrun/<mesh>/<arch>__<shape>.json`` (``--out``); the
reference's ``--flag`` has no counterpart, since the port has no flags.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from pathlib import Path

from repro_torch.configs import ASSIGNED, SHAPES, cell_applicable, get_config
from repro_torch.launch.cost import count
from repro_torch.launch.mesh import production_mesh
from repro_torch.launch.roofline import fits, model_flops_per_chip, roofline_terms
from repro_torch.launch.specs import cell_specs, dryrun_config
from repro_torch.obs.clock import monotonic

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def differences(cfg, shape, mesh: dict) -> list[str]:
    """The accepted differences from the reference that move this cell's
    record (``launch/specs.py``): "data_replicas", the data ranks hold
    whole replicas of the model's shard (the reference shards the weights
    over "data" too); "per_rank_kv", a rank caches its query heads' KV
    heads and MLA's whole latent (the reference shards the cache's
    sequence over "model")."""
    out = []
    if any(mesh.get(a, 1) > 1 for a in ("pod", "data")):
        out.append("data_replicas")
    if shape.kind != "train" and mesh.get("model", 1) > 1 and cfg.n_heads:
        out.append("per_rank_kv")
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """Count one cell on one rank; returns the record (raises on failure)."""
    mesh = production_mesh(multi_pod)
    mesh_name = "pod2" if multi_pod else "pod1"
    n_chips = math.prod(mesh.values())
    shape = SHAPES[shape_name]
    cfg_pub = get_config(arch)
    ok, why = cell_applicable(cfg_pub, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": why}

    t0 = monotonic()
    step, args, meta = cell_specs(arch, shape_name, mesh)
    cost, _ = count(step, *args)
    trace_s = monotonic() - t0
    cfg = dryrun_config(arch, mesh)
    rf = roofline_terms(cost, model_flops_per_chip(cfg, shape, n_chips))
    peak = cost.peak_bytes
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_chips": n_chips,
        "rank": meta["rank"],
        "rank_batch": meta["rank_batch"],
        "local_cfg": meta["local_cfg"],
        "remat": "full" if shape.kind == "train" else "none",
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": cost.argument_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": cost.temp_bytes,
            "peak_bytes_per_device": peak,
        },
        "fits": fits(peak),
        "collectives": {
            "bytes_by_kind": {k: v["bytes"] for k, v in cost.collectives.items()},
            "count_by_kind": {k: v["count"] for k, v in cost.collectives.items()},
            "by_phase": cost.collectives_by_phase,
            "by_axis": cost.collective_axes,
        },
        "work": cost.work(),
        "roofline": rf.as_dict(),
        "differences": differences(cfg_pub, shape, mesh),
    }


def save(rec: dict, out_dir: str) -> str:
    d = os.path.join(out_dir, rec["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def summarize(rec: dict) -> str:
    if rec["status"] == "skipped":
        return f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']}: SKIP ({rec['reason'][:60]})"
    r = rec["roofline"]
    gib = rec["memory"]["peak_bytes_per_device"] / 2**30
    return (
        f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']}: ok "
        f"trace={rec['trace_s']:.0f}s mem/dev={gib:.2f}GiB fits={rec['fits']} "
        f"t_comp={r['t_compute_s']:.2e} t_mem={r['t_memory_s']:.2e} "
        f"t_coll={r['t_collective_s']:.2e} -> {r['bottleneck']}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ASSIGNED + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--all", action="store_true", help="every arch x shape x mesh")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch == "all") else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape == "all") else [args.shape]
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]

    failures = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                mesh_name = "pod2" if multi_pod else "pod1"
                path = os.path.join(args.out, mesh_name, f"{arch}__{shape}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"{arch:22s} {shape:12s} {mesh_name}: cached")
                    continue
                try:
                    rec = run_cell(arch, shape, multi_pod)
                except Exception as e:  # noqa: BLE001 — report, continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "fail", "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures.append((arch, shape, mesh_name))
                save(rec, args.out)
                print(summarize(rec) if rec["status"] != "fail"
                      else f"{arch:22s} {shape:12s} {mesh_name}: FAIL {rec['error'][:100]}",
                      flush=True)

    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        return 1
    print("\nall cells ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
