"""Dry run of the port's cells on the host (the counterpart of
``repro.launch.dryrun``).

For every (architecture x input shape) cell: build the Cell on the meta
device, count its step (``roofline.analysis.count_step``: FLOPs by dtype,
the bytes every argument and output takes once, the eager ops' bytes) and
record the three roofline terms against one H100 (``roofline.hw.H100_SXM``)
in an incremental JSON cache (reruns skip completed cells).  It needs no
card: it runs on the CPU, and nothing is allocated.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --include-anns
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k

Accounting, cell by cell:

* LM cells: a two-point fit at L = 1 and 2 layers (outer + L x body), as
  the reference fits its scanned layers, so a meta run never walks 40
  layers of the Python flash-attention loop.  The meta count walks every
  attention tile and loss chunk, so the reference's ``analytic_extra``
  (what XLA's cost analysis missed in those scans) is recorded, not added.
* The LM decode runs with ``cur_len`` a host int (the cache's last slot).
* The ANNS cell cannot run on meta (its hop loop stops on ``done.all()``):
  its terms are the cell's analytic per-hop terms times
  ``body_multiplier`` (1.5 x efs hops).

``--mesh single`` (the default) is one H100: compute (each dtype's FLOPs at
its peak: bf16 at 989.4 TFLOP/s, fp32 with TF32 off at 66.9), memory
(``bytes_min`` at 3.35 TB/s), collective 0, ``dominant``,
``step_time_lb_s`` and ``mfu_upper_bound``.  ``--mesh multi`` (16 x 16
and 2 x 16 x 16; ``both`` adds one H100) records the per-device argument
bytes under ``launch/sharding.py``'s specs and leaves the per-device
compute and collective terms ``None``: the port has no partitioner to
say what each device would compute or send.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import sharding as SH
from repro_torch.models.api import build_cell, cell_arg_bytes, count_dtype
from repro_torch.roofline.analysis import count_step, roofline_terms
from repro_torch.roofline.hw import H100_SXM

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch.json")
MESH_CHOICES = {"single": ["single"], "multi": ["16x16", "2x16x16"],
                "both": ["single", "16x16", "2x16x16"]}
NO_PARTITIONER = ("no partitioner: the port runs on one card, so nothing "
                  "says what each device of a multi-device mesh computes or "
                  "sends")


def _fit(a, b, L):
    """The reference's two-point fit over counts at 1 and 2 layers."""
    body = max(b - a, 0.0)
    return max(a - body, 0.0) + L * body


def count_cell(cell) -> dict:
    """Counted terms of one cell (see the module docstring)."""
    if cell.body_terms is not None:
        m = cell.body_multiplier
        flops = cell.body_terms["flops"] * m
        return {"flops": flops, "flops_by_dtype": {"float32": flops},
                "bytes_min": cell.body_terms["bytes"] * m,
                "bytes_eager": None,
                "loop_correction": f"analytic per hop x{m:.0f}"}
    if cell.loop_fit is None:
        rec = count_step(cell.step_fn, *cell.arg_specs)
        rec["loop_correction"] = "none"
        return rec
    L, build = cell.loop_fit
    c1, c2 = (count_step(c.step_fn, *c.arg_specs) for c in (build(1),
                                                             build(2)))
    dts = set(c1["flops_by_dtype"]) | set(c2["flops_by_dtype"])
    return {
        "flops": _fit(c1["flops"], c2["flops"], L),
        "flops_by_dtype": {dt: _fit(c1["flops_by_dtype"].get(dt, 0.0),
                                    c2["flops_by_dtype"].get(dt, 0.0), L)
                           for dt in sorted(dts)},
        "bytes_min": _fit(c1["bytes_min"], c2["bytes_min"], L),
        "bytes_eager": _fit(c1["bytes_eager"], c2["bytes_eager"], L),
        "ops": c2["ops"],
        "loop_correction": f"2pt-fit L={L}"}


def per_device_arg_bytes(cell, mesh) -> float:
    """One device's argument bytes under the cell's in_shardings (each
    split dimension rounded up, as an uneven shard pads)."""
    return sum(SH.per_device_bytes(mesh, leaf, spec) for _, leaf, spec in
               SH.leaf_specs(cell.arg_specs, cell.in_shardings))


def run_cell(arch_id: str, shape_id: str, mesh_name: str = "single") -> dict:
    mesh = SH.mesh_shape(mesh_name)
    n_dev = SH.n_devices(mesh)
    spec = get_arch(arch_id)
    t0 = time.time()
    cell = build_cell(spec, shape_id, mesh)
    rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh_name,
           "n_devices": n_dev, "step": cell.step_name,
           "model_flops_total": cell.model_flops,
           "arg_bytes_total": cell_arg_bytes(cell),
           "reference_analytic_extra": cell.analytic_extra,
           "body_multiplier": cell.body_multiplier, "notes": cell.notes}
    if mesh_name != "single":
        rec.update({"mem_args_bytes_per_dev": per_device_arg_bytes(cell, mesh),
                    "compute_s": None, "collective_s": None,
                    "terms_absent": NO_PARTITIONER,
                    "count_s": round(time.time() - t0, 2), "status": "ok"})
        return rec
    rec.update(cell_terms(cell))
    rec.update({"count_s": round(time.time() - t0, 2), "status": "ok"})
    return rec


def cell_terms(cell) -> dict:
    """The counted terms and the one-H100 roofline of a built cell."""
    counted = count_cell(cell)
    dtype = count_dtype(cell)
    rec = roofline_terms(counted["flops"], counted["bytes_min"], 0.0,
                         hw=H100_SXM, model_flops_per_dev=cell.model_flops,
                         flops_by_dtype=counted["flops_by_dtype"],
                         dtype=dtype)
    rec.update({"hw": H100_SXM.name, "model_dtype": dtype,
                "flops_per_dev": counted["flops"],
                "flops_by_dtype": counted["flops_by_dtype"],
                "bytes_min_per_dev": counted["bytes_min"],
                "bytes_eager_per_dev": counted["bytes_eager"],
                "collective_wire_bytes": 0.0,
                "loop_correction": counted["loop_correction"]})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=list(MESH_CHOICES))
    ap.add_argument("--out", default=os.path.abspath(DEFAULT_OUT))
    ap.add_argument("--include-anns", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cache = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            cache = json.load(f)

    archs = [args.arch] if args.arch else list_archs(include_anns=args.include_anns)
    for arch_id in archs:
        spec = get_arch(arch_id)
        shapes = [args.shape] if args.shape else [s.shape_id for s in spec.shapes]
        for shape_id in shapes:
            for mesh_name in MESH_CHOICES[args.mesh]:
                key = f"{arch_id}|{shape_id}|{mesh_name}"
                if key in cache and cache[key].get("status") == "ok" and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[run ] {key} ...", flush=True)
                try:
                    rec = run_cell(arch_id, shape_id, mesh_name)
                    if mesh_name == "single":
                        print(f"   ok: flops={rec['flops_per_dev']:.3e} "
                              f"bytes={rec['bytes_min_per_dev']:.3e} "
                              f"dom={rec['dominant']} "
                              f"lb={rec['step_time_lb_s']:.3e}s "
                              f"({rec['count_s']}s)", flush=True)
                    else:
                        print(f"   ok: args/dev="
                              f"{rec['mem_args_bytes_per_dev'] / 1e9:.2f}GB",
                              flush=True)
                except Exception as e:   # noqa: BLE001 — sweep survey: record + continue
                    rec = {"arch": arch_id, "shape": shape_id,
                           "mesh": mesh_name, "status": "error",
                           "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"   ERROR: {e!r}", flush=True)
                cache[key] = rec
                with open(args.out, "w") as f:
                    json.dump(cache, f, indent=1)

    n_ok = sum(1 for v in cache.values() if v.get("status") == "ok")
    print(f"\n{n_ok}/{len(cache)} cells ok -> {args.out}")
    return 0 if n_ok == len(cache) else 1


if __name__ == "__main__":
    raise SystemExit(main())
