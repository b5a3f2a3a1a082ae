"""Multi-pod dry-run: trace every (arch x shape) cell once on a faked
256- or 512-rank mesh and record its memory, cost, collectives and H100
roofline terms; port of ``repro.launch.dryrun``.

The reference AOT-compiles each cell with XLA on 512 host devices.  The
port traces the same step eagerly instead:

  * a fake process group of 256 (``(16, 16)`` ``("data", "model")``) or
    512 ranks (``(2, 16, 16)`` with ``"pod"``) at rank 0
    (``torch.distributed``'s ``"fake"`` backend: collectives return at
    once), and ``launch.mesh.make_production_mesh(device_type="cpu")``;
  * rank 0's local pieces (``launch.specs.build_cell``) as fake tensors
    under ``FakeTensorMode``: nothing is allocated;
  * the step run once under ``launch.costing``'s counting mode: GEMM
    FLOPs, eager bytes, every collective with its group, live memory.
    The port's layers are Python loops, so this direct count is exact in
    trip counts and the reference's probes are not run.

The roofline prices the FLOPs at the cell's parameter type: every cell,
train and serving, holds bf16 parameters as the reference's do, priced
at the card's bf16 tensor-core peak
(``roofline.model.peak_flops(torch.bfloat16)``, 989 TFLOP/s).  A
record's ``layout`` says how the cell runs on the mesh; the serving
cells' is a dry-run layout that gathers the weights and (decode) the
cache, not a path the port runs.

The trace runs on the fake CPU device, so ``kernels/dispatch.py`` takes
each kernel's plain version, as the reference's dry-run compiles its
XLA path on host devices; no kernel is handed a pointer.  The dry-run
allocates and launches nothing, so there is no card to place it on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k [--multi-pod] [--opt flash] [--out build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, cells, get_config, shape_runnable
from repro_torch.launch import costing
from repro_torch.launch import specs as sp
from repro_torch.roofline import model as rm

COST_SOURCE = ("direct eager count (trip-count exact): GEMM FLOPs only "
               "(torch.utils.flop_counter; elementwise FLOPs left out), "
               "bytes = distinct storages each non-view op reads and "
               "writes; FLOPs priced at the cell's dtype")


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks at rank 0 for the duration
    (refused when a process group is already initialised)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group: "
                           "destroy the current one first")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cell_mesh(multi_pod: bool, opt_level: str = "base"):
    """The cell's mesh over the initialised (fake) world."""
    from repro_torch.launch import mesh as mesh_lib
    if "tp8" in opt_level.split("+"):
        # sharding variant: TP degree 8, one node's NVLink domain (divides
        # every head count; phi4's 24 heads do not split over 16)
        shape_ = (2, 32, 8) if multi_pod else (32, 8)
        axes_ = ("pod", "data", "model") if multi_pod else ("data", "model")
        return mesh_lib.make_mesh(shape_, axes_, device_type="cpu")
    return mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_level: str = "base") -> dict:
    cfg = get_config(arch)
    ok, reason = shape_runnable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "pod2" if multi_pod else "pod1",
           "opt": opt_level}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    with fake_world(512 if multi_pod else 256):
        return _run(rec, cfg, arch, shape_name, multi_pod, opt_level)


def _run(rec, cfg, arch, shape_name, multi_pod, opt_level):
    from repro_torch.distributed import sharding as shd
    mesh = cell_mesh(multi_pod, opt_level)
    n_chips = mesh.size()
    shape = SHAPES[shape_name]
    opts = opt_level.split("+")
    t0 = time.time()
    cell = sp.build_cell(arch, shape_name, mesh, opt=opt_level)
    cost, mem = costing.cell_cost(cell)
    t_trace = time.time() - t0

    flops_dev, bytes_dev, coll_dev = cost.flops, cost.bytes, cost.coll
    intra_dev = cost.intra
    cost_src = COST_SOURCE
    if shape.kind != "train":
        cost_src += "; collectives of the dry-run's serving layout"
    accum = sp.accum_for_cell(arch, shape_name, mesh, opt_level)
    elem = cell.dtype.itemsize

    if "flash" in opts:
        mixed_lb = t_mix = 0
        if "mixed" in opts and shape.kind == "prefill" and \
                cfg.mixed_res is not None:
            from repro_torch.core import seq_mixed_res as smr
            n_img = cfg.vlm.n_image_tokens if cfg.family == "vlm" else 0
            part1d = smr.seq_partition(cfg, shape.seq_len + n_img)
            t_mix = part1d.n_tokens(part1d.n_spans // 2)
            mixed_lb = smr.layers_before_rp(cfg, 2, cfg.n_layers)
        corr = costing.flash_correction(
            cfg, shape, mesh, accum, costing.attn_layer_count(cfg),
            dtype_bytes=elem, mixed_lb=mixed_lb, t_mix=t_mix)
        rec["flash_correction"] = corr
        # floor: traffic never goes below reading the params once per
        # pass + one activation write per layer + the kernel's own
        # attention IO
        floor = costing.min_traffic_floor(cfg, shape, mesh, accum,
                                          mixed_lb=mixed_lb, t_mix=t_mix,
                                          dtype_bytes=elem)
        rec["byte_floor"] = floor
        bytes_dev = max(bytes_dev - corr["bytes_saved_per_device"],
                        floor["bytes_per_device"])
        cost_src += " + flash-kernel byte substitution (floored)"

    if "zero2" in opts and accum > 1:
        # gather params once per step instead of per microbatch (ZeRO-2
        # layout); feasible only if the gathered params fit next to the
        # per-device peak
        ag = (cost.coll_by_op or {}).get("all-gather", 0.0)
        tp = shd.mesh_shape(mesh)["model"]
        gathered_bytes = cfg.param_count() * elem / tp
        peak = mem.argument_bytes + mem.temp_bytes + gathered_bytes
        feasible = peak < rm.HBM_BYTES
        saved = ag * (accum - 1) / accum if feasible else 0.0
        rec["zero2"] = {
            "allgather_bytes": ag, "saved_bytes": saved,
            "gathered_param_bytes": gathered_bytes,
            "projected_peak_bytes": peak, "feasible": feasible,
        }
        # the saving is taken from the inter-node share first
        coll_dev = max(coll_dev - saved, 0.0)
        intra_dev = min(intra_dev, coll_dev)
        cost_src += (" + zero2 gather-once" if feasible else
                     " (zero2 INFEASIBLE: params don't fit gathered)")

    terms = rm.roofline_terms(
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll_dev, n_chips=n_chips,
        intra_node_bytes_per_device=intra_dev, compute_dtype=cell.dtype)
    model_fl = rm.model_flops(cfg, shape)
    rec.update(
        status="ok",
        n_chips=int(n_chips),
        trace_s=round(t_trace, 2),
        layout=cell.layout,
        compute_dtype=str(cell.dtype).replace("torch.", ""),
        memory=dict(
            argument_bytes=int(mem.argument_bytes),
            argument_bytes_by_arg=[int(b) for b in mem.by_arg],
            output_bytes=int(mem.output_bytes),
            temp_bytes=int(mem.temp_bytes),
            alias_bytes=int(mem.alias_bytes),
            total_per_device=int(mem.argument_bytes + mem.output_bytes
                                 + mem.temp_bytes - mem.alias_bytes),
            # outputs that alias the donated arguments (AdamW's in-place
            # parameters and moments) counted once
            total_with_donation=int(mem.argument_bytes + mem.temp_bytes),
        ),
        cost=dict(flops_per_device=flops_dev,
                  bytes_per_device=bytes_dev,
                  source=cost_src,
                  direct_flops=cost.flops,
                  direct_bytes=cost.bytes,
                  kernel_regions=cost.regions),
        collectives={"bytes_per_device": coll_dev,
                     "by_op_bytes": cost.coll_by_op,
                     "op_counts": cost.op_counts,
                     "intra_node_bytes": intra_dev,
                     "direct_bytes_per_device": cost.coll},
        roofline=terms,
        model_flops=model_fl,
        useful_flop_ratio=(model_fl / (terms["total_flops"] + 1e-30)
                           if terms["total_flops"] else None),
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", default="base",
                    help="optimization variant label, tokens joined by '+'")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    todo = cells() if args.all else [(args.arch, args.shape)]

    n_fail = 0
    t_all = time.time()
    for arch, shape in todo:
        tag = f"{arch}__{shape}__{'pod2' if args.multi_pod else 'pod1'}"
        if args.opt != "base":
            tag += f"__{args.opt}"
        path = out / f"{tag}.json"
        t0 = time.time()
        try:
            rec = run_cell(arch, shape, args.multi_pod, args.opt)
        except Exception as e:          # a failure here is a bug in the port
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "mesh": "pod2" if args.multi_pod else "pod1",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            n_fail += 1
        path.write_text(json.dumps(rec, indent=2))
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" trace={rec['trace_s']:.1f}s"
                     f" mem/dev={rec['memory']['total_with_donation']/2**30:.2f}GiB"
                     f" t_comp={r['t_compute']*1e3:.2f}ms"
                     f" t_mem={r['t_memory']*1e3:.2f}ms"
                     f" t_coll={r['t_collective']*1e3:.2f}ms"
                     f" bound={r['bound']}")
        elif status == "skipped":
            extra = f" ({rec['reason'][:60]})"
        else:
            extra = f" ({rec['error'][:200]})"
        print(f"[dryrun] {tag}: {status}{extra} "
              f"[{time.time() - t0:.1f} s]", flush=True)
    print(f"[dryrun] {len(todo)} cells, {n_fail} errors, "
          f"{time.time() - t_all:.1f} s", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
