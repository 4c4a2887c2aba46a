"""Dry run on the ``meta`` device: size every (arch x shape x mesh) cell.

The port of ``repro/launch/dryrun.py``.  The JAX dry run lowers and
compiles each cell's sharded step on 512 forced host devices and reads
XLA's memory and cost analyses.  The port has no compiler to ask; for
each cell this:

  1. lays out the production mesh's ranks (16 x 16, ``launch.mesh``) on
     ``meta`` (no memory),
  2. builds the params, optimizer state and decode cache on ``meta``
     (``launch/specs.py``: not one byte is allocated, at any width),
  3. applies the sharding rules (``sharding/rules.py``) and sums each
     rank's block bytes -- parameters, AdamW moments, the reduced
     gradient's block, the decode cache -- exactly the bytes
     ``runtime.steps.shard_train_step`` places (every rank alike: the
     sharded dims divide evenly),
  4. adds what a step holds on the device that computes a data rank's
     rows: the port's steps compute from gathered blocks, so that device
     holds the whole parameters and, to train, the whole fp32 gradient,
     and the activations a step keeps (an estimate: under remat each
     layer's input of a micro-batch, and one CE chunk of fp32 logits;
     attention's score blocks are not counted),
  5. says whether the cell fits the card's 80 GB: ``fits_state`` (the
     ranks' blocks between steps) and ``fits`` (a step on the computing
     device),
  6. derives the three-term roofline (``launch/roofline.py``) from the
     model's FLOPs and the sharded shapes, and appends the cell to a JSON
     results file that ``launch/report.py`` renders.

The roofline is the port's design as built: one device a data rank
computes its rows (the model ranks hold blocks), so FLOPs a computing
chip are the model's (x 4/3 under full remat) over the data ranks.
Bytes a computing chip moves: to train, AdamW's read of parameters,
gradient and moments and write of parameters and moments over its
blocks, and the weights read in the compute dtype three times a
micro-batch (forward, recompute, backward); to prefill, the weights once;
to decode, the weights and the cache blocks once.  Collective bytes a
step: the all-gather of the parameters into the computing device (what it
receives), and to train the ring all-reduce of the fp32 gradient over the
data ranks (2 (D-1)/D of it) and the scatter of its slices to the other
ranks of the row ((M-1)/M of it, sent).

Usage:
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh 2,4 --out build/dry.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from ..configs.registry import ARCH_IDS, get_config
from ..launch import roofline as rl
from ..launch import specs
from ..launch.mesh import make_pod_mesh
from ..models.model import get_model
from ..sharding import rules

PRODUCTION = (16, 16)
CE_CHUNKS = 8                  # runtime.steps.make_loss_fn's loss_chunks


def runnable(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "long_500k skipped: pure full-attention arch (DESIGN.md §5)"
    return None


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def _n_blocks(cfg: ArchConfig) -> int:
    """Layers whose input a remat'd forward keeps."""
    return cfg.n_layers + (cfg.encoder_layers if cfg.family == "encdec"
                           else 0)


def plan_cell(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """One cell's per-rank bytes, fits and roofline on ``mesh`` (a
    ``PodMesh``; ``meta`` ranks allocate nothing)."""
    d_ranks, m_ranks = (mesh.shape[a] for a in mesh.axis_names)
    chips = d_ranks * m_ranks
    api = get_model(cfg)
    model = specs.params_shape(api)
    named = dict(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    items = {n: p.element_size() for n, p in named.items()}
    pspec = rules.param_specs(cfg, model, mesh)
    n_params = sum(math.prod(s) for s in shapes.values())
    n_rank = rules.spec_bytes(shapes, pspec, mesh, 1)
    param_bytes = rules.spec_bytes(shapes, pspec, mesh, items)
    whole_params = sum(math.prod(s) * items[n] for n, s in shapes.items())
    dt = _itemsize(getattr(torch, cfg.dtype))
    accum = max(1, cfg.grad_accum)
    bx = rules.batch_axis(mesh, shape.global_batch)
    rows = max(shape.global_batch // (d_ranks if bx else 1), 1)
    per = {"param_bytes": param_bytes, "moment_bytes": 0, "grad_bytes": 0,
           "cache_bytes": 0}
    colls = {"all-gather": float(whole_params - param_bytes)}
    if shape.kind == "train":
        mom = _itemsize(getattr(torch, cfg.opt_dtype))
        per["moment_bytes"] = 2 * n_rank * mom
        per["grad_bytes"] = 4 * n_rank
        rows_micro = max(rows // accum, 1)
        act = (rows_micro * shape.seq_len * cfg.d_model * dt * _n_blocks(cfg)
               + rows_micro * (shape.seq_len // CE_CHUNKS) * cfg.v_eff * 4)
        compute = whole_params + 4 * n_params
        nbytes = (2 * param_bytes + 4 * n_rank + 4 * n_rank * mom
                  + 3 * accum * n_rank * dt)
        colls["all-reduce"] = 2.0 * (d_ranks - 1) / d_ranks * 4 * n_params
        colls["scatter"] = (m_ranks - 1) / m_ranks * 4 * n_params
        recompute = 4.0 / 3.0 if cfg.remat != "none" else 1.0
    else:
        act = 2 * rows * (shape.seq_len if shape.kind == "prefill" else 1) \
            * cfg.d_model * dt
        compute = whole_params
        nbytes = n_rank * dt
        recompute = 1.0
        if shape.kind == "decode":
            cache = specs.cache_shape(api, cfg, shape)
            cspec = rules.cache_specs(cfg, cache, mesh, shape.global_batch)
            per["cache_bytes"] = _tree_rank_bytes(cache, cspec, mesh)
            nbytes += per["cache_bytes"]
    state = sum(per.values())
    step = state + compute + act
    mem = dict(per, activation_bytes=float(act), compute_bytes=float(compute),
               state_bytes=float(state), peak_bytes=float(step))
    r = rl.analyze(chips=chips, kind=shape.kind,
                   n_active_params=cfg.active_param_count(),
                   global_batch=shape.global_batch, seq_len=shape.seq_len,
                   bytes_per_chip=nbytes, collectives=colls,
                   memory_stats=mem, recompute=recompute,
                   computing_chips=d_ranks if bx else 1)
    return {"status": "ok", "mesh_shape": [d_ranks, m_ranks],
            "per_rank": per, "fits_state": state <= rl.HBM_BYTES,
            "fits": step <= rl.HBM_BYTES, "roofline": r.to_dict()}


def _tree_rank_bytes(tree, spec_tree, mesh) -> int:
    if isinstance(tree, dict):
        return sum(_tree_rank_bytes(tree[k], spec_tree[k], mesh)
                   for k in tree)
    return (math.prod(rules.block_shape(tuple(tree.shape), spec_tree, mesh))
            * tree.element_size())


def lower_cell(arch_id: str, shape_name: str, mesh_shape=PRODUCTION) -> dict:
    """The cell (arch x shape) on a ``mesh_shape`` mesh of ``meta``
    ranks: ``runnable``'s skip, or :func:`plan_cell`'s numbers."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    skip = runnable(cfg, shape)
    if skip:
        return {"status": "skipped", "reason": skip}
    t0 = time.perf_counter()
    res = plan_cell(cfg, shape, make_pod_mesh(mesh_shape, "meta"))
    res["plan_s"] = time.perf_counter() - t0
    return res


def _mesh_key(mesh_shape) -> str:
    return ("single" if tuple(mesh_shape) == PRODUCTION
            else "x".join(str(v) for v in mesh_shape))


def run(archs=ARCH_IDS, shapes=tuple(SHAPES), mesh_shape=PRODUCTION,
        results: Optional[dict] = None, force: bool = False,
        log=print) -> dict:
    """Plan every (arch x shape) cell on one mesh into ``results`` (a
    cell already ``ok`` or ``skipped`` there is kept unless ``force``)."""
    results = {} if results is None else results
    for arch_id in archs:
        for shape_name in shapes:
            key = f"{_mesh_key(mesh_shape)}/{arch_id}/{shape_name}"
            if key in results and results[key].get("status") in (
                    "ok", "skipped") and not force:
                continue
            try:
                res = lower_cell(arch_id, shape_name, mesh_shape)
            except Exception as e:  # a failure here is a bug: record it
                res = {"status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            results[key] = res
            if res["status"] == "ok":
                r = res["roofline"]
                log(f"[dryrun] {key}: ok bottleneck={r['bottleneck']} "
                    f"t=({r['t_compute']:.4f},{r['t_memory']:.4f},"
                    f"{r['t_collective']:.4f})s fits={res['fits']}")
            else:
                log(f"[dryrun] {key}: {res['status']} "
                    f"({res.get('reason', res.get('error', ''))})")
    return results


def main(argv=None) -> int:
    from . import report
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="single",
                    help="single (the production 16 x 16) or D,M")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "dryrun_torch.json"))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    mesh_shape = (PRODUCTION if args.mesh == "single"
                  else tuple(int(v) for v in args.mesh.split(",")))
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    archs = ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    run(archs, shapes, mesh_shape, results, args.force)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    for line in report.table(results, _mesh_key(mesh_shape)):
        print(line)
    n = {s: sum(1 for v in results.values() if v["status"] == s)
         for s in ("ok", "skipped", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors -> {args.out}")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
