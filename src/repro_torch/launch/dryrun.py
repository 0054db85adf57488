"""The dry run (twin of ``repro/launch/dryrun.py``): every (architecture x
input shape) cell of the registry (``configs/base.py``) on the production
meshes, rank 0's view of a 16 x 16 mesh and of two pods of 16 x 16
(``launch.mesh.make_production_mesh``, shape-only: no process group).

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything, on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch egnn     # one arch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fm --shape train_batch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod only|skip|both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fm --multi-pod skip \\
        --device cpu --batch 512                                       # on the CPU, a cut batch

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``, one
file a cell, so a run that is cut resumes where it stopped (a cell recorded
``ok``, ``skipped`` or ``structs_only`` is not run again).

The reference lowers and compiles each cell and reads XLA's memory and cost
analysis and the collectives of its HLO.  PyTorch has no twin of those, so
a cell's record holds what the port can count:

* ``memory.argument_bytes``: rank 0's share of the step's arguments, each
  leaf at its per-rank shape (``dist.sharding.shard_shape``: the state's
  structs, the batch by the reference's batch specs; the LM parameters by
  ``dist.sharding.lm_param_specs``, the decode cache by
  ``models.lm_steps.cache_specs``); what XLA's ``argument_size_in_bytes``
  counts, to the byte;
* for every DLRM, recsys and EGNN cell, one step of rank 0 on ``device``
  with a state of the structs' shapes (rows drawn from a seed) and a
  seeded batch: ``memory.output_bytes`` (the step's outputs),
  ``memory.built_bytes`` (the built state and batch, which must equal the
  argument bytes), ``memory.peak_bytes`` on the card
  (``torch.cuda.max_memory_allocated``), the collectives the step ran over
  the shape-only groups (``calls`` and ``bytes_out`` by kind and
  ``total_bytes``, the reference's ``parse_collective_bytes`` names),
  ``cost.product_flops`` (``torch.utils.flop_counter.FlopCounterMode``: the
  matrix products PyTorch runs, not the hand-written kernels' work, and not
  comparable with XLA's flops) and the step's wall ``step_ms``.  The step
  runs the port's kernels on the card as the main path does, their plain
  versions on the CPU;
* for every single-pod LM cell, the same numbers from one step of rank 0
  cut to the config's first dense layers plus one scan unit (gemma2's
  local/global pair; ``meta.stepped_layers``), at full width and with the
  cell's own B and L: the rank's blocks of the state (or parameters and
  cache) drawn from a seed at their per-rank shapes; ``argument_bytes``
  stays the full depth's, and ``memory.stepped_argument_bytes`` (the cut
  depth's, from the structs) must equal the built bytes;
* ``status``: ``ok``; ``skipped`` (the reference's reasons, word for word);
  ``structs_only`` (the two-pod LM cells, as the reference's two-pod LM
  cells are argument bytes alone, or a cell whose step the caller did not
  ask for); or ``error``.

Over a shape-only group a collective returns what it would if every other
rank held zeros (``dist.comm``): other shards' index exchanges come back as
zeros, so those lookups hit row 0, the reference's clip row for other
shards' lookups.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_production_mesh, make_shape_mesh, shape_only_meshes

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

MESHES = {"pod1x16x16": dict(multi_pod=False), "pod2x16x16": dict(multi_pod=True)}

LM_REASON = ("structs only: a two-pod LM cell's per-rank argument bytes are counted from the "
             "structs and specs; its step is not run")

SEED = 0


def _is_struct(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
            and isinstance(x[1], torch.dtype))


def _leaves(tree, specs):
    """``(struct, spec)`` pairs of a struct tree and its spec tree (None:
    every leaf whole); absent leaves (None) are skipped."""
    if tree is None:
        return
    if _is_struct(tree):
        yield tree, (() if specs is None else specs)
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, None if specs is None else specs[k])
        return
    for i, v in enumerate(tree):
        yield from _leaves(v, None if specs is None else specs[i])


def rank_bytes(structs, specs, mesh) -> int:
    """Rank 0's bytes of a tree of ``(shape, dtype)`` structs held by
    ``specs`` (a like tree of spec tuples, or None: whole) on ``mesh``."""
    return sum(shd.shard_bytes(s, dt, spec, mesh.shape) for (s, dt), spec in _leaves(structs, specs))


def tensor_bytes(tree) -> int:
    """The bytes of every tensor of a tree (dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def lm_argument_bytes(plan, mesh) -> int:
    """Rank 0's argument bytes of an LM cell (the reference's in_shardings):
    the parameters (train: ``hi``, ``lo`` and ``mom``) by
    ``lm_param_specs``; the train batch over the config's data axes, the
    prefill tokens over the mesh's; the decode cache by
    ``lm_steps.cache_specs``, its tokens and positions over the data axes
    where the batch covers them."""
    from repro_torch.models import lm_steps

    cfg, B, L = plan.cfg, plan.B, plan.L
    ps = shd.lm_config_specs(cfg)
    if plan.kind == "train":
        structs = lm_steps.lm_state_structs(cfg, plan.momentum)
        tokens = {"tokens": ((B, L), torch.int32), "labels": ((B, L), torch.int32)}
        return (rank_bytes(structs, {k: ps for k in structs}, mesh)
                + rank_bytes(tokens, dict.fromkeys(tokens, (cfg.dp_axes, None)), mesh))
    params = rank_bytes(lm_steps.param_structs(cfg), ps, mesh)
    bdp = shd.batch_axes(mesh)
    if plan.kind == "prefill":
        return params + rank_bytes(((B, L), torch.int32), (bdp, None), mesh)
    batch_ok = B % math.prod(mesh.shape[a] for a in bdp) == 0
    tok = ((B,), torch.int32)
    return (params + rank_bytes(lm_steps.cache_structs(cfg, B, L), lm_steps.cache_specs(cfg, mesh, B),
                                mesh)
            + 2 * rank_bytes(tok, (bdp,) if batch_ok else (), mesh))


# ---------------------------------------------------------------------------
# Rank 0's inputs
# ---------------------------------------------------------------------------

def hybrid_batch(mdef, mesh, B: int, gen: torch.Generator) -> dict:
    """A global batch of the hybrid model ``mdef`` on the mesh's device: ids
    uniform over each slot's table (table mode with the replicated stream in
    padded-slot order, as the reference's loader gives it), ``dense_x``
    normal, ``labels`` coin flips, masks all ones."""
    from repro_torch.core import hybrid
    from repro_torch.core import sharded_embedding as se

    mdef = hybrid.as_hybrid(mdef)
    dev = mesh.device
    layout = hybrid.make_layout(mdef, mesh)
    tables = layout.slot_to_table
    cols = [torch.randint(0, int(mdef.spec.table_rows[t]), (B, mdef.pooling), generator=gen,
                          device=dev, dtype=torch.int32) for t in tables]
    batch = {"idx": torch.stack(cols, dim=1)}
    if mdef.emb_mode == "table" and mdef.idx_input == "replicated":
        batch["idx"] = se.permute_indices(layout, batch["idx"])
    for name, (shape, dtype) in mdef.extras.items():
        if name == "labels":
            v = torch.randint(0, 2, (B, *shape), generator=gen, device=dev).to(dtype)
        elif name.endswith("mask"):
            v = torch.ones((B, *shape), dtype=dtype, device=dev)
        else:
            v = torch.randn((B, *shape), generator=gen, device=dev).to(dtype)
        batch[name] = v
    return batch


def egnn_batch(structs: dict, n_nodes: int, n_edges: int, n_graphs: int,
               gen: torch.Generator, dev) -> dict:
    """A global EGNN batch of ``structs``' shapes: the first ``n_edges``
    edges of the graph (of each subgraph of a minibatch) real, between
    uniform nodes of its first ``n_nodes``, the padding masked; labels
    uniform over two classes, every real node labelled; ``n_graphs``
    graphs of ``n_nodes / n_graphs`` nodes each, in order."""
    out = {}
    for k, (shape, dtype) in structs.items():
        if k in ("src", "dst"):
            out[k] = torch.randint(0, n_nodes, shape, generator=gen, device=dev, dtype=dtype)
        elif k == "edge_mask":
            out[k] = (torch.arange(shape[-1], device=dev) < n_edges).to(dtype).expand(
                shape).contiguous()
        elif k == "label_mask":
            out[k] = (torch.arange(shape[0], device=dev) < n_nodes).to(dtype)
        elif k == "labels":
            out[k] = torch.randint(0, 2, shape, generator=gen, device=dev, dtype=dtype)
        elif k == "graph_ids":
            out[k] = (torch.arange(shape[0], device=dev, dtype=dtype)
                      // (n_nodes // n_graphs)).clamp_(max=n_graphs - 1)
        else:
            out[k] = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return out


def cell_inputs(build, mesh, gen: torch.Generator) -> tuple[tuple, int]:
    """Rank 0's arguments of a built DLRM, recsys or EGNN cell on the
    mesh's device, and their bytes counted as ``argument_bytes`` counts
    them: the hybrid models' state (this shard's rows,
    ``hybrid.init_state(shard_only=True)``) and their batch cut to this
    rank (``hybrid.local_batch``; a retrieval cell's query and this rank's
    candidate block); EGNN's replicated state and global batch (its step
    cuts the batch), counted by its specs."""
    from repro_torch.core import hybrid
    from repro_torch.models import egnn_steps

    meta, model, dev = build.meta, build.model, mesh.device
    if meta["family"] == "gnn":
        state = egnn_steps.init_egnn_state(model, gen, dev)
        bstructs = build.args[1]
        if meta["shape"] == "minibatch_lg":   # a subgraph's nodes and edges, all real
            (_, n_pad, _), _ = bstructs["feats"]
            (_, e_pad), _ = bstructs["src"]
            batch = egnn_batch(bstructs, n_pad, e_pad, 1, gen, dev)
        else:
            batch = egnn_batch(bstructs, meta["n_nodes"], meta["n_edges"], meta["batch"], gen,
                               dev)
        built = (tensor_bytes(state)
                 + sum(shd.shard_bytes(tuple(v.shape), v.dtype, build.specs[1][k], mesh.shape)
                       for k, v in batch.items()))
        return (state, batch), built
    state = hybrid.init_state(model, gen, dev, mesh, shard_only=True)
    if meta["kind"] == "retrieval":
        query = hybrid_batch(model, mesh, 1, gen)
        per = meta["n_candidates"] // mesh.size
        cand = (torch.rand((per, model.spec.dim), generator=gen, device=dev) - 0.5).to(
            torch.bfloat16)
        args = (state, query, cand)
    else:
        batch = hybrid_batch(model, mesh, meta["batch"], gen)
        args = (state, hybrid.local_batch(model, mesh, batch))
    return args, tensor_bytes(args)


def lm_inputs(build, mesh, gen: torch.Generator) -> tuple:
    """Rank 0's arguments of a built LM cell on the mesh's device, each
    leaf at its per-rank shape under its spec: bf16 values (weights, the
    cache) N(0, 0.02²), ``lo`` random bits, ``mom`` zeros, tokens uniform
    over the vocabulary, the decode positions the cache's last slot."""
    cfg, dev = build.model, mesh.device

    def draw(struct, spec, name):
        shape, dtype = struct
        shape = shd.shard_shape(shape, spec or (), mesh.shape)
        if dtype == torch.bfloat16:
            return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
        if dtype == torch.int16:
            return torch.randint(-2 ** 15, 2 ** 15, shape, generator=gen, device=dev,
                                 dtype=torch.int16)
        if dtype == torch.float32:
            return torch.zeros(shape, device=dev)
        if name == "pos":
            return torch.full(shape, build.meta["seq"] - 1, dtype=dtype, device=dev)
        return torch.randint(0, cfg.vocab, shape, generator=gen, device=dev, dtype=dtype)

    def walk(tree, specs, name):
        if _is_struct(tree):
            return draw(tree, specs, name)
        return {k: walk(v, specs[k], k) for k, v in tree.items()}

    names = {"train": ("state", "batch"), "prefill": ("params", "tokens"),
             "decode": ("params", "cache", "tokens", "pos")}[build.meta["kind"]]
    return tuple(walk(a, sp, n) for a, sp, n in zip(build.args, build.specs, names))


def collectives(stats) -> dict:
    """A ``CollectiveStats``' calls and result bytes by kind (the kinds that
    ran) and their total, the reference's ``parse_collective_bytes``
    names."""
    by = {k: v for k, v in stats.bytes_out.items() if stats.calls[k]}
    return {"calls": {k: v for k, v in stats.calls.items() if v}, "bytes_out": by,
            "total_bytes": sum(by.values())}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for v in tree for t in _tensors(v)] if isinstance(tree, (list, tuple)) else []


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_step(build, mesh, gen: torch.Generator, timed: int = 1) -> tuple[dict, tuple]:
    """One step of rank 0 of a built cell on the mesh's device, counted
    (collectives, products, outputs, the card's peak), then ``timed`` more,
    timed.  Returns the record's numbers and the first step's outputs."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = mesh.device
    if build.meta["family"] == "lm":
        args = lm_inputs(build, mesh, gen)
        built = tensor_bytes(args)
    else:
        args, built = cell_inputs(build, mesh, gen)
    _sync(dev)
    mesh.stats.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    with counter:
        out = build.fn(*args)
    _sync(dev)
    rec = {"memory": {"built_bytes": built, "output_bytes": tensor_bytes(out)},
           "collectives": collectives(mesh.stats),
           "cost": {"product_flops": int(counter.get_total_flops())}}
    if dev.type == "cuda":
        rec["memory"]["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    values = out[1] if build.meta["kind"] == "train" else out
    finite = all(bool(torch.isfinite(v.float()).all()) for v in _tensors(values))
    if not finite:
        raise FloatingPointError(f"{build.meta['arch']} {build.meta['shape']}: the step's "
                                 "outputs are not finite")
    t0 = time.perf_counter()
    for _ in range(timed):
        build.fn(*args)
    _sync(dev)
    rec["step_ms"] = (time.perf_counter() - t0) * 1e3 / timed if timed else None
    return rec, out


def run_cell(arch: str, shape: str, mesh, mesh_name: str, overrides=None, device="cuda",
             step: bool = True, timed: int = 1) -> dict:
    """The record of one cell at rank ``mesh.rank`` of ``mesh``'s shape (a
    fresh shape-only mesh on ``device``; the module docstring says what the
    record holds).  ``step``: run the rank's step of a DLRM, recsys or EGNN
    cell (else the cell is ``structs_only``), then ``timed`` more, timed."""
    mesh = make_shape_mesh(tuple(mesh.shape.values()), mesh.axis_names, mesh.rank, device)
    ad = cfgbase.get(arch)
    cell = next(c for c in ad.cells if c.shape == shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "kind": cell.kind, "status": None,
           "device": str(mesh.device)}
    if cell.skip:
        rec.update(status="skipped", skip_reason=cell.skip)
        return rec
    t0 = time.perf_counter()
    held = "argument_bytes"
    if ad.plan is not None:
        plan = ad.plan(shape, mesh, **(overrides or {}))
        rec["meta"] = _plain_meta(plan.meta)
        rec["memory"] = {"argument_bytes": lm_argument_bytes(plan, mesh)}
        if len(mesh.shape) > 2:
            rec.update(status="structs_only", reason=LM_REASON)
            return rec
        # one scan unit past the dense layers, at full width
        cut = min(plan.cfg.n_layers, plan.cfg.first_dense_layers
                  + (2 if plan.cfg.local_global else 1))
        overrides = dict(overrides or {}, n_layers=cut)
        rec["meta"]["stepped_layers"] = cut
        rec["memory"]["stepped_argument_bytes"] = lm_argument_bytes(
            ad.plan(shape, mesh, **overrides), mesh)
        held = "stepped_argument_bytes"
    with shape_only_meshes():
        build = ad.build(shape, mesh, **(overrides or {}))
        if ad.plan is None:
            rec["meta"] = _plain_meta(build.meta)
            rec["memory"] = {"argument_bytes": rank_bytes(build.args, build.specs, mesh)}
        rec["build_s"] = time.perf_counter() - t0
        if not step:
            rec.update(status="structs_only", reason="the step was not asked for")
            return rec
        gen = torch.Generator(device=mesh.device).manual_seed(SEED)
        got, _ = run_step(build, mesh, gen, timed)
    rec["memory"].update(got.pop("memory"))
    rec.update(got)
    if rec["memory"]["built_bytes"] != rec["memory"][held]:
        raise ValueError(f"{arch} {shape}: the built state and batch hold "
                         f"{rec['memory']['built_bytes']} bytes, the structs "
                         f"{rec['memory'][held]}")
    rec["status"] = "ok"
    return rec


def _plain_meta(meta: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in meta.items()
            if isinstance(v, (int, float, str, list, tuple))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", choices=["only", "skip", "both"], default="both")
    ap.add_argument("--device", default="cuda",
                    help="where rank 0's steps run (default: the card; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--batch", type=int, default=None,
                    help="a global batch in place of the cells' own (DLRM and recsys cells)")
    ap.add_argument("--out", type=Path, default=RESULTS)
    args = ap.parse_args(argv)

    args.out.mkdir(parents=True, exist_ok=True)
    names = {"skip": ["pod1x16x16"], "only": ["pod2x16x16"],
             "both": ["pod1x16x16", "pod2x16x16"]}[args.multi_pod]
    archs = [args.arch] if args.arch else cfgbase.list_archs()
    n_ok = n_skip = n_structs = n_fail = 0
    for mesh_name in names:
        for arch in archs:
            ad = cfgbase.get(arch)
            for cell in ad.cells:
                if args.shape and cell.shape != args.shape:
                    continue
                out = args.out / f"{arch}__{cell.shape}__{mesh_name}.json"
                if out.exists():
                    rec = json.loads(out.read_text())
                    if rec.get("status") in ("ok", "skipped", "structs_only"):
                        print(f"[cached] {arch} {cell.shape} {mesh_name}: {rec['status']}")
                        n_ok += rec["status"] == "ok"
                        n_skip += rec["status"] == "skipped"
                        n_structs += rec["status"] == "structs_only"
                        continue
                print(f"[run] {arch} {cell.shape} {mesh_name} ...", flush=True)
                over = ({"batch": args.batch} if args.batch and ad.family in ("dlrm", "recsys")
                        and cell.kind != "retrieval" else None)
                try:
                    mesh = make_production_mesh(**MESHES[mesh_name], device="cpu")
                    rec = run_cell(arch, cell.shape, mesh, mesh_name, over, device=args.device)
                except Exception as e:  # noqa: BLE001  (recorded, counted, exit code 1)
                    rec = {"arch": arch, "shape": cell.shape, "mesh": mesh_name,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-3000:]}
                out.write_text(json.dumps(rec, indent=2))
                status = rec["status"]
                if status == "ok":
                    n_ok += 1
                    m = rec["memory"]
                    peak = (f", peak {m['peak_bytes'] / 2**30:.2f} GiB" if "peak_bytes" in m
                            else "")
                    print(f"  ok: arguments {m['argument_bytes'] / 2**30:.3f} GiB/rank{peak}, "
                          f"product_flops={rec['cost']['product_flops']:.3g}, "
                          f"coll={rec['collectives']['total_bytes']:.3g}B, "
                          f"step {rec['step_ms']:.1f} ms", flush=True)
                elif status == "skipped":
                    n_skip += 1
                    print(f"  skipped: {rec['skip_reason']}")
                elif status == "structs_only":
                    n_structs += 1
                    print(f"  structs_only: arguments "
                          f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB/rank")
                else:
                    n_fail += 1
                    print(f"  ERROR: {rec['error']}", flush=True)
    print(f"\ndry-run summary: ok={n_ok} skipped={n_skip} structs_only={n_structs} "
          f"failed={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
