"""The recsys archetypes' shapes and their shared ArchDef builder (twin of
``repro/configs/recsys_common.py``: the paper's hybrid parallelism on each
archetype)."""

from __future__ import annotations

from repro_torch.configs.base import ArchDef, Cell, CellBuild, register

RECSYS_SHAPES = {
    "train_batch":    dict(kind="train", batch=65536),
    "serve_p99":      dict(kind="score", batch=512),
    "serve_bulk":     dict(kind="score", batch=262144),
    # 2^20 candidates: divisible by the 512-device mesh (the brief's 1e6
    # padded up)
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1 << 20),
}


def recsys_archdef(name: str, make_mdef, target_slot: int,
                   notes: str = "") -> ArchDef:
    cells = [Cell(s, RECSYS_SHAPES[s]["kind"]) for s in RECSYS_SHAPES]

    def build(shape: str, mesh, batch: int | None = None,
              n_layers: int | None = None,
              cost_mode: bool = False) -> CellBuild:
        """This rank's step of the cell on ``mesh``: the train step, the
        score step (``serve_*``) or the retrieval step, through
        ``core.hybrid``.  ``args`` are this rank's state and the global
        batch (retrieval: the query and the candidate matrix)."""
        import torch

        from repro_torch.core import hybrid
        from repro_torch.dist import sharding as shd

        sh = RECSYS_SHAPES[shape]
        B = batch or sh["batch"]
        mdef = make_mdef(B)
        layout_slots = (len(mdef.slot_to_table) if mdef.slot_to_table
                        else mdef.spec.num_tables)
        meta = dict(arch=name, shape=shape, kind=sh["kind"], family="recsys",
                    batch=B, slots=layout_slots, pooling=mdef.pooling,
                    emb_dim=mdef.spec.dim,
                    emb_rows=mdef.spec.total_rows,
                    scan_unit=1, scan_outside=0, n_layers=1)
        sstructs = hybrid.state_struct(mdef, mesh)
        layout = hybrid.make_layout(mdef, mesh)
        if sh["kind"] == "train":
            fn = hybrid.make_train_step(mdef, mesh)
        elif sh["kind"] == "score":
            fn = hybrid.make_score_step(mdef, mesh)
        else:
            nc = sh["n_candidates"]
            meta["n_candidates"] = nc
            fn = hybrid.make_retrieval_step(mdef, mesh, nc, target_slot)
            bstructs = hybrid.batch_struct(mdef, mesh, layout, batch=1)
            cand = ((nc, mdef.spec.dim), torch.bfloat16)
            # one query: every field whole on every rank; candidates by rows
            bspecs = {k: (None,) * len(s) for k, (s, _) in bstructs.items()}
            return CellBuild(fn, (sstructs, bstructs, cand), meta,
                             specs=(None, bspecs, (shd.all_axes(mesh), None)), model=mdef)
        bstructs = hybrid.batch_struct(mdef, mesh, layout, batch=B)
        return CellBuild(fn, (sstructs, bstructs), meta,
                         specs=(None, hybrid.batch_specs(mdef, mesh)), model=mdef)

    return register(ArchDef(name, "recsys", cells, build, notes=notes))
