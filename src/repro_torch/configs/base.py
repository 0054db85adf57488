"""The arch registry (twin of ``repro/configs/base.py``): each architecture
module registers an :class:`ArchDef` whose (arch x shape) cells the dry run
(``launch/dryrun.py``) builds on the production meshes.

``build(shape, mesh, **overrides)`` returns a :class:`CellBuild`: this
rank's step of the cell on ``mesh`` (a ``launch.mesh.Mesh``; on a
shape-only mesh inside ``launch.mesh.shape_only_meshes``), the structs of
its arguments with their specs (``dist.sharding``'s tuples), and the
reference's metadata of the cell.  The LM archs' ``build`` gives the
``models.lm_steps`` step of the cell on the mesh (one card's on a one-rank
mesh), and their ``plan`` the cell's config and metadata, from which the
dry run also counts the per-rank bytes at full depth.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class CellBuild:
    """A cell's step ``fn``, its arguments' ``(shape, dtype)`` trees
    ``args``, the reference's metadata ``meta`` (tokens, params, kind, ...),
    ``specs``: a tuple like ``args`` of spec tuple trees, how the mesh
    holds each argument (None, or an entry None: every leaf is this rank's
    whole), and the ``model`` config the step was built from."""
    fn: Any
    args: tuple
    meta: dict
    specs: Any = None
    model: Any = None


@dataclasses.dataclass
class Cell:
    shape: str
    kind: str                    # train|prefill|decode|score|retrieval
    skip: Optional[str] = None   # reason, if this cell is skipped


@dataclasses.dataclass
class ArchDef:
    """An architecture's cells and builder (the reference's fields), and for
    the LM archs ``plan(shape, mesh, **overrides) -> LMPlan``."""
    name: str
    family: str              # lm|gnn|recsys|dlrm
    cells: list
    build: Callable          # (shape, mesh, **overrides) -> CellBuild
    # overrides: lm/gnn n_layers=...; recsys/dlrm batch=...
    notes: str = ""
    plan: Optional[Callable] = None


_REGISTRY: dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.name] = arch
    return arch


def get(name: str) -> ArchDef:
    _ensure_loaded()
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # every config module, whatever was imported before: a registry that an
    # import of one arch's module had started would otherwise stay partial
    import repro_torch.configs.qwen3_moe_30b_a3b      # noqa: F401
    import repro_torch.configs.deepseek_v2_236b       # noqa: F401
    import repro_torch.configs.internlm2_1_8b         # noqa: F401
    import repro_torch.configs.gemma2_27b             # noqa: F401
    import repro_torch.configs.phi3_medium_14b        # noqa: F401
    import repro_torch.configs.egnn_arch              # noqa: F401
    import repro_torch.configs.fm_arch                # noqa: F401
    import repro_torch.configs.bst_arch               # noqa: F401
    import repro_torch.configs.sasrec_arch            # noqa: F401
    import repro_torch.configs.din_arch               # noqa: F401
    import repro_torch.configs.dlrm_paper             # noqa: F401


# ---------------------------------------------------------------------------
# LM family shared shapes/builder
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k":    dict(kind="train",   L=4096,   B=256),
    "prefill_32k": dict(kind="prefill", L=32768,  B=32),
    "decode_32k":  dict(kind="decode",  L=32768,  B=128),
    "long_500k":   dict(kind="decode",  L=524288, B=1),
}


@dataclasses.dataclass(frozen=True)
class LMPlan:
    """An LM cell on a mesh: the config adapted to it, the batch ``B`` and
    length ``L``, whether the train step keeps momentum, and the
    reference's metadata."""
    cfg: Any
    B: int
    L: int
    kind: str
    momentum: bool
    meta: dict


def lm_archdef(name: str, cfg_fn: Callable, sub_quadratic: bool,
               momentum: bool = True, notes: str = "",
               pure_dp: bool = False) -> ArchDef:
    skip_long = (None if sub_quadratic else
                 "pure full-attention arch: long_500k requires sub-quadratic "
                 "attention (DESIGN.md section 5)")
    cells = [Cell("train_4k", "train"), Cell("prefill_32k", "prefill"),
             Cell("decode_32k", "decode"),
             Cell("long_500k", "decode", skip=skip_long)]

    def plan(shape: str, mesh, n_layers: int | None = None,
             batch: int | None = None, cost_mode: bool = False) -> LMPlan:
        """The reference's adaptation of the config to ``mesh``: the data
        axes and the TP width from the mesh; pure DP on the train shape
        (HC1) where ``pure_dp`` and the batch covers the mesh (both axes
        data-parallel, no TP); ``cost_mode``'s settings; the train
        microbatch cut until each microbatch splits over the data axes."""
        sh = LM_SHAPES[shape]
        bdp = tuple(mesh.axis_names)[:-1]
        cfg = cfg_fn()
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, dp_axes=bdp, tp_size=mesh.shape["model"])
        all_ax = tuple(mesh.axis_names)
        if (pure_dp and sh["kind"] == "train"
                and (batch or sh["B"]) % math.prod(mesh.shape[a] for a in all_ax) == 0):
            cfg = dataclasses.replace(cfg, dp_axes=all_ax, tp_size=1, seq_shard=False)
            bdp = all_ax
        if cost_mode:
            cfg = dataclasses.replace(cfg, cost_mode=True, microbatch=1,
                                      prefill_microbatch=1, loss_chunk=sh["L"])
        B = batch or sh["B"]
        L = sh["L"]
        ndp = math.prod(mesh.shape[a] for a in bdp)
        if cfg.microbatch > 1 and sh["kind"] == "train":
            mb = min(cfg.microbatch, max(1, B // ndp))
            while mb > 1 and (B % mb or (B // mb) % ndp):
                mb -= 1
            cfg = dataclasses.replace(cfg, microbatch=mb)
        meta = dict(arch=name, shape=shape, kind=sh["kind"], family="lm",
                    tokens=B * L, batch=B, seq=L,
                    params=cfg.param_count(),
                    active_params=cfg.active_param_count(),
                    n_layers=cfg.n_layers,
                    scan_unit=2 if cfg.local_global else 1,
                    scan_outside=cfg.first_dense_layers)
        if sh["kind"] == "decode":
            meta["tokens"] = B   # one token per sequence per step
        return LMPlan(cfg, B, L, sh["kind"], momentum, meta)

    def build(shape: str, mesh, n_layers: int | None = None,
              batch: int | None = None, cost_mode: bool = False) -> CellBuild:
        """The cell's step on ``mesh``: the one-card step on a one-rank mesh
        (the mesh's device), else this rank's (``models.lm_steps``), with
        the specs of its arguments."""
        p = plan(shape, mesh, n_layers=n_layers, batch=batch, cost_mode=cost_mode)
        return lm_cell_build(p.cfg, mesh, p.kind, p.B, p.L, p.meta, momentum)

    return register(ArchDef(name, "lm", cells, build, notes=notes, plan=plan))


def lm_cell_build(cfg, mesh, kind: str, B: int, L: int, meta: dict,
                  momentum: bool = True) -> CellBuild:
    """An LM cell's ``kind`` step (train, prefill or decode) of ``cfg`` on
    ``mesh`` (``models.lm_steps``): the one-card step on a one-rank mesh
    (the mesh's device), else this rank's, with the specs of its arguments
    (the train batch over the config's data axes; the tokens, and the
    decode rows where B divides them, over the mesh's)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.models import lm_steps

    bdp = shd.batch_axes(mesh)
    if kind == "train":
        fn, structs = lm_steps.make_lm_train_step(cfg, mesh, B, L, momentum=momentum)
        specs = (shd.lm_state_specs(cfg, momentum),
                 dict.fromkeys(("tokens", "labels"), (cfg.dp_axes, None)))
    elif kind == "prefill":
        fn, structs = lm_steps.make_prefill_step(cfg, mesh, B, L)
        specs = (shd.lm_config_specs(cfg), (bdp, None))
    else:
        fn, structs = lm_steps.make_decode_step(cfg, mesh, B, L)
        rows = (bdp,) if lm_steps.decode_rows(B, mesh) else ()
        specs = (shd.lm_config_specs(cfg), lm_steps.cache_specs(cfg, mesh, B), rows, rows)
    return CellBuild(fn, structs, meta, specs=specs if mesh.size > 1 else None, model=cfg)
