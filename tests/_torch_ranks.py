"""Rank workers of the multi-rank tests: ``launch.local.run_ranks`` runs
one of these in each spawned rank's process, which imports it from this
module by name (the tests' directory is on the children's ``sys.path``,
as it is on the parent's).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.testing import dense_master, to_numpy, to_torch


def hybrid_cases_rank(rank: int, world_size: int, cases: list) -> list:
    """One rank's part of running ``cases`` of the hybrid train step
    (``launch.local.run_ranks`` calls it in each rank's process).  A case is
    a dict: ``cfg`` (``DLRMConfig`` keyword arguments), ``mesh`` (its
    shape over ``("data", "model")``), ``start`` (the reference's global
    train state as numpy arrays), ``batches`` (global batches as numpy
    arrays, one a step; None: ``dlrm.init_state`` from seed 0) and
    optionally ``eval`` (a global batch to score from the start state).
    Returns per case ``{"losses": [...], "scores": this rank's eval scores
    or None,
    "bytes_out": per collective kind over the steps, "state": the gathered
    global state after the steps, "back": ``start`` carried in and gathered
    back (rank 0 only, else None), "cache": this rank's replicated hot-row
    cache (bf16 as int16 bits) or None}``, on the CPU."""
    from repro_torch import weights
    from repro_torch.core import dlrm, hybrid
    from repro_torch.launch.mesh import make_mesh

    out = []
    for case in cases:
        cfg = dlrm.DLRMConfig(**case["cfg"])
        mesh = make_mesh(case["mesh"], ("data", "model"), device="cpu")
        if case["start"] is None:
            state = dlrm.init_state(cfg, torch.Generator().manual_seed(0), mesh=mesh)
            back = None
        else:
            state = weights.state_from_numpy(case["start"], cfg, mesh, device="cpu")
            back = weights.state_to_numpy(state, mesh, cfg)
        scores = None
        if case.get("eval") is not None:
            ev = dlrm.make_eval_step(cfg, mesh)
            scores = to_numpy(ev(state, hybrid.local_batch(
                cfg, mesh, {k: to_torch(v) for k, v in case["eval"].items()})))
        step = dlrm.make_train_step(cfg, mesh)
        mesh.stats.reset()
        losses = []
        for b in case["batches"]:
            batch = hybrid.local_batch(cfg, mesh, {k: to_torch(v) for k, v in b.items()})
            state, loss = step(state, batch)
            losses.append(float(loss))
        bytes_out = dict(mesh.stats.bytes_out)
        gathered = weights.state_to_numpy(state, mesh, cfg)
        cache = ({k: _np_bits(v) for k, v in state["cache"].items()} if "cache" in state
                 else None)
        out.append({"losses": losses, "scores": scores, "bytes_out": bytes_out,
                    "state": gathered if rank == 0 else None,
                    "back": back if rank == 0 else None, "cache": cache})
    return out


def _np_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy, bf16 as its int16 bits."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def comm_cases_rank(rank: int, world_size: int, inputs: dict) -> dict:
    """One rank's part of the collective checks of
    ``tests/test_torch_comm.py`` on a ``(2, 2)`` mesh over ``("data",
    "model")`` (``launch.local.run_ranks`` calls it in each rank's
    process).  ``inputs[name]`` stacks every rank's operand on dim 0 (bf16
    ones as their int16 bits, named ``*_bf16``); returns each result as
    numpy (bf16 as int16 bits), the per-kind ``bytes_in`` / ``bytes_out``
    and calls, and the dense Split-SGD step's new ``hi`` and ``lo``."""
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import data_parallel as dp

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")

    def mine(name):
        t = torch.from_numpy(np.ascontiguousarray(inputs[name][rank]))
        return t.view(torch.bfloat16) if name.endswith("_bf16") else t

    g_all, g_model, g_data = (mesh.group(a) for a in (("data", "model"), "model", "data"))
    out = {
        "all_gather_model": comm.all_gather(mine("ag_i32"), g_model),
        "all_gather_all_bf16": comm.all_gather(mine("ag_bf16"), g_all),
        "all_gather_data": comm.all_gather(mine("ag_i32"), g_data),
        "all_to_all_0_1": comm.all_to_all(mine("a2a_f32"), g_all, 0, 1),
        "all_to_all_1_0_bf16": comm.all_to_all(mine("a2a_bf16"), g_model, 1, 0),
        "psum_scatter_all_bf16": comm.psum_scatter(mine("rs_bf16"), g_all),
        "psum_scatter_all_f32": comm.psum_scatter(mine("rs_f32"), g_all),
        "psum_scatter_model_f32": comm.psum_scatter(mine("rs_f32"), g_model),
        "psum_all": comm.psum(mine("psum_f32"), g_all),
    }
    stats = {k: (dict(v) if isinstance(v, dict) else v) for k, v in mesh.stats.as_dict().items()}
    out["psum_all_i32"] = comm.psum(mine("psum_i32"), g_all)  # after the counted ones
    # the dense step: replicated hi, this rank's lo shard, this rank's gradient
    d = inputs["dense"]
    hi_tree = {"w": torch.from_numpy(d["hi"]).view(torch.bfloat16)}
    chunk = d["lo"].size // world_size
    state = {"hi": dp.pack_hi(hi_tree, d["lo"].size)[1],
             "lo": torch.from_numpy(d["lo"][rank * chunk:(rank + 1) * chunk].view(np.int16).copy()),
             "err": None}
    new = dp.rs_ag_split_sgd(state, {"w": torch.from_numpy(d["g"][rank])}, d["lr"],
                             num_buckets=d["num_buckets"], group=g_all)
    # table mode's sparse update gathering the replicas' ids and weights itself,
    # against the same update on ids and weights gathered beforehand
    from repro_torch.core import sharded_embedding as se
    from repro_torch.core.embedding import EmbeddingSpec
    layout = se.make_layout(EmbeddingSpec((10, 7, 12, 5), 4), 2, "table")
    u = inputs["update"]
    idx, wgt = torch.from_numpy(u["idx"][rank]), torch.from_numpy(u["wgt"][rank])
    members = [r for r in range(world_size) if r % 2 == rank % 2]  # this rank's data group
    W0 = torch.from_numpy(u["W"][rank % 2].copy())
    dY = torch.from_numpy(u["dY"][rank % 2])
    a = se.apply_update(layout, {"w": W0.clone()}, "sgd", idx, dY, 0.5, weights=wgt,
                        group=g_model, replica_group=g_data)["w"]
    b = se.apply_update(layout, {"w": W0.clone()}, "sgd",
                        torch.cat([torch.from_numpy(u["idx"][r]) for r in members]), dY, 0.5,
                        weights=torch.cat([torch.from_numpy(u["wgt"][r]) for r in members]),
                        group=g_model)["w"]
    res = {k: _np_bits(v) for k, v in out.items()}
    res["replica_update"], res["replica_update_want"] = a.numpy(), b.numpy()
    res["dense_hi"] = _np_bits(new["hi"]["w"])
    res["dense_lo"] = new["lo"].numpy().copy()
    res["stats"] = stats
    return res


def card_cpu_cases_rank(rank: int, world_size: int, cases: list, device: str) -> list:
    """One rank's part of running each of ``cases`` (``DLRMConfig`` keyword
    arguments, ``exchange`` as a dict of ``ExchangeConfig`` fields) for
    ``steps`` seeded batches on a ``(1, world_size)`` mesh
    twice, on ``device`` (gloo: the payloads staged through host memory)
    and on the CPU, from one state drawn on the CPU.  Returns per case the
    losses, the rank's fp32 embedding and dense master shards before and
    after (as numpy), and the card mesh's collective stats; no
    ``ml_dtypes`` needed."""
    from repro_torch import weights
    from repro_torch.core import dlrm, hybrid
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.split_sgd import combine_split

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    axes = ("data", "model")
    card, cpu = make_mesh((1, world_size), axes, dev), make_mesh((1, world_size), axes, "cpu")

    def masters(state):
        emb = state["emb"]
        w = emb["w"] if "w" in emb else combine_split(emb["hi"], emb["lo"])
        return (w.cpu().numpy().copy(),
                dense_master(state["dense"], world_size, rank).cpu().numpy().copy())

    out = []
    for kw, steps in cases:
        if isinstance(kw.get("exchange"), dict):
            from repro_torch.dist.exchange import ExchangeConfig
            kw = {**kw, "exchange": ExchangeConfig(**kw["exchange"])}
        cfg = dlrm.DLRMConfig(**kw)
        s_cpu = dlrm.init_state(cfg, torch.Generator().manual_seed(0), device="cpu", mesh=cpu)
        s_card = weights.state_to(s_cpu, dev)
        start = masters(s_cpu)
        step_cpu, step_card = dlrm.make_train_step(cfg, cpu), dlrm.make_train_step(cfg, card)
        layout = hybrid.make_layout(cfg, cpu)
        rng = np.random.default_rng(1)
        card.stats.reset()
        losses = {"cpu": [], "card": []}
        for _ in range(steps):
            idx = torch.from_numpy(np.stack(
                [rng.zipf(1.3, (cfg.batch, cfg.pooling)) % m for m in cfg.table_rows], 1)
                .astype(np.int32))
            b = {"idx": idx,
                 "dense_x": torch.from_numpy(rng.standard_normal((cfg.batch, cfg.num_dense))
                                             .astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(0, 2, cfg.batch).astype(np.float32))}
            if cfg.emb_mode == "table" and cfg.idx_input == "replicated":
                from repro_torch.core import sharded_embedding as se
                b["idx"] = se.permute_indices(layout, b["idx"])
            s_cpu, l_cpu = step_cpu(s_cpu, hybrid.local_batch(cfg, cpu, b))
            s_card, l_card = step_card(s_card, hybrid.local_batch(
                cfg, card, {k: v.to(dev) for k, v in b.items()}))
            losses["cpu"].append(float(l_cpu))
            losses["card"].append(float(l_card))
        out.append({"losses": losses, "start": start, "cpu": masters(s_cpu),
                    "card": masters(s_card), "stats": card.stats.as_dict()})
    return out


def _wait_for(tmp: str, name: str, timeout_s: float = 300.0) -> None:
    """Wait until the file ``name`` appears in ``tmp`` (the reference's
    process writes it); raise if ``ref_failed`` appears or time runs out."""
    import os
    import time
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(os.path.join(tmp, name)):
        if os.path.exists(os.path.join(tmp, "ref_failed")):
            raise RuntimeError("the reference's process failed")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {name} in {tmp} after {timeout_s} s")
        time.sleep(0.1)


def loop_mesh_rank(rank: int, world_size: int, c: dict, tmp: str) -> dict:
    """One rank's part of ``tests/test_torch_loop_mesh.py`` on a (2, 4) mesh
    on the CPU: the quickstart's configuration through ``TrainLoop`` (8
    steps with a checkpoint every 4 into ``tmp/port_qs``, a second loop on a
    state from another seed that restores step 8 and runs to 12, and 12
    steps without a checkpoint), the next step of the restarted state; then
    ``port_ready`` is written, and once the reference's process has written
    ``ref_ready``, a loop that restores the reference's checkpoint of
    ``tmp/ref_qs`` and its next step; last the elastic configuration's
    steps on (2, 4), its gathered state saved into ``tmp/port_el``.
    Returns losses, and on rank 0 the gathered states."""
    import os
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dlrm, hybrid
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainLoop, TrainLoopConfig

    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    out: dict = {}

    def fresh(start, cfg):  # a copy: the step updates its state in place
        return weights.state_to(weights.state_from_numpy(start, cfg, mesh, device="cpu"), "cpu")

    def local(cfg, b):
        return hybrid.local_batch(cfg, mesh, {k: to_torch(v) for k, v in b.items()})

    cfg = dlrm.DLRMConfig(**c["qs_cfg"])
    step = dlrm.make_train_step(cfg, mesh)
    batches = c["qs_batches"]

    def loop(steps, state, stream, ckdir=None):
        return TrainLoop(TrainLoopConfig(steps=steps, ckpt_dir=ckdir, ckpt_every=c["every"],
                                         log_every=100),
                         step, state, stream, mesh=mesh, model_cfg=cfg)

    ck = os.path.join(tmp, "port_qs")
    stream = iter(batches)
    first = loop(c["restart"], fresh(c["qs_start"], cfg), stream, ck)
    first.run()
    other = dlrm.init_state(cfg, torch.Generator().manual_seed(3), mesh=mesh)
    second = loop(c["steps"], other, stream, ck)
    second.run()
    whole = loop(c["steps"], fresh(c["qs_start"], cfg), iter(batches))
    whole.run()
    out["losses"], out["start_step"] = first.losses + second.losses, second.start_step
    out["whole_losses"] = whole.losses
    restarted = weights.state_to_numpy(second.state, mesh, cfg)
    uninterrupted = weights.state_to_numpy(whole.state, mesh, cfg)
    out["next"] = float(step(second.state, local(cfg, batches[c["steps"]]))[1])
    if rank == 0:
        out["restarted"], out["uninterrupted"] = restarted, uninterrupted
        open(os.path.join(tmp, "port_ready"), "w").close()
        _wait_for(tmp, "ref_ready")
    dist.barrier()
    theirs = loop(c["steps"], fresh(c["qs_start"], cfg), iter(()), os.path.join(tmp, "ref_qs"))
    out["ref_start_step"] = theirs.start_step
    out["on_ref"] = float(step(theirs.state, local(cfg, batches[c["steps"]]))[1])

    ecfg = dlrm.DLRMConfig(**c["el_cfg"])
    estep = dlrm.make_train_step(ecfg, mesh)
    state = fresh(c["el_start"], ecfg)
    out["el_big"] = [float(estep(state, local(ecfg, b))[1]) for b in c["el_batches"][:c["k1"]]]
    glob = weights.state_to_global(state, mesh, ecfg)
    if rank == 0:
        CheckpointManager(os.path.join(tmp, "port_el")).save(c["k1"], glob, blocking=True)
    dist.barrier()
    return out


def elastic_rank(rank: int, world_size: int, c: dict, tmp: str) -> dict:
    """One rank's part of the elastic restart of ``tests/test_torch_loop_mesh.py``
    on a (1, 4) mesh on the CPU: the (2, 4) checkpoints of the reference
    (``tmp/ref_el``) and of the port (``tmp/port_el``) restored, laid out
    for four shards (``weights.reshard_global``) and cut, then the next
    batches.  Returns per checkpoint the losses and, on rank 0, the restored
    state gathered back."""
    import os
    from repro_torch import weights
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dlrm, hybrid
    from repro_torch.launch.mesh import Mesh, make_mesh

    small = make_mesh((1, 4), ("data", "model"), device="cpu")
    big = Mesh(shape={"data": 2, "model": 4}, device=torch.device("cpu"))  # its shape alone
    cfg = dlrm.DLRMConfig(**c["el_cfg"])
    step = dlrm.make_train_step(cfg, small)
    out = {}
    for src in ("ref_el", "port_el"):
        at, glob = CheckpointManager(os.path.join(tmp, src)).restore(
            weights.global_like(cfg, big), device="cpu")
        state = weights.state_from_global(weights.reshard_global(glob, cfg, big, small), cfg, small)
        restored = weights.state_to_numpy(state, small, cfg)
        losses = [float(step(state, hybrid.local_batch(
            cfg, small, {k: to_torch(v) for k, v in b.items()}))[1])
            for b in c["el_batches"][c["k1"]:]]
        out[src] = {"step": at, "losses": losses, "restored": restored if rank == 0 else None}
    return out


def option_meshes(rank: int, world_size: int) -> dict:
    """The meshes the option tests run on, by shape, made in one order on
    every rank of a world of 4: (2, 2) and (1, 4) over the world, (1, 2)
    over this rank's pair (ranks 0-1 or 2-3), (1, 1) with no process group
    (rank 0's alone)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    axes = ("data", "model")
    meshes = {(2, 2): make_mesh((2, 2), axes, "cpu"), (1, 4): make_mesh((1, 4), axes, "cpu")}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    meshes[(1, 2)] = make_mesh((1, 2), axes, "cpu", group=pairs[rank // 2])
    meshes[(1, 1)] = make_mesh((1, 1), axes, "cpu")
    return meshes


def _tree_copy(tree):
    from repro_torch.optim import data_parallel as dp
    return dp.tree_map(lambda a: np.array(a, copy=True), tree)


def run_option_case(rank: int, mesh, c: dict) -> dict | None:
    """One case of the option tests on this rank's ``mesh``: the start
    state's shard, the steps over the case's global batches cut to the rank
    (``core.hybrid.local_batch``).  Returns on the case's first rank (None
    elsewhere) the losses, the gathered global state after each step and
    each step's collective bytes by kind."""
    from repro_torch import weights
    from repro_torch.core import dlrm, hybrid
    from _torch_cases import cfg_of

    cfg = cfg_of(c["cfg"])
    state = weights.state_from_numpy(_tree_copy(c["start"]), cfg, mesh, device="cpu")
    step = dlrm.make_train_step(cfg, mesh)
    losses, states, stats = [], [], []
    for b in c["batches"]:
        mesh.stats.reset()
        batch = hybrid.local_batch(cfg, mesh, {k: to_torch(v) for k, v in b.items()})
        state, loss = step(state, batch)
        losses.append(float(loss))
        stats.append({k: dict(v) for k, v in mesh.stats.as_dict().items() if isinstance(v, dict)})
        states.append(weights.state_to_numpy(state, mesh, cfg))
    if mesh.rank != 0:
        return None
    return {"losses": losses, "states": states, "stats": stats}


def option_cases_rank(rank: int, world_size: int, cases: list, units: str = "") -> dict:
    """One rank's part of the option tests (``tests/test_torch_presort.py``,
    ``test_torch_wire.py``, ``test_torch_microbatch.py``) in a world of 4:
    each case on its mesh (a (1, 1) case on rank 0 alone, a (1, 2) case on
    both pairs), then the file's unit checks, ``units`` naming a function of
    this module called as ``fn(rank, meshes, inputs)`` with ``cases`` the
    pair ``(cases, inputs)``.  Returns ``{"cases": [...], "units": ...}``,
    the cases' results on rank 0 (the first pair's for (1, 2))."""
    meshes = option_meshes(rank, world_size)
    cases, inputs = cases
    out = []
    for c in cases:
        mesh = meshes[tuple(c["mesh"])]
        if mesh.size == 1 and rank != 0:
            out.append(None)
            continue
        res = run_option_case(rank, mesh, c)
        out.append(res if rank == 0 else None)
    return {"cases": out, "units": globals()[units](rank, meshes, inputs) if units else None}


def ring_units_rank(rank: int, meshes: dict, units: list) -> list:
    """``core.pipeline.ring_all_gather`` and ``comm.all_gather`` of one
    payload a rank (its values from the rank) for each ``(mesh, axes, shape,
    dtype)`` of ``units``; returns the two results' bits a unit."""
    from repro_torch.core.pipeline import ring_all_gather
    from repro_torch.dist import comm

    out = []
    for shape, axes, pshape, dtype in units:
        mesh = meshes[tuple(shape)]
        x = (torch.arange(int(np.prod(pshape)), dtype=torch.float32).reshape(pshape) * 0.37
             + 100 * rank).to(getattr(torch, dtype))
        out.append((_np_bits(ring_all_gather(x, mesh, axes)),
                    _np_bits(comm.all_gather(x, mesh.group(axes)))))
    return out


def wire_units_rank(rank: int, meshes: dict, inputs: dict) -> dict:
    """The wire checks of ``tests/test_torch_wire.py`` on this rank of the
    (2, 2) mesh: the dense Split-SGD step (``rs_ag_split_sgd``) on the
    ``bf16`` wire with the error feedback's slab and on the ``bf16_sr``
    wire, and ``gather_dY`` of three cotangents (random, zero, small
    integers) on every wire in row and table mode.  Returns the results as
    numpy (bf16 as int16 bits in ``dense``, as fp32 values in ``dY``)."""
    from repro_torch.core import sharded_embedding as se
    from repro_torch.core.embedding import EmbeddingSpec
    from repro_torch.optim import data_parallel as dp

    mesh = meshes[(2, 2)]
    g_all = mesh.group(("data", "model"))
    d = inputs["dense"]
    chunk = d["lo"].size // 4
    seed = torch.tensor(d["seed"], dtype=torch.int32)
    dense = {}
    for wire, with_err in (("bf16", True), ("bf16_sr", False)):
        hi = torch.from_numpy(d["hi"].copy()).view(torch.bfloat16)
        err = torch.from_numpy(d["err"][rank * chunk:(rank + 1) * chunk].copy())
        state = {"hi": dp.pack_hi({"w": hi}, d["lo"].size)[1],
                 "lo": torch.from_numpy(d["lo"].view(np.int16)[rank * chunk:(rank + 1) * chunk]
                                        .copy()),
                 "err": err if with_err else None}
        new = dp.rs_ag_split_sgd(state, {"w": torch.from_numpy(d["g"][rank].copy())}, d["lr"],
                                 d["nb"], g_all, wire_dtype=wire, seed=seed)
        dense[wire] = {"hi": _np_bits(new["hi"]["w"]), "lo": new["lo"].numpy().copy(),
                       "err": (new["err"] if with_err else err).numpy().copy()}
    g = inputs["dY"]
    dy, dtype = {}, {}
    B = g["B"]
    for mode in ("row", "table"):
        layout = se.make_layout(EmbeddingSpec(tuple(g["rows"]), g["E"]), 4 if mode == "row" else 2,
                                mode)
        g_emb, g_rep = ((g_all, None) if mode == "row"
                        else (mesh.group("model"), mesh.group("data")))
        maps = se.slot_maps(layout, "cpu") if mode == "table" else None
        for wire in ("fp32", "bf16", "bf16_sr"):
            for what in ("values", "zeros", "exact"):
                x = torch.from_numpy(g[what][rank * B // 4:(rank + 1) * B // 4].copy())
                out = se.gather_dY(layout, x, g_emb, g_rep, maps, wire_dtype=wire,
                                   seed=torch.tensor(g["seed"], dtype=torch.int32), tag=g["tag"])
                dtype[mode, wire] = str(out.dtype).removeprefix("torch.")
                dy[mode, wire, what] = out.float().numpy().copy()
    return {"dense": dense, "dY": dy, "dtype": dtype}


def int_psum_rank(rank: int, world_size: int, device: str) -> dict:
    """``comm.psum`` of int32 values past 2^24 (float bit patterns among them)
    over this rank's mesh of the whole world on ``device`` (an NCCL group of
    one rank in ``tests/test_torch_cuda.py``); returns operand and result."""
    import torch.distributed as dist
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    mesh = make_mesh((1, world_size), ("data", "model"), dev, group=dist.group.WORLD)
    g = mesh.group(("data", "model"))
    x = torch.tensor([0x3F800001, -0x40800001, 2 ** 24 + 1, 2 ** 30 + 3, -7], dtype=torch.int32,
                     device=dev) * (rank + 1)
    out = comm.psum(x, g)
    return {"x": x.cpu().numpy(), "out": out.cpu().numpy(), "backend": g.backend}


def rank_echo(rank: int, world: int, fail_rank: int):
    """``rank``, or a ``ValueError`` on rank ``fail_rank``."""
    if rank == fail_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank
