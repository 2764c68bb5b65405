"""What each rank of the multi-process tests runs (see ``torch_spawn``).

Free of JAX and of ``repro``: every rank builds the port's twin of the
reference's pipeline or model from the same seed, runs the same calls in
the same order (the collectives need it) and returns numpy arrays and
plain values; the test process compares them with ``repro``.
"""
import dataclasses
import os

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.compose import dataset_lineage
from repro_torch.core.distributed import (
    backward_frontier_sharded,
    compose_sharded,
    gather_rows,
    lineage_audit_sharded,
    shard_relation,
)
from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import pack_bits
from repro_torch.launch import sharding as SD
from repro_torch.launch.mesh import make_local_mesh, make_mesh, use_mesh
from repro_torch.models import pshard as PS
from repro_torch.provenance import ShardedProvenanceIndex, prov
from repro_torch.train.checkpoint import CheckpointManager, flatten_tree
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import init_train_state, make_train_step
from torch_pipegen import compose_pipeline, random_pipeline

CPU = "cpu"


def _np(t):
    return t.detach().cpu().numpy()


def _full(tree):
    """{path: numpy} of a tree whose leaves may be DTensors (collective)."""
    return {k: _np(v.full_tensor() if isinstance(v, DTensor) else v)
            for k, v in flatten_tree(tree)}


# ---------------------------------------------------------------------------
# DTensor placements against NamedSharding's slices
# ---------------------------------------------------------------------------
PLACEMENT_X = (8, 12, 4)
PLACEMENT_CASES = [     # (mesh axes, spec) on a (2, 2) mesh
    (("pod", "data"), (("pod", "data"), None, None)),
    (("pod", "data"), ("data", "pod", None)),
    (("pod", "data"), (None, None, None)),
    (("data", "model"), ("data", "model", None)),
    (("data", "model"), (None, ("data", "model"), None)),
    (("data", "model"), ("model", None, "data")),
]


def placement(rank, world):
    x = torch.arange(int(np.prod(PLACEMENT_X)), dtype=torch.float32).reshape(PLACEMENT_X)
    # the same meshes in the same order on every rank (building one is
    # collective; a set's order would differ between processes)
    meshes = {axes: make_mesh((2, 2), axes, CPU) for axes in dict.fromkeys(
        a for a, _ in PLACEMENT_CASES)}
    out = []
    for axes, spec in PLACEMENT_CASES:
        mesh = meshes[axes]
        d = SD.place({"x": x}, {"x": SD.Sharding(mesh, SD.to_placements(spec, mesh))})["x"]
        out.append(_np(d.to_local()))
    return {"locals": out}


# ---------------------------------------------------------------------------
# The sharded train step, the elastic restore and the resume
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S = 8, 16


def train_batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (TRAIN_B, TRAIN_S)).astype(np.int64)
    labels = np.concatenate([toks[:, 1:], -np.ones((TRAIN_B, 1), np.int64)], axis=1)
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}


def train_setup(arch, world):
    cfg = get_smoke_config(arch)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=4, moment_dtype=torch.float32)
    policy = {"dp": ("data",), "tp": "model", "moe_groups": world}
    return cfg, opt, policy


def _state_out(state, metrics):
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "step": int(_np(state.opt.step.full_tensor() if isinstance(state.opt.step, DTensor)
                            else state.opt.step)),
            "params": _full(state.params), "mu": _full(state.opt.mu)}


def unsharded_steps(arch, world):
    """Two float32 steps of the smoke on one process, no mesh, under the
    same policy (its MoE groups included)."""
    cfg, opt, policy = train_setup(arch, world)
    step = make_train_step(cfg, opt, n_micro=2, dtype=torch.float32)
    batch = train_batch(cfg.vocab)
    with PS.use_policy(policy):
        s1, m1 = step(init_train_state(cfg, torch.Generator().manual_seed(0), opt, CPU), batch)
        s2, m2 = step(s1, batch)
    return [_state_out(s1, m1), _state_out(s2, m2)]


def _placements(state):
    return {k: [str(p) for p in v.placements] for k, v in flatten_tree(state)}


def train(rank, world, archs, root):
    mesh = make_mesh((world, 1), ("data", "model"), CPU)
    out = {}
    for arch in archs:
        cfg, opt, policy = train_setup(arch, world)
        step = make_train_step(cfg, opt, n_micro=2, dtype=torch.float32)
        with use_mesh(mesh), PS.use_policy(policy):
            state = init_train_state(cfg, torch.Generator().manual_seed(0), opt, CPU)
            sh = SD.to_shardings(SD.state_pspecs(cfg, state, mesh), mesh)
            state = SD.place(state, sh)
            batch = train_batch(cfg.vocab)
            batch = SD.place(batch, SD.to_shardings(SD.batch_pspecs(batch, mesh), mesh))
            placed = _placements(state)
            s1, m1 = step(state, batch)
            s2, m2 = step(s1, batch)
            res = {"sharded": [_state_out(s1, m1), _state_out(s2, m2)],
                   "placements": [placed, _placements(s1), _placements(s2)],
                   "specs": {k: [str(p) for p in v.placements]
                             for k, v in flatten_tree(sh, is_leaf=lambda x: isinstance(
                                 x, SD.Sharding))}}
            if rank == 0:
                res["unsharded"] = unsharded_steps(arch, world)
        out[arch] = res
    if archs:
        out["elastic"] = elastic(rank, world, archs[0], mesh, root)
    return out if rank == 0 else {k: v for k, v in out.items() if k == "elastic"}


def elastic(rank, world, arch, mesh, root):
    """A 2-step ``run_training`` on the (world, 1) mesh, its last
    checkpoint restored onto (1, world) bit for bit; then a run crashed
    at step 1 and resumed through ``run_training(state_shardings=)``."""
    cfg, opt, policy = train_setup(arch, world)
    step = make_train_step(cfg, opt, n_micro=2, dtype=torch.float32)
    batch = train_batch(cfg.vocab)
    quiet = lambda s: None  # noqa: E731
    with use_mesh(mesh), PS.use_policy(policy):
        state0 = init_train_state(cfg, torch.Generator().manual_seed(0), opt, CPU)
        sh = SD.to_shardings(SD.state_pspecs(cfg, state0, mesh), mesh)
        placed = SD.place(state0, sh)
        batch = SD.place(batch, SD.to_shardings(SD.batch_pspecs(batch, mesh), mesh))
        loop = LoopConfig(total_steps=2, ckpt_every=1)
        ck_a = CheckpointManager(os.path.join(root, f"a{rank}"), keep=1)
        out_a = run_training(step, placed, lambda s: batch, ck_a, loop, log=quiet)
        final_a = out_a["final_state"]
        other = make_mesh((1, world), ("data", "model"), CPU)
        sh2 = SD.to_shardings(SD.state_pspecs(cfg, final_a, other), other)
        restored = ck_a.restore(2, like=final_a, device=CPU, shardings=sh2)
        ck_b = CheckpointManager(os.path.join(root, f"b{rank}"), keep=1)
        try:
            run_training(step, placed, lambda s: batch, ck_b,
                         dataclasses.replace(loop, fail_at_step=1), log=quiet)
        except RuntimeError as e:
            if "injected failure at step 1" not in str(e):
                raise
        out_b = run_training(step, placed, lambda s: batch, ck_b, loop,
                             state_shardings=sh, log=quiet)
        return {"saved": _full(final_a), "restored": _full(restored),
                "restored_placements": _placements(restored),
                "want_placements": {k: [str(p) for p in v.placements]
                                    for k, v in flatten_tree(
                                        sh2, is_leaf=lambda x: isinstance(x, SD.Sharding))},
                "restored_mesh": [list(v.device_mesh.mesh_dim_names)
                                  for _, v in flatten_tree(restored)][0],
                "losses_a": out_a["losses"], "losses_b": out_b["losses"],
                "resumed_from": out_b["resumed_from"],
                "final_a": _full(final_a), "final_b": _full(out_b["final_state"]),
                "final_b_placements": _placements(out_b["final_state"]),
                "placed_placements": _placements(placed)}


# ---------------------------------------------------------------------------
# compose / audit / frontier over a ("data",) mesh
# ---------------------------------------------------------------------------
def _relations(mesh, n):
    idx, mid, sink = compose_pipeline(1, n)
    n_src, n_dst = idx.datasets["src"].n_rows, idx.datasets[sink].n_rows
    rel = dataset_lineage(idx, "src", sink)
    K.reset_launch_counts()
    a = shard_relation(pack_bits(dataset_lineage(idx, "src", mid)), mesh)
    b = shard_relation(pack_bits(dataset_lineage(idx, mid, sink)), mesh)
    c = compose_sharded(a, b)
    launches = K.launch_counts().get("bitmatmul", 0)
    rb = shard_relation(pack_bits(rel), mesh)
    grp = shard_relation(idx.datasets["src"].table.col("g").to(torch.int32), mesh)
    mask = torch.zeros(n_dst, dtype=torch.bool)
    mask[: n_dst // 2] = True
    mw = pack_bits(mask[None])[0]
    counts = lineage_audit_sharded(rb, grp, mw, 2)
    frontier = backward_frontier_sharded(rb, mw)
    return {"rel_bits": _np(pack_bits(rel)), "composed": _np(gather_rows(c)[:n_src]),
            "composed_dtensor": _np(c.full_tensor()[:n_src]),
            "local_rows": c.to_local().shape[0], "launches": launches,
            "counts": _np(counts), "frontier": _np(gather_rows(frontier)[:n_src])}


def distributed(rank, world, ns):
    """Each n on a ("data",) mesh of the world, and at 4 ranks also on a
    (2, 2) ("pod", "data") mesh, rows split pod-major over both."""
    meshes = {"data": make_local_mesh(CPU)}
    if world == 4:
        meshes["pod"] = make_mesh((2, 2), ("pod", "data"), CPU)
    return {(name, n): _relations(mesh, n) for name, mesh in meshes.items() for n in ns}


# ---------------------------------------------------------------------------
# The collective engine
# ---------------------------------------------------------------------------
def collective(rank, world, probes):
    out = {}
    for seed, (fwd, bwd) in probes.items():
        idx, sink, _ = random_pipeline(seed, name="shardcoll")
        res = {}
        for engine in ("collective", "numpy"):
            sv = ShardedProvenanceIndex(idx, world, engine=engine)
            ss = sv.session(use_hopcache=False)
            res[engine] = {
                "name": sv.engine_name,
                "fwd": _np(ss.run_masks(prov(sv).source("src").rows_batch(fwd).forward()
                                        .to(sink).plan())),
                "bwd": _np(ss.run_masks(prov(sv).source(sink).rows_batch(bwd).backward()
                                        .to("src").plan())),
            }
        res["auto"] = ShardedProvenanceIndex(idx, world).engine_name
        res["auto_wider"] = ShardedProvenanceIndex(idx, world + 1).engine_name
        out[seed] = res
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel regions: train, prefill and decode on a (2, 2) mesh
# ---------------------------------------------------------------------------
TP_B, TP_S, TP_POS = 8, 16, 5


def _tp_inputs(cfg, seed=2):
    rng = np.random.default_rng(seed)
    batch = train_batch(cfg.vocab, seed)
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((TRAIN_B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    return batch


def _tp_serve(cfg, params, batch, mesh=None):
    """Float32 prefill logits and caches of the batch's first half, then a
    decode step at ``TP_POS`` over a fresh cache (whisper's cross K/V
    written by ``encode_into_cache``): numpy, DTensors gathered."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import whisper
    from repro_torch.models.registry import get_model

    model = get_model(cfg)
    half = {k: v[:TRAIN_B // 2] for k, v in batch.items()}
    cache = model.init_cache(cfg, TRAIN_B, TP_S, dtype=torch.float32, device=CPU)
    token = batch["tokens"][:, TP_POS]
    if mesh is not None:
        params = SD.place(params, SD.to_shardings(SD.param_pspecs(cfg, params, mesh), mesh))
        half = SD.place(half, SD.to_shardings(SD.batch_pspecs(half, mesh), mesh))
        specs = SD.cache_pspecs(cache, mesh)
        layers = SD.place(dict(enumerate(cache)),
                          SD.to_shardings(dict(enumerate(specs)), mesh))
        cache = [layers[i] for i in range(len(specs))]
        tok = SD.place({"token": token, "frames": batch.get("frames", token)},
                       SD.to_shardings(SD.batch_pspecs(
                           {"token": token, "frames": batch.get("frames", token)}, mesh), mesh))
        token, frames = tok["token"], tok["frames"]
    else:
        frames = batch.get("frames")
    with implicit_replication():
        if cfg.is_encdec:
            logits, caches = model.prefill(cfg, params, half["frames"], half["tokens"],
                                           dtype=torch.float32)
            whisper.encode_into_cache(cfg, params, frames, cache)
        else:
            logits, caches = model.prefill(cfg, params, half["tokens"], dtype=torch.float32)
        step, cache = model.decode_step(cfg, params, token, TP_POS, cache, dtype=torch.float32)
    return {"prefill": _full(logits), "prefill_cache": _full(dict(enumerate(caches))),
            "decode": _full(step), "decode_cache": _full(dict(enumerate(cache)))}


def tp(rank, world, archs):
    """Every arch's float32 train step, prefill and decode on a (2, 2)
    ("data", "model") mesh under the launcher's policy, and rank 0's
    unsharded twins under the same policy."""
    mesh = make_mesh((2, 2), ("data", "model"), CPU)
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        opt = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=4,
                          moment_dtype=torch.float32)
        policy = {"dp": ("data",), "tp": "model", "moe_groups": 2}
        step = make_train_step(cfg, opt, n_micro=2, dtype=torch.float32)
        batch = _tp_inputs(cfg)
        with use_mesh(mesh), PS.use_policy(policy):
            state = init_train_state(cfg, torch.Generator().manual_seed(0), opt, CPU)
            params = state.params
            state = SD.place(state, SD.to_shardings(SD.state_pspecs(cfg, state, mesh), mesh))
            placed = SD.place(batch, SD.to_shardings(SD.batch_pspecs(batch, mesh), mesh))
            res = {"sharded": _state_out(*step(state, placed)),
                   "serve": _tp_serve(cfg, params, batch, mesh)}
        if rank == 0:
            with PS.use_policy(policy):
                state = init_train_state(cfg, torch.Generator().manual_seed(0), opt, CPU)
                res["plain"] = _state_out(*step(state, batch))
                res["plain_serve"] = _tp_serve(cfg, state.params, batch)
        out[arch] = res
    return out if rank == 0 else {}


# ---------------------------------------------------------------------------
# The batch-1 long-context decode on a (2, 2) mesh
# ---------------------------------------------------------------------------
LONG_S, LONG_STEPS = 64, 6


def _long_decode(cfg, params, seed, mesh=None):
    """Float32 logits and the whole cache after each of ``LONG_STEPS``
    batch-1 decode steps at the last positions of a ``LONG_S``-position
    cache filled from ``seed`` (numpy): on ``mesh`` with every tensor
    placed by the launcher's rules, or unsharded."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.registry import get_model

    model = get_model(cfg)
    rng = np.random.default_rng(seed)
    cache = model.init_cache(cfg, 1, LONG_S, dtype=torch.float32, device=CPU)
    for lc in cache:
        for t in lc.values():
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, LONG_STEPS).astype(np.int32))
    if mesh is not None:
        params = SD.place(params, SD.to_shardings(SD.param_pspecs(cfg, params, mesh), mesh))
        specs = SD.cache_pspecs(cache, mesh)
        layers = SD.place(dict(enumerate(cache)), SD.to_shardings(dict(enumerate(specs)), mesh))
        cache = [layers[i] for i in range(len(specs))]
    out = []
    with implicit_replication():
        for i, pos in enumerate(range(LONG_S - LONG_STEPS, LONG_S)):
            tok = {"token": tokens[i:i + 1]}
            if mesh is not None:
                tok = SD.place(tok, SD.to_shardings(SD.batch_pspecs(tok, mesh), mesh))
            logits, cache = model.decode_step(cfg, params, tok["token"], pos, cache,
                                              dtype=torch.float32)
            # copies: a plain cache is written in place by the next step
            out.append({"logits": _full({"l": logits})["l"].copy(),
                        "cache": {k: v.copy() for k, v in _full(dict(enumerate(cache))).items()},
                        "placements": [str(lc[n].placements) for lc in cache for n in ("k", "v")
                                       if isinstance(lc.get(n), DTensor)]})
    return out


def long(rank, world, archs):
    """Each arch's batch-1 decode on a (2, 2) ("data", "model") mesh under
    the dry run's policy, and rank 0's unsharded twin."""
    mesh = make_mesh((2, 2), ("data", "model"), CPU)
    policy = {"dp": ("data",), "tp": "model", "moe_groups": 2}
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        from repro_torch.models.registry import get_model

        params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), CPU)
        with use_mesh(mesh), PS.use_policy(policy), torch.no_grad():
            res = {"sharded": _long_decode(cfg, params, 3, mesh)}
        if rank == 0:
            with PS.use_policy(policy), torch.no_grad():
                res["plain"] = _long_decode(cfg, params, 3)
        out[arch] = res
    return out if rank == 0 else {}
