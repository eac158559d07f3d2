"""The multichip dry run (counterpart of `__graft_entry__.py:56-143
dryrun_multichip`): one full distillation step of the 2.0.0-rc.0 chain
with data- and tensor-parallel shardings, then the serving configuration's
engine tick (bf16, int8 slot bank and codebook), on an n-rank
('streams', 'model') mesh, model 2 where n is even.  Both are compiled by
default, as the JAX dry run jits its tick (`__graft_entry__.py:138`),
wherever `graphs.resolve_jit` compiles them: on the card, the ranks are
NCCL ranks, one a card, whose collectives the graphs hold."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import V20RC0
from ..device import resolve_device
from ..models import chain
from ..runtime.engine import EngineConfig, StreamEngine, TickStep
from ..runtime.offline import ConversionSettings, build_cond
from ..speakers import bank as bank_mod
from ..training import distill
from .mesh import (P, axis_sizes, gather_tree, make_mesh, params_sharding, shard_tree,
                   spawn_cpu_ranks, spawn_nccl_ranks, state_sharding)


def dryrun_rank(rank, n_devices: int, device="cuda") -> dict:
    """One rank of the dry run (under an n_devices-rank group).  Returns the
    step's loss, the gathered tick output's shape and whether it is
    finite, and which of the step and the tick ran compiled."""
    dev = resolve_device(device)
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices // model_par, model_par, device_type=str(dev))
    cfg = chain.VoiceConverterConfig.for_version(V20RC0)
    params = chain.init(torch.Generator().manual_seed(0), cfg, dev)
    bank = bank_mod.random_bank(torch.Generator().manual_seed(1), V20RC0, 4, device=dev)
    b, t = axis_sizes(mesh)["streams"] * 2, 2  # 2 streams per data shard
    batch = {"audio16": torch.zeros((b, t * 160), device=dev),
             "target24": torch.zeros((b, t * 240), device=dev),
             "cond": build_cond(None, cfg, bank, ConversionSettings(), b, raw_kv=True)}
    batch = shard_tree(batch, state_sharding(batch, mesh), mesh)
    p = distill.trainable(
        shard_tree(params, params_sharding(params, mesh, model_parallel=model_par > 1), mesh),
        dev)
    opt = distill.make_optimizer(p)
    _, _, metrics = distill.train_step(p, opt, batch, cfg=cfg, mesh=mesh)

    # the serving configuration's tick under the same mesh
    ecfg = EngineConfig.realtime(b, V20RC0, compute_dtype="bfloat16")
    # jit=False: only the stream table and the state are borrowed; the tick
    # below is the TickStep on this rank's rows
    eng = StreamEngine(ecfg, params, bank, device=dev, jit=False)
    for _ in range(b):
        eng.admit()
    eng.flush_controls()
    shardings = state_sharding(eng.state, mesh, capacity=ecfg.capacity)
    state = shard_tree(eng.state, shardings, mesh)
    sparams = shard_tree(eng.params, params_sharding(eng.params, mesh,
                                                     model_parallel=model_par > 1), mesh)
    x = shard_tree(torch.zeros((b, 480), device=dev), P("streams", None), mesh)
    tick = TickStep(sparams, eng.bank, state, cfg=ecfg, mesh=mesh)
    out = gather_tree(tick(x), P("streams", None), mesh)
    return {"mesh": {"streams": axis_sizes(mesh)["streams"], "model": model_par},
            "loss": float(metrics["loss"]), "tick_shape": tuple(out.shape),
            "tick_finite": bool(torch.isfinite(out).all()),
            "compiled": {"train_step": distill.resolve_step_jit(None, mesh, model_par > 1),
                         "tick": tick.compiled}}


def dryrun_multichip(n_devices: int, device="cuda", shared_card: bool = False) -> list:
    """Run the dry run on n_devices ranks and raise unless every rank's
    loss and tick are finite.  On the card (the default) the ranks are
    NCCL ranks, rank r on card r (`spawn_nccl_ranks`); where the machine
    has fewer cards than ranks this raises, unless the caller asks for
    gloo ranks that share card 0 (`shared_card`; their collective-holding
    steps then run eagerly, `graphs.resolve_jit`).  On the CPU they are
    gloo ranks (`spawn_cpu_ranks`).  Returns each rank's `dryrun_rank`
    result."""
    cuda = resolve_device(device).type == "cuda"
    if cuda and not shared_card:
        results = spawn_nccl_ranks(n_devices, dryrun_rank, n_devices, device)
    else:
        results = spawn_cpu_ranks(n_devices, dryrun_rank, n_devices, device)
    for r, res in enumerate(results):
        if not (np.isfinite(res["loss"]) and res["tick_finite"]):
            raise RuntimeError(f"dryrun_multichip: rank {r} gave {res}")
    print(f"dryrun_multichip ok: mesh={results[0]['mesh']} train+tick "
          f"(serving cfg: bf16 + int8 slots) ran on {n_devices} ranks, "
          f"compiled {results[0]['compiled']}")
    return results
