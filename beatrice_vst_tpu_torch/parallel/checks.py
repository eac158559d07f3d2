"""Rank programs that run the port's paths on a mesh and return what the
caller holds against the unsharded paths: the engine tick over
'streams' (and with the weights split over 'model'), the models' stages
under tensor parallelism, the data- and tensor-parallel training steps,
mesh-sharded seqpar and the bring-up itself.

Each `*_case` function runs on one rank of a group that `spawn_cpu_ranks`
made (or, with mesh_shape None, unsharded in the caller's process: the
reference) and returns numpy arrays and Python numbers.  `run_cases` runs
a list of them on one rank, so that one spawn serves them all.  They live
in the package, not in a test module, because a spawned rank imports the
module of the function it runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..constants import VERSIONS
from ..device import resolve_device
from ..models import chain
from ..models import fused_upsampler as FU
from ..models import phone_extractor, pitch_estimator, waveform_generator
from ..models.io import flatten_params, params_from_numpy
from ..runtime.engine import (EngineConfig, StreamEngine, cast_params, engine_tick,
                              init_engine_state, prepare_bank)
from . import collectives
from .mesh import (P, all_gather_cat, gather_tree, make_mesh, params_sharding, shard_leaf,
                   shard_tree, state_sharding)


def run_cases(rank, device, cases):
    """{name: fn(device=device, **kwargs)} for each (name, fn, kwargs) in
    `cases`, in order (every rank runs the same list).  On the card, f32
    products stay f32 (TF32 off), as in the references they are held to."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return {name: fn(device=device, **kwargs) for name, fn, kwargs in cases}


def _mesh(mesh_shape, device):
    return None if mesh_shape is None else make_mesh(*mesh_shape, device_type=str(device))


def _numpy(tree):
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.detach().cpu().numpy() for k, v in flatten_params(tree).items()}


def _whole(tree):
    """A tree with every `DTensor` all-gathered along its split axes (no
    gradient)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None or not collectives.is_sharded(node):
            return node
        with torch.no_grad():
            return collectives.gathered(node.detach())
    return walk(tree)


def _rows(tree, mesh):
    """This rank's rows of a tree of per-stream tensors (leading axis)."""
    if mesh is None:
        return tree
    return shard_tree(tree, state_sharding(tree, mesh), mesh)


def launch_counts() -> dict:
    return {"float32": FU.launches, "bfloat16": FU.launches_bf16}


def reset_launch_counts() -> None:
    FU.launches = FU.launches_bf16 = 0


# ---- the engine tick ----

def tick_case(params, bank, audio, version: str, capacity: int, mesh_shape=None,
              model_parallel: bool = False, admit=None, engine_kw=None,
              keep_state: bool = True, device="cuda"):
    """The engine on `audio` [ticks, capacity, 480]: the state and the
    weights as `StreamEngine` makes them (`admit`: None sets every stream
    active in a fresh state, as tests/test_sharding.py does; "all" admits
    every stream; "golden" runs `golden.admit_all`; a list admits one
    stream per {control: value} dict and sets its controls), then, on a mesh, the
    state split over 'streams' (`state_sharding(..., capacity)`) and with
    model_parallel the weights over 'model', and `engine_tick` on this
    rank's rows, the output gathered after each tick.  Returns the
    outputs [ticks, capacity, 480], each kernel form's launches in the
    ticks, on the card each tick's span (CUDA events) and host ms and the
    peak MiB, and with keep_state the final state, gathered."""
    dev = resolve_device(device)
    mesh = _mesh(mesh_shape, dev)
    cfg = EngineConfig.realtime(capacity, VERSIONS[version], **(engine_kw or {}))
    if admit is None:
        p = cast_params(params_from_numpy(params, dev), cfg.dtype)
        b = prepare_bank(cfg, p, bank, dev)
        state = init_engine_state(cfg, dev)
        state["controls"]["active"][:] = True
    else:
        # jit=False: only the stream table and the state are borrowed; the
        # ticks below are the functional engine_tick
        eng = StreamEngine(cfg, params, bank, device=dev, jit=False)
        if admit == "golden":
            from .. import golden

            golden.admit_all(eng)
        elif admit == "all":
            for _ in range(capacity):
                eng.admit()
        else:
            for controls in admit:
                i = eng.admit()
                for field, value in controls.items():
                    eng.set_control(i, field, value)
        eng.flush_controls()
        p, b, state = eng.params, eng.bank, eng.state
    x = torch.as_tensor(np.asarray(audio, np.float32), device=dev)
    shardings = None
    if mesh is not None:
        shardings = state_sharding(state, mesh, capacity=capacity)
        state = shard_tree(state, shardings, mesh)
        x = shard_tree(x, P(None, "streams", None), mesh)
        if model_parallel:
            p = shard_tree(p, params_sharding(p, mesh, model_parallel=True), mesh)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    outs, spans, host_ms = [], [], []
    for k in range(x.shape[0]):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t = time.perf_counter()
        out, state = engine_tick(p, b, state, x[k], cfg=cfg)
        host_ms.append((time.perf_counter() - t) * 1e3)
        if cuda:
            end.record()
            spans.append((start, end))
        outs.append(out)
    counts = launch_counts()
    if cuda:
        torch.cuda.synchronize()
    result = {"launches": counts, "host_ms": host_ms,
              "span_ms": [s.elapsed_time(e) for s, e in spans],
              "peak_mib": torch.cuda.max_memory_allocated() / 2**20 if cuda else None,
              "rows": int(outs[0].shape[0])}
    out = torch.stack(outs, 1)  # [rows, ticks, 480]
    if mesh is not None:
        out = all_gather_cat(out, 0, mesh.get_group("streams"))
        if keep_state:
            state = gather_tree(state, shardings, mesh)
    result["out"] = out.transpose(0, 1).cpu().numpy()
    if keep_state:
        result["state"] = _numpy(state)
    return result


# ---- the stages under tensor parallelism ----

def stages_case(params, audio, spk, version: str, mesh_shape=None, device="cuda"):
    """tests/test_sharding.py's per-stage gate: the phone extractor, the
    pitch estimator (with its logits) and the vocoder (T > 1: the stage
    loop) on audio [B, T*160] and speaker embeddings spk [B, hidden], f32,
    from a zero state; on a mesh the rows over 'streams' and the weights
    over 'model' (`params_sharding(..., model_parallel=True)`).  Returns
    the outputs, gathered."""
    dev = resolve_device(device)
    mesh = _mesh(mesh_shape, dev)
    cfg = chain.VoiceConverterConfig.for_version(VERSIONS[version])
    p = params_from_numpy(params, dev)
    x = torch.as_tensor(np.asarray(audio, np.float32), device=dev)
    s = torch.as_tensor(np.asarray(spk, np.float32), device=dev)
    state = chain.init_state(cfg, (x.shape[0],), dev)
    if mesh is not None:
        p = shard_tree(p, params_sharding(p, mesh, model_parallel=True), mesh)
        x, s, state = _rows((x, s, state), mesh)
    b = x.shape[0]
    with torch.no_grad():
        phone, _ = phone_extractor.apply(p["phone"], cfg.phone, x, state["phone"])
        qp, feats, _, logits = pitch_estimator.apply(
            p["pitch"], cfg.pitch, x, state["pitch"],
            torch.ones((b,), dtype=torch.int64, device=dev),
            torch.full((b,), cfg.pitch.pitch_bins - 1, dtype=torch.int64, device=dev),
            with_logits=True)
        wav, _ = waveform_generator.apply(p["wg"], cfg.wg, phone, qp, feats, s, state["wg"])
    out = {"phone": phone, "qp": qp, "feats": feats, "logits": logits, "wav": wav}
    if mesh is not None:
        group = mesh.get_group("streams")
        out = {k: all_gather_cat(v, 0, group) for k, v in out.items()}
    return {k: v.cpu().numpy() for k, v in out.items()}


# ---- the training steps ----

def _train_batch(cfg, bank, batch_np, dev, mesh):
    from .. import golden

    return _rows(golden.train_inputs(cfg, bank, dev, batch_np), mesh)


def _snapshot_grads(opt, into: list) -> None:
    """Keep each step's gradients (whole, as numpy, in the leaves' order)
    just before the optimizer applies them."""
    step = opt.step

    def snapped():
        into.append([collectives.gathered(p.grad).cpu().numpy().copy() for p in opt.leaves])
        step()

    opt.step = snapped


def distill_case(params, bank, batch, version: str, mesh_shape=None,
                 model_parallel: bool = False, periodicity_weight: float = 0.5,
                 lr: float = 2e-4, device="cuda"):
    """One `distill.train_step` on the batch (golden.train_batch's keys),
    data-parallel over 'streams' on a mesh and with model_parallel the
    weights split over 'model'.  Returns the loss and its terms, the
    gradients and the updated parameters (whole)."""
    from ..training import distill

    dev = resolve_device(device)
    mesh = _mesh(mesh_shape, dev)
    cfg = chain.VoiceConverterConfig.for_version(VERSIONS[version])
    p = params_from_numpy(params, dev)
    if mesh is not None:
        p = shard_tree(p, params_sharding(p, mesh, model_parallel=model_parallel), mesh)
    p = distill.trainable(p, dev)
    opt = distill.make_optimizer(p, lr)
    grads = []
    _snapshot_grads(opt, grads)
    _, _, metrics = distill.train_step(p, opt, _train_batch(cfg, bank, batch, dev, mesh),
                                       cfg=cfg, periodicity_weight=periodicity_weight,
                                       mesh=mesh)
    names = [k for k in flatten_params(_sorted_like(p))]
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(zip(names, grads[0])),
            "params": _numpy(_whole(p))}


def _sorted_like(tree):
    """The tree with dict keys sorted, so that flatten_params walks it in
    the optimizer's leaf order (`distill.tree_leaves`)."""
    if isinstance(tree, dict):
        return {k: _sorted_like(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted_like(v) for v in tree]
    return tree


def gan_case(params, bank, batch, disc, version: str, mesh_shape=None,
             model_parallel: bool = False, lr: float = 2e-4, device="cuda"):
    """One `gan.gan_train_step` (a critic step, then a generator step, each
    with the global-norm clip) on the batch, data-parallel over 'streams'
    on a mesh and with model_parallel the generator's weights split over
    'model'.  Returns both losses and the generator's terms, the gradients
    of both players and the updated parameters of both (whole)."""
    from ..training import distill, gan

    dev = resolve_device(device)
    mesh = _mesh(mesh_shape, dev)
    cfg = chain.VoiceConverterConfig.for_version(VERSIONS[version])
    g = params_from_numpy(params, dev)
    if mesh is not None:
        g = shard_tree(g, params_sharding(g, mesh, model_parallel=model_parallel), mesh)
    g = distill.trainable(g, dev)
    d = distill.trainable(disc, dev)
    gen_opt, disc_opt = gan.make_gan_optimizers(g, d, lr)
    g_grads, d_grads = [], []
    _snapshot_grads(gen_opt, g_grads)
    _snapshot_grads(disc_opt, d_grads)
    metrics = gan.gan_train_step(g, d, gen_opt, disc_opt,
                                 _train_batch(cfg, bank, batch, dev, mesh), cfg=cfg,
                                 mesh=mesh)[-1]
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g_grads": dict(zip(flatten_params(_sorted_like(g)), g_grads[0])),
            "d_grads": dict(zip(flatten_params(_sorted_like(d)), d_grads[0])),
            "g": _numpy(_whole(g)), "d": _numpy(d)}


def train_golden_case(params, bank, batch, mesh_shape, model_parallel: bool = False,
                      device="cuda"):
    """`golden.run_train` (the numbers of the train golden file, of
    2.0.0-rc.0) on a mesh."""
    from .. import golden

    dev = resolve_device(device)
    cfg = chain.VoiceConverterConfig.for_version(VERSIONS["2.0.0-rc.0"])
    return golden.run_train(cfg, params, bank, dev, batch, mesh=_mesh(mesh_shape, dev),
                            model_parallel=model_parallel)


# ---- seqpar ----

def seqpar_case(params, bank, audio, rate: float, n_segments: int, version: str = None,
                cfg=None, settings=None, mesh_shape=None, device="cuda"):
    """`convert_utterance_sp` of audio ([n] or [B, n]) at `rate`, on a mesh
    over its 'streams' axis.  Returns the output and the segment count
    whose work axis was split (or not)."""
    from ..runtime.seqpar import convert_utterance_sp

    dev = resolve_device(device)
    mesh = _mesh(mesh_shape, dev)
    cfg = cfg or chain.VoiceConverterConfig.for_version(VERSIONS[version])
    return convert_utterance_sp(params, cfg, bank, audio, rate, settings,
                                n_segments=n_segments, device=dev, mesh=mesh)


# ---- bring-up ----

def bringup_case(mesh_shape, device="cuda"):
    """What the group looks like from this rank: backend, world size, rank,
    an all-reduce of the ranks' indices, this rank's mesh coordinates, and
    the error a mesh of the wrong size raises."""
    dev = resolve_device(device)
    mesh = make_mesh(*mesh_shape, device_type=str(dev))
    total = torch.tensor([float(dist.get_rank())], device=dev)
    dist.all_reduce(total)
    try:
        make_mesh(dist.get_world_size() + 1, 1, device_type=str(dev))
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "rank": dist.get_rank(), "rank_sum": float(total),
            "coords": {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names},
            "refused": refused}



def refusal_case(device="cuda"):
    """The upsampler's conv weights under the model-parallel rules on a
    1 x n mesh: whether `shard_tree` kept them whole (and split
    `pitch_emb`), and the wrapper's error when they reach it split."""
    dev = resolve_device(device)
    mesh = make_mesh(1, dist.get_world_size(), device_type=str(dev))
    cfg = chain.VoiceConverterConfig.for_version(VERSIONS["2.0.0-rc.0"])
    wg = waveform_generator.init(torch.Generator().manual_seed(0), cfg.wg, dev)
    specs = params_sharding(wg, mesh, model_parallel=True)
    placed = shard_tree(wg, specs, mesh)
    kept = [not collectives.is_sharded(v) for p in placed["up"] for v in p["conv"].values()]
    split = [{**p, "conv": {k: shard_leaf(v, s["conv"][k], mesh) for k, v in p["conv"].items()}}
             for p, s in zip(wg["up"], specs["up"])]
    b = 2
    h = torch.zeros((b, 1, FU.HIDDEN), device=dev)
    states = [torch.zeros(s, device=dev) for s in FU.expected_shapes(b)[1]]
    src = [torch.zeros(s, device=dev) for s in FU.expected_shapes(b)[2]]
    try:
        FU.fused_upsample(*FU.head_params(split, wg["final"], torch.float32), h, states, src)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"kept_whole": all(kept), "pitch_emb_split": collectives.is_sharded(
        placed["pitch_emb"]), "refused": refused}
