"""Device mesh, sharding rules and distributed bring-up (port of
`beatrice_vst_tpu/parallel/mesh.py`).

The mesh has the JAX package's two axes:

  'streams'  data parallelism over concurrent streams (the engine's
             stream table, a training batch, seqpar's segments): every
             per-stream leaf is split into equal blocks of rows, one per
             rank of the axis, and no rank talks to another until the
             outputs are gathered.
  'model'    tensor parallelism: the weights that MODEL_PARALLEL_RULES
             match are split over the axis, and the functions that consume
             them run the collectives of `collectives.py` (JAX gets them
             from GSPMD).

One process drives one rank.  `distributed_init` joins the processes into
one `torch.distributed` group, `make_mesh` lays them out as a
('streams', 'model') `DeviceMesh`, and `shard_tree` places a tree on this
rank: a replicated leaf stays whole, a 'streams'-sharded leaf becomes this
rank's own rows (a plain tensor), a 'model'-sharded weight becomes a
`DTensor` that carries both its group and its placement -- except the
upsampler's conv weights (KEPT_WHOLE), which every model rank holds whole
for the fused head.  `gather_tree` reassembles the 'streams'-sharded
outputs, the counterpart of reading a sharded `jax.Array` back to the
host.

The rules are data: a spec (`P`) per leaf, computed from the leaf's shape
and path and from the axis sizes alone (a `DeviceMesh` or a dict), so that
they are checked leaf by leaf against the JAX package without a process
group.

`spawn_cpu_ranks` is the counterpart of `force_cpu_host_devices`: JAX fakes
n devices in one process, PyTorch runs n processes under a `gloo` group.
The ranks compute on whatever device their function puts its tensors on
(the CPU in the tests; the card in chip_smoke.py, where two ranks share
one GPU, since NCCL refuses two ranks on one device).  `spawn_nccl_ranks`
runs n processes under an NCCL group, rank r on card r: the ranks of a
machine with a card each, whose collectives a CUDA graph can capture
(`captures_collectives`; a gloo collective of CUDA tensors goes through
the host and cannot be captured).
"""

from __future__ import annotations

import os
import queue as queue_mod
import re
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device

AXES = ("streams", "model")
# seconds a spawned group may take before every rank is stopped
RANK_LIMIT_S = 120.0


class P(tuple):
    """A partition spec (the counterpart of `jax.sharding.PartitionSpec`):
    for each leading axis of a leaf, the mesh axis it is split over or
    None.  `P()` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def distributed_init(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None, device="cuda"):
    """Join this process to the group (call once per process, before any
    collective).  With `coordinator_address` ("host:port" or
    "tcp://host:port") the rendezvous is over TCP with the given world size
    and rank; without, the `env://` variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) are read.  The backend is `nccl` where the ranks run
    on `device` "cuda" (the default) and `gloo` where they run on the CPU;
    `backend="gloo"` may be asked for on CUDA, for ranks that share one
    card."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)


def backend(mesh) -> str:
    """The backend of a mesh's groups ("nccl" or "gloo"): every axis's
    group is made from the default group, with its backend."""
    return dist.get_backend(mesh.get_group(mesh.mesh_dim_names[0]))


def captures_collectives(mesh) -> bool:
    """Whether a CUDA graph can capture the collectives over this mesh's
    groups: NCCL's, which run on a CUDA stream, and no other backend's."""
    return backend(mesh) == "nccl"


# collectives issued on a stream that was capturing a CUDA graph, in this
# process: the collectives that captured graphs hold
captured_collectives = 0


def check_capture(group) -> None:
    """Call before each collective over `group`.  While this thread's
    current stream captures a CUDA graph, the collective becomes part of
    the graph: it is counted (`captured_collectives`) on an NCCL group and
    raises on any other, whose collective cannot be captured."""
    global captured_collectives
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        return
    name = dist.get_backend(group)
    if name != "nccl":
        raise RuntimeError(f"a {name!r} collective while a CUDA graph is captured: only NCCL "
                           "collectives can be captured")
    captured_collectives += 1


def make_mesh(streams: int | None = None, model: int = 1, device_type: str = "cuda"):
    """A ('streams', 'model') `DeviceMesh` over every rank of the group,
    rank-major (this rank's coordinates: `mesh.get_local_rank(axis)`).
    Raises where streams x model is not the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call distributed_init first")
    resolve_device(device_type)
    n = dist.get_world_size()
    if streams is None:
        streams = n // model
    if streams * model != n:
        raise ValueError(f"mesh {streams}x{model} != {n} devices")
    return init_device_mesh(device_type, (streams, model), mesh_dim_names=AXES)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` or of a dict of sizes."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# Weight partition rules for tensor parallelism: path regex -> spec
# (`mesh.py:86-95`).  Column-parallel on the expanding products, row-
# parallel on the contracting ones (one all-reduce per block); anything
# unmatched is replicated.
MODEL_PARALLEL_RULES = (
    (r"mlp_in/w$", P(None, "model")),
    (r"mlp_in/b$", P("model")),
    (r"mlp_out/w$", P("model", None)),
    (r"up/\d+/conv/w$", P(None, None, "model")),
    (r"up/\d+/conv/b$", P("model")),
    (r"pitch_emb$", P(None, "model")),
    (r"logits/w$", P(None, "model")),
    (r"logits/b$", P("model")),
)
# Leaves the rules split over 'model' that `shard_tree` places whole on
# every rank: the fused upsampler head runs its four stages in one kernel
# on one rank's streams and needs these weights whole, so a split would
# only be gathered again on every call.  Every model rank computes the same
# gradient for them, so they stay equal.
KEPT_WHOLE = re.compile(r"(^|/)up/\d+/conv/[wb]$")


def map_with_path(fn, tree, path=""):
    """fn(path, leaf) over nested dicts, lists and tuples, the structure
    kept; paths as `models/io.py:flatten_params` writes them ("a/b/0/w")."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _map2(fn, tree, specs, path=""):
    """fn(path, leaf, spec) over a tree and its tree of specs."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k], f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s, f"{path}/{i}" if path else str(i))
                          for i, (v, s) in enumerate(zip(tree, specs, strict=True)))
    return fn(path, tree, specs)


def _placed(path, spec):
    """The spec a leaf is placed by: its own, without 'model' for the
    leaves KEPT_WHOLE."""
    if "model" in spec and KEPT_WHOLE.search(path):
        return P(*(None if a == "model" else a for a in spec))
    return spec


def params_sharding(params, mesh, rules=MODEL_PARALLEL_RULES, model_parallel: bool = False):
    """A tree of specs for the weights (`mesh.py:113`): all replicated, or
    with model_parallel the first rule whose regex the leaf's path matches,
    where every split dimension divides by its axis (else replicated)."""
    sizes = axis_sizes(mesh)

    def rule(path, leaf):
        if not model_parallel:
            return P()
        for pattern, spec in rules:
            if re.search(pattern, path):
                if all(name is None or leaf.shape[d] % sizes[name] == 0
                       for d, name in enumerate(spec)):
                    return spec
                return P()
        return P()

    return map_with_path(rule, params)


def state_sharding(state, mesh, capacity: int | None = None):
    """Per-stream state over 'streams' (`mesh.py:143`).  The slot bank
    (`kv_slots`) and scalars replicate.  With `capacity`, the stream axis
    is the first axis whose size is the capacity, split where it divides
    (else replicated); without, the leading axis where it is at least the
    axis size and divides by it."""
    ns = axis_sizes(mesh)["streams"]

    def rule(path, leaf):
        if "kv_slots" in path.split("/") or leaf.ndim < 1:
            return P()
        if capacity is not None:
            for axis, size in enumerate(leaf.shape):
                if size == capacity and size % ns == 0:
                    spec = [None] * leaf.ndim
                    spec[axis] = "streams"
                    return P(*spec)
            return P()
        if leaf.shape[0] >= ns and leaf.shape[0] % ns == 0:
            return P("streams", *([None] * (leaf.ndim - 1)))
        return P()

    return map_with_path(rule, state)


def replicated(tree, mesh):
    """Every leaf replicated (`mesh.py:173`)."""
    return map_with_path(lambda _, __: P(), tree)


def _local_block(x, dim: int, mesh, axis: str):
    n = axis_sizes(mesh)[axis]
    rows = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * rows, rows)


def shard_leaf(leaf, spec, mesh):
    """This rank's part of one leaf under its spec: the leaf as it is when
    replicated; split over 'streams' only, this rank's block of rows as a
    plain tensor of its own; split over 'model', a `DTensor` whose local
    tensor is this rank's block."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    named = {name: d for d, name in enumerate(spec) if name is not None}
    if not named:
        return leaf
    local = leaf
    for name, d in named.items():
        local = _local_block(local, d, mesh, name)
    local = local.clone(memory_format=torch.contiguous_format)
    if "model" not in named:
        return local
    placements = [Shard(named[a]) if a in named else Replicate() for a in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False)


def shard_tree(tree, shardings, mesh):
    """This rank's part of a tree under a tree of specs (the same on every
    rank, as is the tree): `shard_leaf` of each leaf, the leaves KEPT_WHOLE
    not split over 'model'."""
    return _map2(lambda path, leaf, spec: shard_leaf(leaf, _placed(path, spec), mesh),
                 tree, shardings)


def all_gather_cat(x, dim: int, group):
    """The blocks of x on every rank of `group`, concatenated along `dim`
    in the group's rank order (no gradient)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    check_capture(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def gather_tree(tree, shardings, mesh):
    """The whole tree back on every rank: each leaf split over a mesh axis
    (a block of rows, or a `DTensor`'s local block) all-gathered along
    that axis; replicated leaves, and the leaves KEPT_WHOLE on 'model', as
    they are."""
    from torch.distributed.tensor import DTensor

    def gather(path, leaf, spec):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        for d, name in enumerate(_placed(path, spec)):
            if name is not None:
                leaf = all_gather_cat(leaf, d, mesh.get_group(name))
        return leaf

    return _map2(gather, tree, shardings)


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend_name, fn, args, results):
    """One spawned rank: join the group, run fn, report."""
    torch.set_num_threads(1)  # n ranks share the host's cores
    try:
        distributed_init(f"tcp://127.0.0.1:{port}", n, rank, backend=backend_name)
        value = fn(rank, *args)
        dist.barrier()  # no rank leaves while another may still read from it
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_cpu_ranks(n: int, fn, *args, limit_s: float = RANK_LIMIT_S):
    """Run fn(rank, *args) in n processes (the `spawn` start method) under
    one n-rank `gloo` group with a TCP rendezvous on localhost, and return
    each rank's result in rank order.  fn and args are pickled: fn must be
    importable (a module-level function of this package) and its results
    picklable.  Raises, with the rank's traceback, when a rank fails, and
    when the ranks have not all finished within limit_s seconds; every
    rank still running is then stopped."""
    return _spawn(n, "gloo", fn, args, limit_s)


def spawn_nccl_ranks(n: int, fn, *args, limit_s: float = RANK_LIMIT_S):
    """`spawn_cpu_ranks` under one n-rank NCCL group, rank r on card r
    (`distributed_init` sets its device).  Raises where this machine has
    fewer cards than ranks: NCCL refuses two ranks on one card, and there
    is no fallback to gloo (`spawn_cpu_ranks` runs ranks that share a
    card)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < n:
        raise RuntimeError(f"{n} NCCL ranks need {n} cards, one a rank; this machine has "
                           f"{cards} (spawn_cpu_ranks runs gloo ranks that share a card)")
    return _spawn(n, "nccl", fn, args, limit_s)


def _spawn(n: int, backend_name: str, fn, args, limit_s: float):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend_name, fn, args, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + limit_s
    try:
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n} ranks of {fn.__name__}: {sorted(out)} done after "
                                   f"{limit_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{fn.__name__}: rank {dead[0]} exited with "
                                       f"{procs[dead[0]].exitcode} and no report")
                continue
            if not ok:
                raise RuntimeError(f"{fn.__name__}: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(n)]
