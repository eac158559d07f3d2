"""Compiled steps: the port's counterpart of `jax.jit`'s compile and cache.

The JAX package jits every hot path: the engine tick
(`runtime/engine.py`), offline conversion (`runtime/offline.py:108-123`),
the sequence-parallel passes (`runtime/seqpar.py:103,119`), parity's
streaming tick (`parity.py:97`) and the training steps
(`training/distill.py:187`, `gan.py:109`, `feature_distill.py:103,128,170`,
`loop.py:35`).  The port's counterpart is a `CompiledStep`: a function
over static tensors (inputs that the caller copies in before each call,
state that the step writes in place, parameters that it reads), captured
once on CUDA in a `torch.cuda.CUDAGraph` and replayed, so that one host
launch replaces the step's hundreds to thousands.  On the CPU, where CUDA
graphs do not exist, a compiled step runs op by op over its static
tensors: the same operations on the same values as its eager twin.

`StepCache` keeps compiled steps, keyed as jit's cache is, by the static
arguments and the inputs' shapes and dtypes (`signature`), and also by the
identity of the tensors a step reads without copying them in (`identity`):
a graph reads its parameters at their capture-time addresses, so another
model's tensors, even of the same shapes, get a step of their own.  The
entry holds those tensors, so an identity in a live key is never reused.
The cache is bounded (least recently used out first), so that one-off
shapes do not pin their graphs' memory for ever.

`resolve_jit` gives the entry points' `jit` flag its meaning, on a mesh
as well as without one; `mesh_key` puts a step's mesh into its key.  A
tree's `DTensor` leaves (weights split over 'model') are walked by their
local blocks (`block`): a step reads and writes the block, and is keyed by
it.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import gc
import threading
import time

import torch

from ..device import count_replay, pinning, recording_launches, recording_marks
from ..parallel.collectives import is_sharded

# calls of a step on scratch tensors before its CUDA graph is captured:
# they build every constant the step makes at its first call (resampler
# filters, mel bases, cuBLAS handles, cuFFT plans, the kernel's
# shared-memory attribute), whose copies from the host could not be
# captured
GRAPH_WARMUP_CALLS = 2
# compiled steps a StepCache keeps
CACHE_SIZE = 8


def resolve_jit(jit: bool | None, mesh=None, *, collectives: bool = False) -> bool:
    """Whether an entry point runs its compiled step.

    `jit=False` is the eager twin.  `jit=None` is compiled wherever a CUDA
    graph can hold the step: without a mesh; on a mesh on the CPU (a
    compiled step runs op by op over its static tensors there); on a mesh
    on CUDA where the step's body issues no collective (`collectives`
    False: the stream-sharded tick with replicated weights, seqpar's
    passes, whose gathers stay outside the graph); on a mesh on CUDA whose
    groups are NCCL groups, whose collectives a graph captures
    (`parallel/mesh.py:captures_collectives`).  It is eager in one case
    only: a step whose body issues a collective (the tensor-parallel
    tick, a training step with a 'streams' group or split weights), on a
    gloo group, on CUDA -- gloo runs a collective of CUDA tensors through
    the host, which no graph can hold.  `jit=True` in that case raises; it
    never runs eagerly."""
    if jit is False:
        return False
    if mesh is None or not collectives or mesh.device_type != "cuda":
        return True
    from ..parallel.mesh import backend, captures_collectives

    if captures_collectives(mesh):
        return True
    if jit:
        raise RuntimeError(
            f"jit=True: this step issues collectives over the mesh's {backend(mesh)!r} "
            "group on CUDA, and a CUDA graph cannot capture a gloo collective (gloo "
            "copies CUDA tensors through the host); run NCCL ranks, one per card "
            "(parallel/mesh.py:spawn_nccl_ranks), or pass jit=None or jit=False for the "
            "eager step")
    return False


def mesh_key(mesh) -> tuple | None:
    """The part of a compiled step's key that names its mesh: the groups'
    backend, the ranks of the mesh in its layout and this rank's
    coordinates, so that a step captured on one mesh is never replayed on
    another (None without a mesh)."""
    if mesh is None:
        return None
    from ..parallel.mesh import backend

    return (backend(mesh), tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()), tuple(mesh.get_coordinate()))


# ---- trees of tensors: dicts, lists and tuples, walked in their order ----

def leaves(tree) -> list:
    """Every leaf of nested dicts, lists and tuples, in their order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def block(x):
    """A tensor leaf as a step reads and writes it: a `DTensor` (a weight
    split over 'model') by its local block, the tensor that holds this
    rank's values (the same object on every call); any other as it is."""
    if is_sharded(x):
        with torch.no_grad():
            return x.to_local()
    return x


def tensors(tree) -> list:
    """The tensor leaves of a tree, in its order, each by its `block`."""
    return [block(x) for x in leaves(tree) if isinstance(x, torch.Tensor)]


def signature(tree):
    """The tree's structure with each tensor's shape, dtype and device and
    every other leaf's value: jit's cache key of the arguments it traces."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(signature(v) for v in tree)
    if is_sharded(tree):
        return ("dtensor", tuple(tree.shape), tuple(tree.placements),
                signature(block(tree)))
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, str(tree.device))
    return tree


def identity(*trees) -> tuple:
    """The identity of every tensor of the trees: the key of the tensors
    a step reads at their addresses."""
    return tuple(id(t) for tree in trees for t in tensors(tree))


def clone_tree(tree):
    """The tree with every tensor cloned (other leaves shared); a
    `DTensor` by its block, on the same mesh and placements."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if is_sharded(tree):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(block(tree).clone(), tree.device_mesh, tree.placements,
                                  run_check=False, shape=tree.shape, stride=tree.stride())
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def copy_tree_(dst, src) -> None:
    """Copy every tensor of `src` into the same tensor of `dst`, in place."""
    d, s = tensors(dst), tensors(src)
    if len(d) != len(s):
        raise ValueError(f"copy into a tree of {len(d)} tensors from one of {len(s)}")
    torch._foreach_copy_(d, s)


def zero_tree_(tree) -> None:
    torch._foreach_zero_(tensors(tree))


def changed_leaves(old, new, dst, src) -> None:
    """Append to dst / src each leaf of `old` and the leaf of `new` that
    replaces it, where a step made a new tensor; subtrees and leaves it
    passed through (the same objects) are skipped."""
    if new is old:
        return
    if isinstance(old, dict):
        if old.keys() != new.keys():
            raise ValueError(f"the step changed the state's keys: {sorted(old)} -> {sorted(new)}")
        for k in old:
            changed_leaves(old[k], new[k], dst, src)
    elif isinstance(old, list):
        if len(old) != len(new):
            raise ValueError(f"the step changed a state list's length: {len(old)} -> {len(new)}")
        for o, n in zip(old, new):
            changed_leaves(o, n, dst, src)
    else:
        if new.shape != old.shape or new.dtype != old.dtype:
            raise ValueError(f"the step changed a state leaf: {tuple(old.shape)} {old.dtype} -> "
                             f"{tuple(new.shape)} {new.dtype}")
        dst.append(block(old))
        src.append(block(new))


def write_back_(state, new) -> None:
    """Donate `state` (jit's `donate_argnums`): write the new state a step
    returned into `state`'s own tensors, which stay the same objects.
    Only the leaves the step replaced are copied; a new leaf that shares
    memory with a leaf being written is copied aside first, so no copy
    reads what another has overwritten."""
    dst, src = [], []
    changed_leaves(state, new, dst, src)
    written = {t.untyped_storage().data_ptr() for t in dst}
    src = [t.clone() if t.untyped_storage().data_ptr() in written else t for t in src]
    torch._foreach_copy_(dst, src)


def _device(tree) -> torch.device:
    ts = tensors(tree)
    if not ts:
        raise ValueError("a compiled step needs a tensor among its arguments")
    return ts[0].device


# graphs being captured in this process, and whether automatic garbage
# collection was on before the first of them (`_collection_paused`)
_captures = 0
_collection_was_on = False
_captures_lock = threading.Lock()


@contextlib.contextmanager
def _collection_paused():
    """Automatic garbage collection off while a graph is captured: a
    collection then may free an older graph held in a reference cycle,
    whose reset is not permitted while a stream captures and invalidates
    the capture.  (`torch.cuda.graph` collects once as it opens.)"""
    global _captures, _collection_was_on
    with _captures_lock:
        if _captures == 0:
            _collection_was_on = gc.isenabled()
            gc.disable()
        _captures += 1
    try:
        yield
    finally:
        with _captures_lock:
            _captures -= 1
            if _captures == 0 and _collection_was_on:
                gc.enable()


class CompiledStep:
    """`step(*args)` over the static tensors of `args`, which the step
    reads and may write in place (its donated state); the caller copies
    new inputs into them before each call.

    On CUDA the step is captured once, here: GRAPH_WARMUP_CALLS calls on
    `warmup_args` (scratch copies of the state it writes; by default
    `args` themselves, for a step that writes only its outputs) on a side
    stream, then the capture with `capture_error_mode="thread_local"`
    (other threads' CUDA work goes on: a ModelHost builds a new engine
    while the old one ticks), inside `device.recording_launches()` (the
    counted kernel launches the graph holds) and `device.pinning()` (the
    cached constants it reads, which it keeps alive), with automatic
    garbage collection off (`_collection_paused`).  A failed warm-up or
    capture raises.  Each call replays the graph, counts its kernel
    launches (`device.count_replay`) and returns the step's outputs, which
    the next call overwrites.  `capture_ms` is the host's time for the
    warm-up and the capture, the graph's instantiation included.

    On the CPU each call runs the step op by op over `args`."""

    def __init__(self, step, args: tuple, *, warmup_args: tuple | None = None):
        self.step, self.args = step, tuple(args)
        self.device = _device(self.args)
        self.graph = None
        self.outputs = None
        self.marks: list = []  # a marked twin's stage marks
        self.recorded: dict = {}
        self.pins: list = []
        self.capture_ms = 0.0
        self.replays = 0
        # the counters of the StepCache that holds this step, if any
        self.counters = None
        # held by a caller across its copies in, the call and its copies out
        self.lock = threading.Lock()
        if self.device.type == "cuda":
            self._capture(self.args if warmup_args is None else tuple(warmup_args))

    def _capture(self, warmup_args, pool=None, marks: bool = False) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            if warmup_args is not None:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(GRAPH_WARMUP_CALLS):
                        self.step(*warmup_args)
                torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            marking = (recording_marks(self.device, capture=True) if marks
                       else contextlib.nullcontext([]))
            with recording_launches() as recorded, pinning() as pins, _collection_paused():
                with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                    with marking as marks:
                        self.outputs = self.step(*self.args)
        self.graph, self.recorded, self.pins, self.marks = graph, dict(recorded), pins, marks
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def marked_twin(self) -> "CompiledStep":
        """The step captured once more over the same static tensors, with the
        stage marks it makes (`device.mark`) as event-record nodes of the
        graph, in the twin's `marks`: without warm-up (this step's built
        every constant it reads) and in this graph's memory pool, which is
        safe as a caller replays the one or the other on its stream, never
        both at once, and neither keeps an intermediate across replays."""
        twin = copy.copy(self)
        twin.replays = 0
        twin._capture(None, pool=self.graph.pool(), marks=True)
        return twin

    def __call__(self):
        self.replays += 1
        if self.counters is not None:
            self.counters["replays"] += 1
        if self.graph is None:
            return self.step(*self.args)
        self.graph.replay()
        count_replay(self.recorded)
        return self.outputs


class StepCache:
    """Compiled steps by key, at most `maxsize` of them, the least
    recently used dropped first (its graph's memory goes back to the
    allocator once nothing else holds the step).  `counters`: captures
    (steps built: captured on CUDA, static tensors made on the CPU), hits,
    replays (calls of the cached steps) and evictions."""

    def __init__(self, maxsize: int = CACHE_SIZE):
        if maxsize < 1:
            raise ValueError(f"StepCache maxsize {maxsize} < 1")
        self.maxsize = maxsize
        self._steps: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.counters = {"captures": 0, "hits": 0, "replays": 0, "evictions": 0}

    def get(self, key, build) -> CompiledStep:
        """The step of `key`, built by `build()` at its first use."""
        with self._lock:
            step = self._steps.get(key)
            if step is not None:
                self._steps.move_to_end(key)
                self.counters["hits"] += 1
                return step
            step = build()
            step.counters = self.counters
            self._steps[key] = step
            self.counters["captures"] += 1
            while len(self._steps) > self.maxsize:
                self._steps.popitem(last=False)
                self.counters["evictions"] += 1
            return step

    def clear(self) -> None:
        with self._lock:
            self._steps.clear()

    def steps(self) -> list:
        """The cached steps, the least recently used first."""
        with self._lock:
            return list(self._steps.values())

    def __len__(self) -> int:
        return len(self._steps)

    def __contains__(self, key) -> bool:
        return key in self._steps


# the process's compiled steps, as jit's cache is the process's
CACHE = StepCache()


def call(key, fn, *inputs, cache: StepCache | None = None):
    """`fn(*inputs)` as a compiled step, as a jitted function is called:
    the first call of `key` with these inputs' signature builds a step
    over static copies of the inputs (captured on CUDA); every call copies
    the inputs into them, runs the step and returns its outputs cloned.
    `key` holds the static arguments and the `identity` of the tensors
    `fn` closes over."""
    cache = CACHE if cache is None else cache
    step = cache.get((key, signature(inputs)), lambda: CompiledStep(fn, clone_tree(inputs)))
    with step.lock:
        copy_tree_(step.args, inputs)
        return clone_tree(step())
