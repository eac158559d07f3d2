"""The `jit` rule on a mesh and the compiled steps' handling of meshes, in
one process on the CPU (no spawn): `graphs.resolve_jit` for every
(device, backend, step kind, jit) combination, the refusal of jit=True for
a collective-holding step on gloo ranks on the card, `graphs.mesh_key`
keeping meshes apart, the trees of a compiled step walking a `DTensor` by
its local block (on a world-size-1 gloo group), the optimizer updating a
split leaf on its block, the NCCL spawner refusing more ranks than cards,
and `TickStep` compiled against its eager twin.  The compiled mesh steps
themselves run in the spawned groups of tests/test_torch_parallel.py and,
on the card, in tests/test_torch_cuda.py."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from beatrice_vst_tpu_torch.constants import V20A2
from beatrice_vst_tpu_torch.models import chain
from beatrice_vst_tpu_torch.parallel import mesh as mesh_mod
from beatrice_vst_tpu_torch.parallel.mesh import P, make_mesh, shard_leaf, spawn_nccl_ranks
from beatrice_vst_tpu_torch.runtime import graphs
from beatrice_vst_tpu_torch.runtime.engine import (EngineConfig, TickStep, cast_params,
                                                   init_engine_state, prepare_bank)
from beatrice_vst_tpu_torch.speakers import bank as bank_mod
from beatrice_vst_tpu_torch.training import distill

torch.set_num_threads(1)


class FakeMesh:
    """What resolve_jit and mesh_key read of a `DeviceMesh`: its device
    type, axes, layout of ranks and this rank's coordinates; its backend
    through the patched `parallel/mesh.py:backend`."""

    mesh_dim_names = ("streams", "model")

    def __init__(self, device_type="cuda", backend="gloo", shape=(2, 1), coordinate=(0, 0)):
        self.device_type, self.backend, self.coordinate = device_type, backend, coordinate
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.shape = shape

    def get_group(self, name):
        return (self, name)

    def get_coordinate(self):
        return list(self.coordinate)


@pytest.fixture
def fake_backend(monkeypatch):
    monkeypatch.setattr(mesh_mod, "backend", lambda m: m.backend)


def _rule(device, backend, collectives, jit):
    """The rule as stated in `resolve_jit`'s docstring: True (compiled),
    False (eager) or "raises"."""
    if jit is False:
        return False
    if device == "cuda" and backend == "gloo" and collectives:
        return "raises" if jit else False
    return True


@pytest.mark.parametrize("jit", [None, True, False])
@pytest.mark.parametrize("collectives", [False, True], ids=["no_collectives", "collectives"])
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_jit_rule_on_a_mesh(fake_backend, device, backend, collectives, jit):
    want = _rule(device, backend, collectives, jit)
    mesh = FakeMesh(device, backend)
    if want == "raises":
        with pytest.raises(RuntimeError, match="'gloo' group on CUDA"):
            graphs.resolve_jit(jit, mesh, collectives=collectives)
    else:
        assert graphs.resolve_jit(jit, mesh, collectives=collectives) is want


@pytest.mark.parametrize("jit", [None, True, False])
def test_jit_rule_without_a_mesh(jit):
    for collectives in (False, True):
        assert graphs.resolve_jit(jit, None, collectives=collectives) is (jit is not False)


def test_refusal_names_the_backend_and_the_step(fake_backend):
    with pytest.raises(RuntimeError) as e:
        graphs.resolve_jit(True, FakeMesh("cuda", "gloo"), collectives=True)
    assert "'gloo'" in str(e.value) and "issues collectives" in str(e.value)
    assert "spawn_nccl_ranks" in str(e.value)


def test_mesh_key_differs_between_meshes(fake_backend):
    """The backend, the layout of the ranks and this rank's coordinates
    each key a step apart; the same mesh seen twice keys it alike."""
    base = FakeMesh("cuda", "nccl", (2, 1), (0, 0))
    others = [FakeMesh("cuda", "gloo", (2, 1), (0, 0)),
              FakeMesh("cuda", "nccl", (1, 2), (0, 0)),
              FakeMesh("cuda", "nccl", (2, 1), (1, 0))]
    key = graphs.mesh_key(base)
    assert key == graphs.mesh_key(FakeMesh("cuda", "nccl", (2, 1), (0, 0)))
    assert graphs.mesh_key(None) is None
    assert len({key, *(graphs.mesh_key(m) for m in others)}) == 4


def test_spawn_nccl_ranks_refuses_more_ranks_than_cards():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"{cards + 1} NCCL ranks need {cards + 1} cards"):
        spawn_nccl_ranks(cards + 1, print)


@pytest.fixture
def one_rank_mesh():
    """A 1 x 1 mesh on a world-size-1 gloo group in this process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_trees_walk_a_dtensor_by_its_block(one_rank_mesh):
    """`tensors`, `identity`, `signature`, `clone_tree` and `copy_tree_`
    reach a split weight's local block, the same object on every call."""
    w = shard_leaf(torch.arange(6.0).reshape(2, 3), P(None, "model"), one_rank_mesh)
    tree = {"w": w, "b": torch.ones(2)}
    block = graphs.block(w)
    assert type(block) is torch.Tensor and block is graphs.block(w)
    assert graphs.tensors(tree)[0] is block
    assert graphs.identity(tree) == (id(block), id(tree["b"]))
    assert graphs.signature(tree) == graphs.signature(graphs.clone_tree(tree))
    assert graphs.signature(tree) != graphs.signature({"w": block, "b": tree["b"]})
    clone = graphs.clone_tree(tree)
    assert type(clone["w"]) is type(w) and graphs.block(clone["w"]) is not block
    assert clone["w"].placements == w.placements
    graphs.copy_tree_(clone, {"w": w * 0 + 5.0, "b": torch.zeros(2)})
    assert graphs.block(clone["w"]).eq(5.0).all() and block.eq(torch.arange(6.0).reshape(
        2, 3)).all()


def test_optimizer_updates_a_split_leaf_on_its_block(one_rank_mesh):
    """AdamW runs over the leaves' blocks: a split leaf's step, read from
    its gradient's block, is the step of the same values held whole."""
    values = torch.linspace(-1.0, 1.0, 6).reshape(2, 3)
    grad = torch.linspace(0.5, -0.25, 6).reshape(2, 3)
    split = distill.trainable({"w": shard_leaf(values, P(None, "model"), one_rank_mesh)}, "cpu")
    whole = distill.trainable({"w": values}, "cpu")
    for params in (split, whole):
        opt = distill.make_optimizer(params, 1e-2)
        assert opt.blocks[0] is graphs.block(params["w"])
        params["w"].grad = (grad if params is whole
                            else shard_leaf(grad, P(None, "model"), one_rank_mesh))
        opt.step()
        assert params["w"].grad is None and opt.blocks[0].grad is None
    torch.testing.assert_close(graphs.block(split["w"]).detach(), whole["w"].detach(),
                               rtol=0, atol=0)
    assert not torch.equal(whole["w"].detach(), values)


def test_tick_step_compiled_equals_eager():
    """`TickStep` with jit None (on the CPU the donated tick op by op over
    its static input) against jit=False (engine_tick, the state rebound),
    over three ticks: outputs and states bitwise."""
    cfg = EngineConfig.realtime(4, V20A2)
    params = cast_params(chain.init(torch.Generator().manual_seed(0), cfg.model, "cpu"),
                         cfg.dtype)
    bank = prepare_bank(cfg, params, bank_mod.random_bank(torch.Generator().manual_seed(1),
                                                          V20A2, 3, device="cpu"), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 4, 480)).astype(
        np.float32) * 0.1)
    runs = {}
    for jit in (None, False):
        state = init_engine_state(cfg, "cpu")
        state["controls"]["active"][:] = True
        tick = TickStep(params, bank, state, cfg=cfg, jit=jit)
        assert tick.compiled is (jit is None) and tick.warmup_ticks == 0
        outs = [tick(x[k]) for k in range(3)]
        assert (tick.state is state) is (jit is None)
        runs[jit] = (torch.stack(outs), graphs.tensors(tick.state))
    assert float(runs[False][0].abs().max()) > 0
    torch.testing.assert_close(runs[None][0], runs[False][0], rtol=0, atol=0)
    for a, b in zip(*(runs[j][1] for j in (None, False)), strict=True):
        assert torch.equal(a, b)
