"""Two-process smoke test of the port's multi-host bring-up (counterpart of
the repo's `scripts/multihost_smoke.py`, which runs the JAX package).

    python -m beatrice_vst_tpu_torch.scripts.multihost_smoke [--device cuda] [--port P]
    python -m beatrice_vst_tpu_torch.scripts.multihost_smoke --worker N --port P   (internal)

The parent starts two interpreters with `--worker i`.  Each joins one
`torch.distributed` group through `parallel/mesh.py:distributed_init`
with an explicit coordinator address (127.0.0.1 and a free port, world
size 2, rank i), builds one ('streams', 'model') mesh over both processes
(`make_mesh(streams=2, model=1)`), shards a 2.0.0-alpha.2 real-time engine
state of 16 streams, every stream active, over it (`state_sharding`),
ticks its rows once on silence (`engine.TickStep`, compiled: one CUDA
graph on a card) and reduces sum|out| across both processes.  Each worker
prints the JAX worker's line and one JSON line (the global and local
sums, the upsampler kernel's launches by form, the backend); the parent
prints "multihost smoke OK" when both exit 0.

The JAX script runs two processes of 4 CPU devices each, a mesh of 8
devices with 2 streams a device; torch runs one device a process, so
here the mesh is 2 ranks with 8 streams a rank.  Backends: gloo on the
CPU; on a machine with one card, gloo ranks that share it (NCCL refuses
two ranks on one card); with two cards or more, NCCL, rank r on card r.
Weights: `chain.init` at seed 0 and `random_bank` at seed 1 (3 speakers),
from CPU generators, so both processes hold the same values.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N_PROC = 2
CAPACITY = 16
N_SPEAKERS = 3
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER_TIMEOUT_S = 600


def backend_for(device) -> str:
    """gloo on the CPU and for ranks sharing one card; NCCL with a card a
    rank."""
    import torch

    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= N_PROC else "gloo"


def engine_inputs(device):
    """(engine config, the tick's params and bank, a fresh state with
    every stream active, the silent input [CAPACITY, 480]) on `device`,
    the same in every process."""
    import torch

    from ..constants import V20A2
    from ..models import chain
    from ..models.io import params_from_numpy
    from ..runtime.engine import EngineConfig, cast_params, init_engine_state, prepare_bank
    from ..speakers import bank as bank_mod

    cfg = EngineConfig.realtime(CAPACITY, V20A2)
    params = chain.init(torch.Generator().manual_seed(0), cfg.model, device)
    bank = bank_mod.random_bank(torch.Generator().manual_seed(1), V20A2, N_SPEAKERS,
                                device=device)
    p = cast_params(params_from_numpy(params, device), cfg.dtype)
    b = prepare_bank(cfg, p, bank, device)
    state = init_engine_state(cfg, device)
    state["controls"]["active"][:] = True
    x = torch.zeros((CAPACITY, cfg.samples_per_tick), device=device)
    return cfg, p, b, state, x


def worker(rank: int, port: int, device: str) -> dict:
    """One process: join, shard, tick once, reduce; returns its record."""
    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    from ..models import fused_upsampler as FU
    from ..parallel import distributed_init, make_mesh, shard_tree, state_sharding
    from ..parallel.mesh import P
    from ..runtime.engine import TickStep

    torch.set_num_threads(1)  # the processes share the host's cores
    dev = resolve_device(device)
    backend = backend_for(dev)
    distributed_init(f"127.0.0.1:{port}", N_PROC, rank, backend=backend, device=dev.type)
    try:
        assert dist.get_world_size() == N_PROC
        if backend == "nccl":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(streams=N_PROC, model=1, device_type=dev.type)
        cfg, p, b, state, x = engine_inputs(dev)
        # host-local construction, then each process keeps its own rows
        state = shard_tree(state, state_sharding(state, mesh), mesh)
        x = shard_tree(x, P("streams", None), mesh)
        FU.launches = FU.launches_bf16 = 0
        tick = TickStep(p, b, state, cfg=cfg, mesh=mesh)
        out = tick(x)
        local = out.double().abs().sum()
        total = local.clone() if backend == "nccl" else local.cpu().clone()
        dist.all_reduce(total)  # the global reduction across both processes
        record = {"rank": rank, "world_size": dist.get_world_size(), "backend": backend,
                  "device": str(dev), "rows": int(out.shape[0]), "compiled": tick.compiled,
                  "sum_abs_out": float(total), "local_sum_abs_out": float(local),
                  "finite": bool(torch.isfinite(out).all()),
                  "upsampler_kernel_launches": {"float32": FU.launches,
                                                "bfloat16": FU.launches_bf16}}
        print(f"[proc {rank}] tick ok on {dist.get_world_size()} devices, "
              f"sum|out|={record['sum_abs_out']:.3f}", flush=True)
        print(json.dumps(record), flush=True)
        dist.barrier()  # no process leaves while the other may still read from it
        return record
    finally:
        dist.destroy_process_group()


def run(device="cuda", port: int | None = None) -> list:
    """Start both workers and wait for them; returns their records in rank
    order, and raises where a worker fails."""
    from ..device import resolve_device
    from ..parallel.mesh import free_port

    dev = resolve_device(device)
    port = port or free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in env.get("PYTHONPATH", "")
                                                 .split(os.pathsep) if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "beatrice_vst_tpu_torch.scripts.multihost_smoke", "--worker",
         str(i), "--port", str(port), "--device", dev.type],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True) for i in range(N_PROC)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    for out in outs:
        print("\n".join(ln for ln in out.splitlines() if ln.startswith("[proc")), flush=True)
    if any(codes):
        raise RuntimeError(f"worker failures: {codes}")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None, help="default: a free port")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.worker is not None:
        worker(args.worker, args.port, args.device)
        return 0
    run(args.device, args.port)
    print("multihost smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
