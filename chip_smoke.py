#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --nccl-ranks N   # a machine with N cards

With `--nccl-ranks N` it runs only the build and the multicard phase:
the compiled mesh steps across N NCCL ranks, one a card
(`multicard_phase`), then the card lines and the last line.  Without
it, on one card:

Phases, each printing one line with its seconds:
  1. env     -- Python, torch and CUDA versions; the card's name and power
                limit from nvidia-smi.
  2. build   -- builds every CUDA kernel of the port from csrc/ with nvcc
                (the f32 form csrc/fused_upsampler.cu, the bf16 form
                csrc/fused_upsampler_bf16.cu on the tensor cores) and the
                yardsticks they are timed against (csrc/fused_upsampler_v1.cu,
                the f32 form's first version; the FFMA bf16 form in
                csrc/fused_upsampler.cu), one nvcc each, all at once; each
                source's ptxas registers and spills, and the HMMA
                (tensor-core) instructions in its SASS.
  3. kernel  -- each form of each kernel (the upsampler head in f32 and in
                bf16) against its plain PyTorch version on the card at
                B = 16, 240, 256 (the engine's capacity) and 1024, on inputs
                made with numpy from a fixed seed: max |d|; the kernel's
                device time with L2 warm and with L2 cold (128 MiB written
                before each launch, not timed), from CUDA event pairs around
                launches enqueued behind a device sleep so that the host
                never sets the pace; the wrapper's host time per call; the
                plain version's device time; the bound; occupancy.  Each
                form's yardstick is checked too and timed against it, warm
                and cold, in the order yardstick, form, form, yardstick: the
                f32 form's first version at B = 256, the FFMA bf16 form at
                every B.  Then, untimed, max |d| at the other batches the
                phases below launch it at (4, 6, 8 and 64: the golden runs
                and the serving phases; all but 64 are partial tiles of 16
                streams).
  4. graph   -- one line per configuration: the compiled tick (StreamEngine's
                default jit=True, one CUDA graph replayed per tick) against
                the eager tick (jit=False) at capacity 256, T = 1, TICKS
                ticks of the same audio in turns, each tick's outputs within
                1e-6 (0 expected), one launch of the form per tick of each
                (replays counted), median and p90 span, host ms per tick,
                the capture's host ms, each engine's peak MiB while built.
                After every timed engine phase, graph_profile: device
                kernels and host launch calls per tick of each under
                torch.profiler.  Every phase below ticks through the graph
                unless it says otherwise; an engine's GRAPH_WARMUP_TICKS
                warm-up ticks launch the form once each, and the serving
                checks count them.  Offline conversion, seqpar, parity's
                streaming half and the trainers run their compiled steps
                (runtime/graphs.py, the default) in every phase below
                unless it says jit=False.
  5. engine  -- one line per configuration (ENGINE_CONFIGS: per-stream f32;
                the JAX default, slot bank and shared-bank VQ in f32; and
                bf16 with the int8 slot bank and codebook): the port's
                StreamEngine at capacity 256 on the card with the klatt8
                weights (models_demo/klatt8), TICKS ticks of a swept sine
                plus noise, with the launch counts set to 0 just before
                and read just after; every output finite and not silent,
                the configuration's kernel form launched once per tick and
                the other form never; the first 20 ticks again through an
                engine forced onto the plain upsampler, compared; median
                and p90 tick, host ms per tick, peak memory.  Then the
                golden run (4 streams x 20 ticks, beatrice_vst_tpu_torch/
                golden.py) held to the JAX engine's output in
                tests/data/torch_engine_golden.npz: f32 at atol 1e-3, bf16
                by the envelope.
  6. morph   -- one line per configuration: the engine at capacity 256 with
                every odd stream morphing (target 8, its own weights over
                klatt8's 8 speakers from a numpy seed, pruned on the card
                by ops/morph; in slots mode 16 streams lease the 16 morph
                slots and the others read their dominant speaker's base
                slot): the refresh (flush_controls of the staged morph
                controls) between CUDA events, twice; MORPH_TICKS ticks with
                the launch counts set to 0 just before and read just after,
                the kernel form once per tick; every output finite, no
                stream silent; the direct engine's ticks in the same run
                (half before, half after); the first 20 morph ticks against
                a plain-upsampler engine; median and p90 tick, host ms,
                the memory live before the ticks (every engine in the
                process) and the ticks' peak above it; the morph golden run (golden.run_morph)
                against tests/data/torch_morph_golden.npz (f32 at 1e-3,
                bf16 by the envelope).  Then, once every configuration is
                timed, morph_profile: device launches per tick (morph and
                direct) and the lottery's own under torch.profiler, and the
                direct ticks timed again after the profiler ran; and
                morph_offline: convert_utterance with morph weights against
                the golden file at 1e-3.
  7. parity  -- the port's run_parity (beatrice_vst_tpu_torch/parity.py) on
                klatt8, slots f32, capacity 256: one tick of 25 frames
                (the stage loop) against 25 real-time ticks (the f32
                kernel), max |d| <= 1e-3, the f32 kernel launched 25
                times in the streaming half and never in the chunk tick;
                each half's span per 10 ms of audio, host ms and peak
                memory, run twice (the first warms up).  Then the engine
                at frames_per_tick = 25, graph and eager in turns:
                CHUNK_TICKS ticks with CUDA events (each tick's outputs
                within 1e-6; median and p90 tick, host ms per tick), and a
                few ticks of each under torch.profiler (device launches,
                host launch calls and device-busy ms per tick).
  8. offline -- runtime/offline.py:convert_utterance on klatt8 (f32, chunks
                of 64 frames) of golden.offline_signal (1.5 s at 44.1 kHz
                in and out) held to tests/data/torch_offline_golden.npz
                (the JAX package's output) at atol 1e-3; audio seconds
                converted per second, on the second of two runs.
  9. versions -- 2.0.0-alpha.2 and 2.0.0-beta.1 on random parameters and
                banks from the port's chain.init and random_bank at fixed
                seeds, capacity 256: the kernel engine against the
                plain-upsampler engine over 20 ticks at 1e-4, the f32 form
                launched once per tick; then run_parity at 25 frames at
                1e-3.
 10. serve_golden -- the port's ModelHost(capacity=4, realtime=False) on
                klatt8 through the serving scenario of golden.run_serve
                (four sessions at 48, 44.1, 16 and 32 kHz in odd push
                sizes, voices, shifts, a two-voice morph set through the
                morph pad's parameters, a session opened and closed mid-run,
                a gain edit staged with reset_context), ticked by hand:
                every pull within atol 1e-3 of tests/data/
                torch_serve_golden.npz (the JAX ModelHost's run), the f32
                form launched once per tick, no recovery, no last_error.
 11. serve_pipeline -- the same with pipeline=True: each pull equal to
                serve_golden's one tick earlier (max |d| <= 1e-6); then
                pipeline mode with only row 0 live at capacity 8.
 12. serve_tcp -- `python -m beatrice_vst_tpu_torch.cli serve --model
                models_demo/klatt8 --capacity 64` in a subprocess, in f32
                and with --dtype bfloat16: 8 VCClients on their own threads
                at 48, 44.1 and 16 kHz, each with a voice and a pitch shift
                (one in a morph through the morph pad's parameters), each
                pushing 3 s of a seeded swept sine plus noise in 10 ms
                blocks at real-time pace and pulling until its audio is
                back (90 %, or nothing new for 1 s).  Gates: every client
                receives audio, finite and not silent; the metrics op shows ticks,
                the form's kernel launches equal to them (within the one
                tick that may run between the two reads), no recovery and
                no last_error; no traceback on the server's stderr; the
                server exits 0 on SIGTERM.  Reported: the scheduler's median
                and p90 tick span (and its median over the first 50 ticks,
                before the clients come), ticks per second while the clients run (100 is real
                time), underruns and drops, each client's time to first
                audio and share of its audio returned.
 13. serve_ws -- an in-process WSServer (port 0) over a realtime ModelHost
                on klatt8 with one WSClient: a round trip, a model swap to
                models_demo/klatt8_r6 through set_parameter("model", ...),
                the controls replayed into the new engine equal to those
                before (read from the engines' control rows), audio after
                the swap; the f32 form's launches equal to both engines'
                ticks, no recovery, no last_error, the scheduler alive
                before stop().
 14. soak   -- the long-stream soak (beatrice_vst_tpu_torch/scripts/
                long_stream_soak.py) for one minute a leg, with the launch
                counts set to 0 before each: leg a (2 streams, the compiled
                T = 1 engine against the compiled T = 600 engine, window
                by window, and stream 0 against the float64 oracle over the
                minute) and leg b (256 streams, slots f32, T = 1 against
                T = 100, no oracle).
                Raises on any failed gate (state bounded; stream vs chunk
                within the drift budget and the 1e-2 spectral gate; oracle
                within 2e-3; a pitch or VQ flip between the two paths
                within 1e-5 is a tie and holds its stream, as the soak
                does) and unless the f32 form launched once a T = 1 tick
                and warm-up tick (a flip's replay included) and never in
                a chunk.  Reported: each leg's per-minute numbers, its
                flips and ticks per second of each path.
 15. latency -- the client latency probe (beatrice_vst_tpu_torch/scripts/
                latency_probe.py): 4 sessions on a ModelHost of capacity
                8, 10 s at 10 ms pacing; raises if its burst detection
                ratio is at most 0.9 or the f32 form's launches differ from
                the engine's ticks and warm-up ticks.  Reported: the burst
                latency's p50 / p90 / p99, the pacing, the scheduler's
                ticks a second, whether the pace was kept.
 16. train_golden -- one distillation step and one GAN step (and each
                one's second step, after the update) on klatt8 at full
                width, f32, TF32 off, on the batch stored in
                tests/data/torch_train_golden.npz with the critics of
                golden.disc_params: each loss within 1e-4 relative of the
                JAX package's there, each parameter's gradient norm within
                1e-3 (golden.train_gate: the attention key biases, zero in
                exact arithmetic, below 1e-6; the final conv's and the
                PCD's first bias at 3e-2); the fused upsampler never
                launched.
 17. train   -- `train` and `train_gan` on klatt8 at the CLI's defaults
                (batch 8, 32 frames), 30 steps each on one batch from
                make_teacher_batcher: the loss finite and lower at the end
                than at step 0; steps and audio seconds per second, peak
                MiB above the memory live before; a run of 15 steps,
                checkpointed at its end and resumed, repeats the straight
                run's steps 15-29 within 1e-6 (deterministic algorithms on,
                cuBLAS with a fixed workspace); the fused upsampler never
                launched.
 18. train_data -- a small parallel corpus from the port's synthesis.py
                (as scripts/make_corpus.py lays it out), PairDataset and one
                batch of make_pair_batcher, then `python -m
                beatrice_vst_tpu_torch.cli train --data` for 10 steps in a
                subprocess: exit 0 and a weights.npz with klatt8's tree.
 18a. quality -- the model-quality loop's evaluation
                (beatrice_vst_tpu_torch/scripts/quality_eval.py, ood_eval.py)
                on klatt8: the held-out utterances 45 and 46 rendered as the
                seed-0 corpus holds them (make_corpus.write_renditions),
                their 12 pairs of tests/data/torch_quality_golden.json
                converted (the compiled whole-utterance steps) with and
                without soft pitch, and the first noise (20 dB) and register
                (330 Hz) rows; each row held to the golden file (the JAX
                package's on the CPU): the model-free rows exactly, the
                converted rows' MCD and LSD within 0.05 dB, voicing within
                0.02, F0 RMSE within 5 cents unless the tracker's decisions
                differ only at near-ties (quality_eval.locate_ties against
                the port's CPU conversion; reported), the pairs worse than
                do-nothing equal in count; neither form launched.
                Reported: the worst deviation per metric, the ties, the
                captures and capture ms, seconds.
 18b. train_real -- `python -m beatrice_vst_tpu_torch.scripts.
                train_real_model --resume` on a copy of klatt8 with the r6
                recipe's flags (f0 weight 4, register boost 3, periodicity
                2, soft pitch, cosine LR) at batch 16 x 64 frames, 20
                distillation and 10 GAN steps on a 4-utterance corpus of
                the port's make_corpus, in a subprocess: exit 0, finite
                losses, the JAX report's keys, neither form launched.
                Reported: each phase's steps/s, peak MiB and captures.
 19. seqpar  -- runtime/seqpar.py:convert_utterance_sp on klatt8: the golden
                signal at 4 segments against tests/data/
                torch_seqpar_golden.npz (the JAX package's) and a 20 s
                signal at 4 and 8 segments against the port's
                convert_utterance, each at atol 1e-3; audio seconds per
                second of each, on the second of two runs.
 20. offline_graph -- the compiled offline steps (runtime/graphs.py: CUDA
                graphs of the chunk step, the whole-utterance step and the
                resamplers, convert_utterance's default) against eager
                (jit=False) on klatt8: 20 s at 44.1 kHz chunked and 1.5 s
                whole, f32 and bf16, in the order eager, compiled (its
                first call captures), eager, compiled, compiled, eager:
                max |d| <= 1e-6 (0 expected), audio seconds per second of
                each, the first compiled call's seconds, captures and
                capture ms, peak MiB of each and the MiB the compiled steps
                keep; then klatt8 and klatt8_r6 (the same shapes), each
                compiled conversion equal to its own eager one.
 21. seqpar_graph -- convert_utterance_sp at 4 segments on 20 s, compiled
                (both passes and the resamplers) against eager, as above.
 22. parity_graph -- the kernel inside a compiled path: run_parity on klatt8 at
                T = 25, capacity 256, with the compiled streaming half (one
                CUDA graph over the donated tick, replayed once a frame)
                against the eager one, in the order graph, eager, eager,
                graph, the launch counts set to 0 before each run and read
                after: each report within 1e-3 and the compiled one's max
                |d| equal to the eager one's, the f32 form launched once
                per frame by the replays, twice in the capture (the
                warm-up ticks), never in the chunk tick; span per 10 ms of
                audio of each streaming half, the capture's host ms.
 23. train_graph -- `train` and `train_gan` at batch 8 x 32 frames, 8
                steps each over the same batches of the compiled teacher,
                compiled against eager under deterministic algorithms
                (every loss within 1e-4 relative), steps per second of each
                (the compiled run with and without its capture), capture
                ms, peak MiB; a compiled run checkpointed at step 4 and
                resumed repeats the straight compiled run bitwise; then
                golden.run_train through the compiled steps against the
                train golden file (golden.train_gate).
 24. feature_distill_graph -- module_step of each module (klatt8 teacher,
                a chain.init student, batch 8 x 32 frames), compiled
                against eager over 4 steps (losses within 1e-4 relative),
                step ms of each; end_to_end_error and end_to_end_error_soft
                compiled against eager.
 25. mesh_*  -- the port's parallel/ package: one 2-rank gloo group
                (parallel/mesh.py:spawn_cpu_ranks) whose ranks share the one
                card and each compute on it, every case in one spawn
                (parallel/checks.py), then:
                mesh_golden: the golden run on a 2 x 1 mesh (2 streams a
                rank), slots f32 and bf16, gathered and held to the golden
                file as the engine phase holds it; mesh_engine: capacity
                256 on 2 x 1 (128 streams a rank), TICKS ticks of the
                engine phase's input and controls, gathered and held at
                KERNEL_TOL to one process ticking each rank's 128 streams
                (the same products; measured bitwise) and, over the first
                MESH_EXACT_TICKS ticks, to one process at 256 (the card
                picks its GEMM kernels by row count, so 128 and 256 rows
                round apart, and later in the 120 ticks a few streams flip
                a pitch bin: measured 3 of 256 f32, 48 bf16; reported, with
                the first tick over the tolerance); each rank's
                median and p90 tick span (CUDA events), host ms and peak
                MiB beside the process at 256's; mesh_tp: the golden run
                with the weights split over 'model' on 1 x 2 (the
                upsampler's conv weights kept whole for the fused head) and
                the train golden numbers on 1 x 2; mesh_train: the train golden numbers
                (one distillation and one GAN step and their second steps)
                data-parallel on 2 x 1, one golden row a rank; mesh_seqpar:
                convert_utterance_sp on 20 s at 5 segments ((s-1)*B = 4
                rows, 2 a rank) against the sequential conversion at 1e-3
                and the unsharded seqpar at 1e-5, and the seqpar golden
                file's 4 segments (3 rows: not split, JAX's rule) at 1e-3;
                mesh_graph (the compiled mesh steps, in the same spawn):
                the compiled stream-sharded tick at 256 on 2 x 1 against
                the eager rank tick (the mesh_engine run), gathered, max
                |d| <= GRAPH_TOL, each rank's span, host ms, host launch
                calls, capture ms and peak MiB beside the eager rank's, in
                slots f32 and bf16; the golden run compiled on 2 x 1
                against the golden file and the eager golden run; seqpar
                compiled on 2 x 1 against eager (max |d| <= GRAPH_TOL) with
                audio s/s of each.  The tensor-parallel tick and the train
                steps, whose collectives gloo runs through the host, run
                eagerly on these ranks (asserted).
                mesh_nccl: a world-size-1 NCCL group (distributed_init's
                default backend on CUDA) and a 1 x 1 mesh in this process,
                one tick of each configuration equal to the unsharded tick;
                mesh_nccl_graph in that group: the compiled
                tensor-parallel tick (1 x 1, weights split: the all-reduces
                in the graph) at 256 against its eager twin, one
                distillation and one GAN step compiled against eager
                (losses within 1e-4 relative) with steps/s of each over 6
                steps, the train golden numbers through the compiled mesh
                steps, and, after every timing, where the all-reduces sit:
                the collectives counted while capturing, c10d's host
                records of them, and one replay's device kernels under
                torch.profiler.  Every mesh path's ranks each launch the
                configuration's form once a tick and once a warm-up tick
                of a compiled tick's capture.  Two ranks on one card
                measure processes overlapping on one device, not
                multi-GPU scaling.
 26. profile -- only with `--profile DIR`: where the engine's tick time
                goes in each configuration (torch.profiler; tables and
                gzipped traces written to DIR).
Then the kernels line (each form's launches summed over every path that
drove it, a graph's replays included: the graph phases (eager and graph
engines), the engine configurations, the morph engines, the streaming
halves of parity, the older versions' engines, the in-process serving
paths serve_golden, serve_pipeline and serve_ws, the soak's T = 1
engines (soak_a, soak_b) and the latency probe's, the compiled streaming
halves of parity_graph (their replays and their captures' warm-up
ticks), and the mesh paths mesh_golden, mesh_tp, mesh_engine,
mesh_graph (replays and warm-up ticks), mesh_nccl and mesh_nccl_graph,
summed over their ranks; the phases from train_golden to
seqpar_graph (quality and train_real included) and from train_graph to
feature_distill_graph launch neither form), the card line, and the last line
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits non-zero without printing a result.  It exits with 1 where
torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

CAPACITY = 256
TICKS = 120
WARMUP_TICKS = 20
COMPARE_TICKS = 20
# per form: f32 sums of up to 768 terms in another order; in bf16 the same
# sums can put a stage output on the other side of a bf16 rounding (one
# bf16 ulp is 2^-8 to 2^-7 of a value), which the next stages carry on
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_BATCHES = (16, 240, CAPACITY, 1024)  # 240: 15 clusters of 16 streams, one fewer than 256
KERNEL_REPS = 50
# the plain version is ~100 launches a call: 5 calls stay well inside the
# card's queue of pending launches, which a longer run behind the sleep
# fills (the host then waits for the card and device_ms reads again)
PLAIN_REPS = 5
FLUSH_BYTES = 128 << 20  # written before each cold-L2 launch: 2.5x the 50 MB L2
# the batches at which each form is timed against its yardstick
# (fused_upsampler.YARDSTICKS) in the same run
YARDSTICK_BATCHES = {"float32": (CAPACITY,), "bfloat16": KERNEL_BATCHES}
# name -> (EngineConfig.realtime keywords, kernel form, engine tolerance
# against the plain-upsampler engine: the kernel's, carried through the
# upsampler state)
ENGINE_CONFIGS = {
    "per_stream_f32": (dict(kv_cache_mode="per_stream", vq_shared_bank=False), "float32"),
    "slots_f32": ({}, "float32"),
    "slots_bf16": (dict(compute_dtype="bfloat16"), "bfloat16"),
}
# the main path of each kernel form, whose launches the kernels line reports
MAIN_CONFIG = {"float32": "slots_f32", "bfloat16": "slots_bf16"}
KERNEL_NAME = {"float32": "fused_upsampler", "bfloat16": "fused_upsampler_bf16"}
COUNTER = {"float32": "launches", "bfloat16": "launches_bf16"}
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "torch_engine_golden.npz")
OFFLINE_GOLDEN = os.path.join(HERE, "tests", "data", "torch_offline_golden.npz")
MODEL_DIR = os.path.join(HERE, "models_demo", "klatt8")
CHUNK = 25  # frames per tick of the chunk path
CHUNK_TICKS = 12  # T = 25 engine ticks timed, after 2 of warm-up
CHUNK_PROFILE_TICKS = 3
PARITY_TOL = 1e-3  # the JAX harness's gate
# parity's controls, the same for every stream: a speaker, a formant, VQ
# smoothing (the shared bank at T = 1, gathered codebooks at T = 25) and
# a pitch shift
PARITY_CONTROLS = {"target_speaker": 3, "formant_index": 2, "vq_num_neighbors": 4,
                   "pitch_shift": 2.0}
VERSION_TICKS = 20
VERSION_SEED = 7
MORPH_TICKS = 60
MORPH_WARMUP_TICKS = 10
MORPH_SEED = 11
MORPH_PROFILE_TICKS = 3
MORPH_AFTER_PROFILER_TICKS = 30
MORPH_GOLDEN = os.path.join(HERE, "tests", "data", "torch_morph_golden.npz")
SERVE_GOLDEN = os.path.join(HERE, "tests", "data", "torch_serve_golden.npz")
SWAP_MODEL = os.path.join(HERE, "models_demo", "klatt8_r6", "config.toml")
PIPELINE_TOL = 1e-6  # the same device and operations, one tick later
# the graph tick against the eager tick: the same kernels on the same
# values (0 expected)
GRAPH_TOL = 1e-6
# the CUDA API calls that put work on a stream
SERVE_TCP_CAPACITY = 64
SERVE_TCP_CLIENTS = 8
SERVE_TCP_RATES = (48000, 44100, 16000)
SERVE_TCP_SECONDS = 3.0
SERVE_TCP_STARTUP_S = 240  # the server process's imports, model load and first tick
SERVE_TCP_DRAIN_S = 60
SERVE_TCP_IDLE_TICKS = 50
SERVE_TCP_MIN_RETURN = 0.9  # a client pulls until this share of its audio is back
SERVE_WS_CAPACITY = 8
SERVE_ROW0_CAPACITY = 8  # serve_pipeline's case with only row 0 live


def log(phase, t0, **fields):
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def sleep_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    torch.cuda._sleep(1_000_000)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def host_us(fn, n=200):
    """Host microseconds per call of fn: wall time over n calls without a
    synchronise (the calls only enqueue work), after warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def device_ms(fn, n, cycles_per_ms, call_us, before=None, tries=3):
    """Median device ms of fn, each call between its own pair of CUDA
    events.  The calls are enqueued behind a torch.cuda._sleep long enough
    to cover their host time, so the device runs them back to back and the
    host never sets the pace.  If the enqueue outlasted the sleep (the
    host was held up), the reading is thrown away and taken again behind a
    4x longer sleep; raises after `tries` readings.  before() (an L2
    flush) runs ahead of each pair, outside it."""
    import torch

    for _ in range(3):
        if before:
            before()
        fn()
    torch.cuda.synchronize()
    sleep_ms = 3.0 * n * call_us * 1e-3 + 2.0
    for _ in range(tries):
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        s1.record()
        t = time.perf_counter()
        pairs = []
        for _ in range(n):
            if before:
                before()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        enqueue_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        slept = s0.elapsed_time(s1)
        if enqueue_ms < slept:
            return float(np.median([a.elapsed_time(b) for a, b in pairs]))
        print(f"device_ms: enqueue took {enqueue_ms:.3f} ms, longer than the {slept:.3f} ms "
              "sleep; reading again", file=sys.stderr, flush=True)
        sleep_ms *= 4
    raise AssertionError(f"the host set the pace in {tries} readings")


def upsampler_inputs(b, seed, device, dtype):
    """Stage weights, frame features, carries and source features for the
    upsampler head at batch b, from a numpy seed (weights scaled as the
    JAX package initialises them); for bf16, frame features, carries and
    matmul weights rounded to bf16."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    rng = np.random.default_rng(seed)
    h_shape, state_shapes, src_shapes, stage_shapes, final_shapes = FU.expected_shapes(b)

    def u(shape, fan_in):
        s = 1.0 / np.sqrt(fan_in)
        return torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32)).to(device)

    def n(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(device)

    up = []
    for st in stage_shapes:
        k, c_in, _ = st["conv_w"]
        up.append({"conv": {"w": u(st["conv_w"], k * c_in), "b": n(st["conv_b"], 0.1)},
                   "src": {"w": u(st["src_w"], FU.N_SRC), "b": n(st["src_b"], 0.1)},
                   "snake": {"log_alpha": n(st["log_alpha"], 0.3)}})
    final = {"w": u(final_shapes["w"], 3 * 16), "b": n(final_shapes["b"], 0.1)}
    h = n(h_shape, 0.5)
    states = [n(s, 0.1) for s in state_shapes]
    src = [n(s, 0.3) for s in src_shapes]
    up, final = FU.head_params(up, final, dtype)
    return up, final, h.to(dtype), [s.to(dtype) for s in states], src


def max_abs_diffs(got, want):
    """max |d| of the audio and of each of the 5 new carries."""
    (audio, states), (want_audio, want_states) = got, want
    return [float((audio - want_audio).abs().max())] + [
        float((g - w).abs().max()) for g, w in zip(states, want_states)]


def path_batches():
    """The batches other than KERNEL_BATCHES at which a phase launches the
    kernel (the golden runs, the serving phases and a mesh rank's rows)."""
    from beatrice_vst_tpu_torch import golden

    return sorted({golden.CAPACITY, golden.MORPH_CAPACITY, golden.SERVE_CAPACITY,
                   SERVE_ROW0_CAPACITY, SERVE_WS_CAPACITY, SERVE_TCP_CAPACITY,
                   golden.CAPACITY // MESH_RANKS, CAPACITY // MESH_RANKS}
                  - set(KERNEL_BATCHES))


def checked_diffs(args, want, dtype_name, b):
    """max |d| of the form's wrapper against the plain version's `want` on
    `args`; raises beyond the form's tolerance."""
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    diffs = max_abs_diffs(FU.fused_upsample(*args), want)
    tol = KERNEL_TOL[dtype_name]
    if not np.isfinite(max(diffs)) or max(diffs) > tol:
        raise AssertionError(f"fused_upsampler {dtype_name} vs plain at B={b}: "
                             f"max|d| {diffs} > {tol}")
    return diffs


def kernel_phase(device, dtype_name):
    """One form of the kernel against its plain version at B in
    KERNEL_BATCHES: max |d| of audio and the 5 carries, device ms with L2
    warm and cold, the wrapper's host us per call, the plain version's
    device ms and the bound.  At YARDSTICK_BATCHES the form's yardstick
    (the f32 form's first version, the FFMA bf16 form) is checked as well
    and timed against it in the order yardstick, form, form, yardstick.
    Returns the kernels-line entry (without launches, which the engine
    phase counts)."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    t0 = time.perf_counter()
    dtype = getattr(torch, dtype_name)
    tol = KERNEL_TOL[dtype_name]
    cycles_per_ms = sleep_cycles_per_ms()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    yardstick = FU.YARDSTICKS[dtype]
    source = FU.FORMS[dtype]
    occupancy = FU.occupancy(device, dtype)
    by_batch = []
    for b in KERNEL_BATCHES:
        args = upsampler_inputs(b, 0, device, dtype)
        want = FU.fused_upsample_reference(*args)
        diffs = checked_diffs(args, want, dtype_name, b)
        err = max(diffs)

        def kernel():
            FU.fused_upsample(*args)

        def plain():
            FU.fused_upsample_reference(*args)

        call_us = host_us(kernel)
        warm = device_ms(kernel, KERNEL_REPS, cycles_per_ms, call_us)
        cold = device_ms(kernel, KERNEL_REPS, cycles_per_ms, call_us, before=flush.zero_)
        plain_ms = device_ms(plain, PLAIN_REPS, cycles_per_ms, host_us(plain, n=20))
        bound = FU.bound_ms(b, dtype)
        row = {"batch": b, "max_abs_diff": err, "per_output_max_abs_diff": diffs,
               "ms": warm, "cold_l2_ms": cold, "host_us_per_call": call_us,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": FU.bound_by(b, dtype),
               "share_of_bound": bound / warm,
               "flops": FU.flops_per_stream() * b, "bytes": FU.bytes_per_call(b, dtype)}
        if b in YARDSTICK_BATCHES[dtype_name]:
            def yard():
                return FU._fused_upsample(*args, source=yardstick)

            y_diffs = max_abs_diffs(yard(), want)
            if not np.isfinite(max(y_diffs)) or max(y_diffs) > tol:
                raise AssertionError(f"{yardstick} {dtype_name} vs plain at B={b}: "
                                     f"max|d| {y_diffs} > {tol}")
            y_us = host_us(yard)
            # [warm, cold] per reading, in the order yardstick, form, form,
            # yardstick
            same_call = {yardstick: [], source: []}
            for name, fn, us in ((yardstick, yard, y_us), (source, kernel, call_us),
                                 (source, kernel, call_us), (yardstick, yard, y_us)):
                same_call[name].append([
                    device_ms(fn, KERNEL_REPS, cycles_per_ms, us),
                    device_ms(fn, KERNEL_REPS, cycles_per_ms, us, before=flush.zero_)])
            runs = same_call[yardstick]
            row.update(yardstick=yardstick, yardstick_max_abs_diff=max(y_diffs),
                       yardstick_host_us_per_call=y_us, same_call_ms_warm_cold=same_call,
                       parent_ms=float(np.mean([r[0] for r in runs])),
                       parent_cold_l2_ms=float(np.mean([r[1] for r in runs])))
        by_batch.append(row)
    del flush
    # the other batches the phases launch the form at, partial tiles of 16
    # streams among them: checked, not timed
    at_path = {}
    for b in path_batches():
        args = upsampler_inputs(b, 0, device, dtype)
        at_path[b] = checked_diffs(args, FU.fused_upsample_reference(*args), dtype_name, b)
    at = next(r for r in by_batch if r["batch"] == CAPACITY)
    entry = {
        "name": KERNEL_NAME[dtype_name],
        "route": "cuda",
        "source": f"beatrice_vst_tpu_torch/csrc/{source}.cu",
        "replaces": "beatrice_vst_tpu/models/pallas_upsampler.py:203",
        "dtype": dtype_name,
        "max_abs_err": at["max_abs_diff"],
        "max_abs_diff": at["max_abs_diff"],
        "tol": tol,
        "ms": at["ms"],
        "cold_l2_ms": at["cold_l2_ms"],
        "host_us_per_call": at["host_us_per_call"],
        "plain_ms": at["plain_ms"],
        "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this fused head
        "by_batch": [{k: r[k] for k in ("batch", "ms", "cold_l2_ms", "host_us_per_call",
                                        "plain_ms", "bound_ms", "max_abs_diff", "parent_ms",
                                        "parent_cold_l2_ms") if k in r}
                     for r in by_batch],
        # the yardstick on the same inputs in the same run, timed the same
        # way (mean of its two readings)
        "parent": f"beatrice_vst_tpu_torch/csrc/{yardstick}.cu",
        "parent_ms": at["parent_ms"],
        "parent_cold_l2_ms": at["parent_cold_l2_ms"],
    }
    log("kernel", t0, dtype=dtype_name, tol=tol, occupancy=occupancy, reps=KERNEL_REPS,
        flush_mib=FLUSH_BYTES / 2**20, by_batch=by_batch,
        path_batches_max_abs_diff=at_path)
    return entry


def klatt8(device):
    """The klatt8 weights and speaker bank on the card."""
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.io import load_weights
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    return (load_weights(os.path.join(MODEL_DIR, "weights.npz"), device=device),
            bank_mod.load(os.path.join(MODEL_DIR, "speakers.npz"), V20RC0, device=device))


def stream_controls(capacity, n_speakers):
    """Each stream's own speaker, formant, VQ neighbours and pitch shift."""
    return [{"target_speaker": i % n_speakers, "formant_index": (i // n_speakers) % 9,
             "vq_num_neighbors": i % 5, "pitch_shift": float((i % 7) - 3)}
            for i in range(capacity)]


def admit_all(engine, n_speakers):
    """Admit every stream with its `stream_controls`."""
    for controls in stream_controls(engine.cfg.capacity, n_speakers):
        i = engine.admit()
        for field, value in controls.items():
            engine.set_control(i, field, value)


def build_engine(device, config, upsampler_kernel=True, capacity=CAPACITY, controls=True,
                 frames_per_tick=1, jit=True):
    """The port's StreamEngine in the named configuration on the klatt8
    weights (jit=True: the graph tick; False: eager); with `controls`,
    every stream admitted by `admit_all`."""
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    params, bank = klatt8(device)
    cfg = EngineConfig.realtime(capacity, upsampler_kernel=upsampler_kernel,
                                frames_per_tick=frames_per_tick, **ENGINE_CONFIGS[config][0])
    engine = StreamEngine(cfg, params, bank, device=device, jit=jit)
    if controls:
        admit_all(engine, bank_mod.n_speakers(bank))
    return engine


def engine_audio(device, frames=TICKS):
    """[frames, CAPACITY, 480] at 48 kHz on the card: a swept sine (each
    stream its own start frequency) plus noise from a numpy seed."""
    import torch

    rng = np.random.default_rng(1)
    n = np.arange(frames * 480) / 48000.0
    f0 = rng.uniform(90.0, 300.0, CAPACITY)[:, None]
    x = 0.3 * np.sin(2 * np.pi * (f0 * n + 150.0 * n * n))
    x = x + 0.02 * rng.standard_normal(x.shape)
    x = x.astype(np.float32).reshape(CAPACITY, frames, 480).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def utterance(audio):
    """[frames, B, 480] -> [B, frames * 480]: each stream's frames in a row."""
    return audio.permute(1, 0, 2).reshape(audio.shape[1], -1).contiguous()


def launch_counts():
    """Each kernel form's launches since the counts were last set to 0, and
    each yardstick's (under "yardstick_<form>"; no path launches one)."""
    import torch
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    counts = {form: getattr(FU, COUNTER[form]) for form in COUNTER}
    for form in COUNTER:
        dtype = getattr(torch, form)
        counts[f"yardstick_{form}"] = FU.yardstick_launches[FU.YARDSTICKS[dtype], str(dtype)]
    return counts


def reset_launch_counts():
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    FU.launches = FU.launches_bf16 = 0
    FU.yardstick_launches.clear()


def timed_ticks(engine, audio, ticks, keep=0):
    """`ticks` ticks of audio, each between CUDA events: (each stream's
    peak per tick [ticks, CAPACITY], whether all were finite, span ms per
    tick, host ms per tick, the first `keep` outputs)."""
    import torch

    spans, host_ms, peaks, finite, kept = [], [], [], [], []
    for k in range(ticks):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        out = engine.tick(audio[k])
        host_ms.append((time.perf_counter() - t) * 1e3)
        end.record()
        peaks.append(out.abs().max(dim=1).values)
        finite.append(torch.isfinite(out).all())
        spans.append((start, end))
        if k < keep:
            kept.append(out.clone())
    torch.cuda.synchronize()
    return (torch.stack(peaks), bool(torch.stack(finite).all()),
            [s.elapsed_time(e) for s, e in spans], host_ms, kept)


class Spans:
    """A `run_parity` timer: for each named block, its span from CUDA
    events, the host's time to enqueue it, each kernel form's launches
    and the peak memory."""

    def __init__(self):
        self.out = {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        yield
        host_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        self.out[name] = {"span_ms": start.elapsed_time(end), "host_ms": host_ms,
                          "launches": {k: v - before[k] for k, v in launch_counts().items()},
                          "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def check_parity(report, spans, label):
    """The parity gate and the f32 kernel's launches: one per streaming
    tick (a replay of the compiled streaming tick counts its launch), none
    in the chunk tick, and with the compiled streaming half
    GRAPH_WARMUP_CALLS in its capture (the warm-up ticks).  Returns the
    f32 form's launches."""
    from beatrice_vst_tpu_torch.runtime.graphs import GRAPH_WARMUP_CALLS

    if not report.passed:
        raise AssertionError(f"{label}: {report}")
    n = report.n_frames
    stream, chunk = spans.out["stream"]["launches"], spans.out["chunk"]["launches"]
    if stream != {**dict.fromkeys(stream, 0), "float32": n} or sum(chunk.values()) != 0:
        raise AssertionError(f"{label}: kernel launches {stream} in {n} streaming ticks and "
                             f"{chunk} in the chunk tick; expected {n} f32 and 0")
    capture = spans.out.get("capture", {}).get("launches", {"float32": GRAPH_WARMUP_CALLS})
    if capture != {**dict.fromkeys(capture, 0), "float32": GRAPH_WARMUP_CALLS}:
        raise AssertionError(f"{label}: kernel launches {capture} in the capture of the "
                             f"streaming tick, expected {GRAPH_WARMUP_CALLS} f32")
    return stream["float32"] + (capture["float32"] if "capture" in spans.out else 0)


def golden_gate(label, form, got, f32_ref, bf16_ref):
    """A run on the card against the JAX engine's golden output: f32 at
    atol 1e-3 to f32_ref; bf16 by the envelope of golden.py against the
    JAX f32 and bf16 runs (f32_ref, bf16_ref).  Raises if it fails."""
    from beatrice_vst_tpu_torch import golden

    if form == "bfloat16":
        env = golden.envelope(got, {"f32": f32_ref, "bf16": bf16_ref})
        if not env["ok"]:
            raise AssertionError(f"{label} outside the golden envelope: {env}")
        return {"envelope": env}
    dev = golden.deviation(got, f32_ref)
    if not dev["max"] <= golden.F32_ATOL:
        raise AssertionError(f"{label} vs the golden file: max|d| {dev['max']} > "
                             f"{golden.F32_ATOL}")
    return {"vs_golden_f32": dev, "tol": golden.F32_ATOL}


def golden_check(device, config):
    """The engine's golden run on the card (4 streams x 20 ticks) against
    the JAX engine's output in tests/data/torch_engine_golden.npz."""
    from beatrice_vst_tpu_torch import golden

    ref = golden.load(GOLDEN)
    engine = build_engine(device, config, capacity=golden.CAPACITY, controls=False)
    got = golden.run(engine, lambda t: t.cpu().numpy())
    return golden_gate(config, ENGINE_CONFIGS[config][1], got, ref["f32"], ref["bf16"])


def paired_ticks(engines, audio, ticks):
    """`ticks` ticks of audio through the named engines in turns (the
    order reversed every other tick), each tick after a synchronise and
    between CUDA events, so that its span is its own (a host-bound eager
    tick enqueued behind a graph tick would otherwise start its span only
    when the graph's work ended): ({name: span ms per tick}, {name: host
    ms per tick}, the largest |d| between the first two engines' outputs
    of a tick, whether every output was finite, the quietest tick's
    loudest sample)."""
    import torch

    names = list(engines)
    spans, host = {n: [] for n in names}, {n: [] for n in names}
    diffs, finite, peaks = [], [], []
    for k in range(ticks):
        outs = {}
        for name in names if k % 2 == 0 else names[::-1]:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            t = time.perf_counter()
            outs[name] = engines[name].tick(audio[k])
            host[name].append((time.perf_counter() - t) * 1e3)
            end.record()
            spans[name].append((start, end))
        a, b = outs[names[0]], outs[names[1]]
        diffs.append((a - b).abs().max())
        finite.append(torch.isfinite(a).all() & torch.isfinite(b).all())
        peaks.append(a.abs().max())
    torch.cuda.synchronize()
    return ({n: [s.elapsed_time(e) for s, e in spans[n]] for n in names}, host,
            float(torch.stack(diffs).max()), bool(torch.stack(finite).all()),
            float(torch.stack(peaks).min()))


def tick_stats_ms(spans, host, skip):
    """Median and p90 span and median host ms past the first `skip` ticks."""
    return {"median_tick_ms": float(np.median(spans[skip:])),
            "p90_tick_ms": float(np.percentile(spans[skip:], 90)),
            "median_host_ms": float(np.median(host[skip:]))}


def graph_phase(device, config, card):
    """The compiled tick against the eager one in one configuration at
    capacity 256, T = 1: an eager engine (jit=False) and a graph engine
    (jit=True, the default) with the same controls, TICKS ticks of the
    same audio in turns, with the launch counts set to 0 just before and
    read just after (one launch of the form per tick each).  Gate: every
    tick's outputs within GRAPH_TOL.  Reported: median and p90 span (CUDA
    events) and host ms per tick of each, the capture's host ms, and each
    engine's peak MiB while it was built (the graph's pool included)
    above the memory live before it.  Returns the form's launches and the
    engines, for graph_profile_phase."""
    import torch

    t0 = time.perf_counter()
    form = ENGINE_CONFIGS[config][1]
    audio = engine_audio(device)
    engines, build_mib = {}, {}
    for name, jit in (("eager", False), ("graph", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        engines[name] = build_engine(device, config, jit=jit)
        engines[name].flush_controls()
        torch.cuda.synchronize()
        build_mib[name] = (torch.cuda.max_memory_allocated() - live) / 2**20
    reset_launch_counts()
    spans, host, diff, finite, quietest = paired_ticks(engines, audio, TICKS)
    counts = launch_counts()
    if counts[form] != 2 * TICKS or sum(counts.values()) != 2 * TICKS:
        raise AssertionError(f"graph {config}: kernel launches {counts} in {TICKS} ticks of "
                             f"each engine, expected {2 * TICKS} of the {form} form only")
    if not finite or quietest <= 1e-3:
        raise AssertionError(f"graph {config}: output not finite or silent ({quietest})")
    if not diff <= GRAPH_TOL:
        raise AssertionError(f"graph {config}: graph vs eager tick: max|d| {diff} > {GRAPH_TOL}")
    log("graph", t0, config=config, kernel_form=form, capacity=CAPACITY, frames_per_tick=1,
        ticks=TICKS, launches=counts, max_abs_diff_graph_vs_eager=diff, tol=GRAPH_TOL,
        **{name: {**tick_stats_ms(spans[name], host[name], WARMUP_TICKS),
                  "build_peak_mib": build_mib[name]} for name in engines},
        capture_ms=engines["graph"].capture_ms,
        graph_warmup_ticks=engines["graph"].counters["graph_warmup_ticks"], nvidia_smi=card)
    return counts[form], engines


def graph_profile_phase(device, runs, card):
    """For each configuration's eager and graph engines of graph_phase,
    after every timed phase of the engine: device kernels and host launch
    calls per tick under torch.profiler (tick_launches)."""
    audio = engine_audio(device)
    for config, engines in runs.items():
        t0 = time.perf_counter()
        log("graph_profile", t0, config=config, profiled_ticks=MORPH_PROFILE_TICKS,
            **{name: tick_launches(e, audio[TICKS - MORPH_PROFILE_TICKS:], MORPH_PROFILE_TICKS)
               for name, e in engines.items()}, nvidia_smi=card)


def engine_phase(device, config):
    """One configuration at capacity 256: TICKS ticks with the launch
    counts set to 0 just before and read just after; returns the launches
    of its kernel form."""
    import torch

    t0 = time.perf_counter()
    form = ENGINE_CONFIGS[config][1]
    tol = KERNEL_TOL[form]
    audio = engine_audio(device)
    engine = build_engine(device, config)
    engine.flush_controls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    peaks, finite, spans, host_ms, kept = timed_ticks(engine, audio, TICKS, COMPARE_TICKS)
    counts = launch_counts()
    if counts[form] != TICKS or sum(counts.values()) != TICKS:
        raise AssertionError(f"{config}: kernel launches {counts} in {TICKS} ticks, "
                             f"expected {TICKS} of the {form} form only")
    if not finite:
        raise AssertionError(f"{config}: non-finite engine output")
    times = spans[WARMUP_TICKS:]
    median_tick = float(np.median(times))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if float(peaks[:COMPARE_TICKS].max()) <= 1e-3:
        raise AssertionError(f"{config}: engine output is silent")

    plain = build_engine(device, config, upsampler_kernel=False)
    diff = 0.0
    for k in range(COMPARE_TICKS):
        out = plain.tick(audio[k])
        diff = max(diff, float((out - kept[k]).abs().max()))
    if launch_counts()[form] != counts[form]:
        raise AssertionError(f"{config}: the plain-upsampler engine launched the kernel")
    if not np.isfinite(diff) or diff > tol:
        raise AssertionError(f"{config}: kernel engine vs plain engine: max|d| {diff} > {tol}")
    log("engine", t0, config=config, kernel_form=form, capacity=CAPACITY, ticks=TICKS,
        jit=engine.jit, launches=counts, median_tick_ms=median_tick,
        p90_tick_ms=float(np.percentile(times, 90)),
        median_host_ms=float(np.median(host_ms[WARMUP_TICKS:])),
        implied_streams_per_10ms=CAPACITY * 10.0 / median_tick,
        peak_mib=peak_mib, plain_engine_ticks=COMPARE_TICKS,
        plain_engine_max_abs_diff=diff, tol=tol, golden=golden_check(device, config))
    return counts[form]


def parity_phase(device):
    """run_parity on klatt8, slots f32, capacity 256, 25 frames (twice,
    the second timed), then the engine at frames_per_tick = 25.  Returns
    the f32 form's launches in the streaming halves."""
    import torch
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.parity import run_parity

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    cfg = VoiceConverterConfig.for_version(V20RC0)
    audio = utterance(engine_audio(device, CHUNK))
    launches = 0
    runs = []
    for _ in range(2):
        spans = Spans()
        reset_launch_counts()
        report = run_parity(params, cfg, bank, audio, tolerance=PARITY_TOL,
                            controls=PARITY_CONTROLS, device=device, timer=spans)
        launches += check_parity(report, spans, "parity on klatt8")
        runs.append({"max_abs_diff": report.max_abs_diff, "rms_diff": report.rms_diff,
                     **{f"{half}_{k}": v for half, s in spans.out.items()
                        for k, v in s.items()}})
    timed = runs[-1]
    per_10ms = {f"{half}_span_ms_per_10ms_audio": timed[f"{half}_span_ms"] / CHUNK
                for half in ("stream", "chunk")}
    log("parity", t0, model="klatt8", config="slots_f32", capacity=CAPACITY, frames=CHUNK,
        tol=PARITY_TOL, controls=PARITY_CONTROLS, runs=runs, **per_10ms,
        chunk_engine=chunk_engine(device))
    return launches


def chunk_engine(device):
    """The engine at frames_per_tick = 25, slots f32, capacity 256, graph
    and eager (jit=False) in turns on the same audio: CHUNK_TICKS ticks
    after 2 of warm-up, each between CUDA events, every tick's outputs
    within GRAPH_TOL; then CHUNK_PROFILE_TICKS ticks of each under
    torch.profiler.  Every output finite and not silent; the kernel never
    launched (the chunk head is the stage loop)."""
    import torch
    from beatrice_vst_tpu_torch.parallel.checks import host_launch_calls
    from torch.profiler import ProfilerActivity, profile

    engines = {"graph": build_engine(device, "slots_f32", frames_per_tick=CHUNK),
               "eager": build_engine(device, "slots_f32", frames_per_tick=CHUNK, jit=False)}
    frames = (2 + CHUNK_TICKS + CHUNK_PROFILE_TICKS) * CHUNK
    audio = engine_audio(device, frames).reshape(-1, CHUNK, CAPACITY, 480)
    ticks = [utterance(a) for a in audio]
    for e in engines.values():
        e.flush_controls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    spans, host, diff, finite, quietest = paired_ticks(engines, ticks, 2 + CHUNK_TICKS)
    if not finite or quietest <= 1e-3:
        raise AssertionError(f"T = {CHUNK} engine: output not finite or silent: {quietest}")
    if not diff <= GRAPH_TOL:
        raise AssertionError(f"T = {CHUNK}: graph vs eager tick: max|d| {diff} > {GRAPH_TOL}")
    if sum(launch_counts().values()):
        raise AssertionError(f"T = {CHUNK} engine launched the kernel: {launch_counts()}")
    out = {"frames_per_tick": CHUNK, "ticks": CHUNK_TICKS, "max_abs_diff_graph_vs_eager": diff,
           "tol": GRAPH_TOL, "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "profiled_ticks": CHUNK_PROFILE_TICKS}
    n = CHUNK_PROFILE_TICKS
    for name, engine in engines.items():
        median = float(np.median(spans[name][2:]))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for k in range(2 + CHUNK_TICKS, len(ticks)):
                engine.tick(ticks[k])
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        out[name] = {
            **tick_stats_ms(spans[name], host[name], 2),
            "median_tick_ms_per_10ms_audio": median / CHUNK,
            "implied_streams_per_10ms": CAPACITY * CHUNK * 10.0 / median,
            "device_launches_per_tick": sum(c for _, c, _ in rows) / n,
            "host_launches_per_tick": host_launch_calls(prof) / n,
            "device_busy_ms_per_tick": sum(us for us, _, _ in rows) / n / 1e3,
            "top": [{"kernel": key[:100], "ms_per_tick": us / n / 1e3,
                     "launches_per_tick": c / n} for us, c, key in rows[:8]]}
    return out


def offline_phase(device):
    """convert_utterance on klatt8 against the JAX package's output in
    tests/data/torch_offline_golden.npz, and its speed."""
    import torch
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    cfg = VoiceConverterConfig.for_version(V20RC0)
    signal = golden.offline_signal()
    want = golden.load(OFFLINE_GOLDEN)["f32"]
    seconds = []
    for _ in range(2):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = convert_utterance(params, cfg, bank, signal, golden.OFFLINE_RATE,
                                ConversionSettings(**golden.OFFLINE_SETTINGS),
                                chunk_frames=golden.OFFLINE_CHUNK_FRAMES, device=device)
        seconds.append(time.perf_counter() - t)
        dev = golden.deviation(got, want)
        if got.shape != want.shape or not dev["max"] <= golden.F32_ATOL:
            raise AssertionError(f"offline vs the golden file: shape {got.shape} "
                                 f"(want {want.shape}), {dev} > {golden.F32_ATOL}")
    audio_s = len(signal) / golden.OFFLINE_RATE
    log("offline", t0, model="klatt8", rate=golden.OFFLINE_RATE, audio_seconds=audio_s,
        chunk_frames=golden.OFFLINE_CHUNK_FRAMES, vs_golden=dev, tol=golden.F32_ATOL,
        seconds=seconds, audio_seconds_per_second=audio_s / seconds[-1],
        kernel_launches=launch_counts())


def versions_phase(device):
    """The older versions' engines at capacity 256 on random parameters:
    kernel against plain upsampler, then parity.  Returns the f32 form's
    launches on these paths."""
    import torch
    from beatrice_vst_tpu_torch.constants import V20A2, V20B1
    from beatrice_vst_tpu_torch.models import chain
    from beatrice_vst_tpu_torch.parity import run_parity
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    audio = engine_audio(device, max(VERSION_TICKS, CHUNK))
    launches = 0
    for spec in (V20A2, V20B1):
        t0 = time.perf_counter()
        cfg = chain.VoiceConverterConfig.for_version(spec)
        seed = VERSION_SEED + spec.version_int
        params = chain.init(torch.Generator().manual_seed(seed), cfg, device)
        bank = bank_mod.random_bank(torch.Generator().manual_seed(seed + 100), spec, 8,
                                    device=device)
        outs = {}
        for kernel in (True, False):
            engine = StreamEngine(EngineConfig.realtime(CAPACITY, spec=spec,
                                                        upsampler_kernel=kernel),
                                  params, bank, device=device)
            admit_all(engine, 8)
            engine.flush_controls()
            reset_launch_counts()
            outs[kernel] = torch.stack([engine.tick(audio[k]) for k in range(VERSION_TICKS)])
            counts = launch_counts()
            want = {**dict.fromkeys(counts, 0), "float32": VERSION_TICKS if kernel else 0}
            if counts != want:
                raise AssertionError(f"{spec.name} engine (kernel {kernel}): launches {counts}, "
                                     f"expected {want}")
            if kernel:
                launches += counts["float32"]
        if not bool(torch.isfinite(outs[True]).all()) or float(outs[True].abs().max()) <= 1e-3:
            raise AssertionError(f"{spec.name} engine: output not finite or silent")
        diff = float((outs[True] - outs[False]).abs().max())
        if not diff <= KERNEL_TOL["float32"]:
            raise AssertionError(f"{spec.name}: kernel engine vs plain engine: max|d| {diff}")
        spans = Spans()
        reset_launch_counts()
        report = run_parity(params, cfg, bank, utterance(audio[:CHUNK]), tolerance=PARITY_TOL,
                            device=device, timer=spans)
        launches += check_parity(report, spans, f"parity of {spec.name}")
        log("versions", t0, version=spec.name, capacity=CAPACITY, seed=seed,
            ticks=VERSION_TICKS, launches=VERSION_TICKS, plain_engine_max_abs_diff=diff,
            tol=KERNEL_TOL["float32"], parity={"max_abs_diff": report.max_abs_diff,
                                               "rms_diff": report.rms_diff,
                                               "tol": PARITY_TOL, "frames": report.n_frames,
                                               **spans.out})
    return launches


def morph_controls(device, n_speakers):
    """Every odd stream's morph controls: its own weights over the bank's
    speakers from a numpy seed (Dirichlet(0.5), so some fall below the
    threshold), pruned on the card by the port's ops/morph.  Returns
    {stream: (morph_weights [256], morph_top_idx [8])} as numpy."""
    import torch
    from beatrice_vst_tpu_torch.constants import MAX_N_SPEAKERS
    from beatrice_vst_tpu_torch.speakers.morpher import pruned_morph_weights

    streams = list(range(1, CAPACITY, 2))
    dense = np.zeros((len(streams), MAX_N_SPEAKERS), np.float32)
    dense[:, :n_speakers] = np.random.default_rng(MORPH_SEED).dirichlet(
        np.full(n_speakers, 0.5), len(streams))
    pruned, top = pruned_morph_weights(torch.from_numpy(dense).to(device),
                                       torch.full((len(streams),), n_speakers, device=device))
    pruned, top = pruned.cpu().numpy(), top.cpu().numpy()
    return {i: (pruned[k], top[k]) for k, i in enumerate(streams)}


def set_morph(engine, controls, n_speakers):
    from beatrice_vst_tpu_torch import golden

    for i, (pruned, top) in controls.items():
        golden.set_morph(engine, i, pruned, top, n_speakers)


def tick_launches(engine, audio, ticks):
    """Over `ticks` ticks under torch.profiler: device kernels (and
    copies) per tick, and the host's launch calls per tick
    (parallel/checks.py:host_launch_calls)."""
    import torch
    from beatrice_vst_tpu_torch.parallel.checks import host_launch_calls
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(ticks):
            engine.tick(audio[k])
        torch.cuda.synchronize()
    device = sum(e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"device_launches_per_tick": device / ticks,
            "host_launches_per_tick": host_launch_calls(prof) / ticks}


def lottery_launches(engine, n_speakers, calls=5):
    """The codebook lottery as the tick calls it, alone: (device kernel
    launches per call over `calls` calls under torch.profiler, host us per
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from beatrice_vst_tpu_torch.speakers import morpher

    c, st = engine.state["controls"], engine.state

    def lottery():
        return morpher.codebook_lottery(
            c["morph_weights"], c["morph_top_idx"],
            torch.full_like(c["target_speaker"], n_speakers), st["frame_counter"],
            w8=st["morphed"]["w8"])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            lottery()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return launches / calls, host_us(lottery)


def refresh_span(engine):
    """flush_controls between CUDA events, after a synchronise: (span ms,
    host ms)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.perf_counter()
    engine.flush_controls()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), host_ms


def morph_golden_check(device, config):
    """The morph scenario (golden.run_morph: 6 streams x 20 ticks, two
    morph slots) on the card against the JAX engine's output in
    tests/data/torch_morph_golden.npz (bf16: the envelope against the JAX
    slots f32 and bf16 runs)."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine

    ref = golden.load(MORPH_GOLDEN)
    engine = StreamEngine(EngineConfig.realtime(golden.MORPH_CAPACITY,
                                                **golden.MORPH_CONFIGS[config]),
                          *klatt8(device), device=device)
    got = golden.run_morph(engine, lambda t: t.cpu().numpy())
    form = ENGINE_CONFIGS[config][1]
    return golden_gate(f"morph {config}", form, got,
                       ref["slots_f32" if form == "bfloat16" else config], ref[config])


def morph_phase(device, config, card):
    """Half the streams morphing at capacity 256 in one configuration:
    every odd stream's morph controls staged after the direct streams
    settle, the refresh (flush_controls) timed twice (the second warm);
    MORPH_TICKS ticks with the launch counts set to 0 just before and read
    just after (the configuration's kernel form once per tick), outputs
    finite and not silent (the morph streams too); the direct engine's
    ticks in the same run, half before and half after; the first
    COMPARE_TICKS against a plain-upsampler engine with the same morphs,
    staged the same way; the memory allocated before the ticks (every
    engine alive in the process) and the ticks' peak above it;
    the morph golden run.  Returns the launches of its kernel form and what
    `morph_profile_phase` profiles later (no profiler runs before every
    configuration's ticks are timed)."""
    import torch
    from beatrice_vst_tpu_torch.speakers import bank as bank_mod

    t0 = time.perf_counter()
    form = ENGINE_CONFIGS[config][1]
    tol = KERNEL_TOL[form]
    audio = engine_audio(device)
    engines = {}
    for name, kernel in (("morph", True), ("plain", False), ("direct", True)):
        engines[name] = build_engine(device, config, upsampler_kernel=kernel)
        engines[name].flush_controls()
    n_spk = bank_mod.n_speakers(engines["morph"].bank)
    controls = morph_controls(device, n_spk)
    eng = engines["morph"]
    refresh = []
    for _ in range(2):  # the second refresh is warm
        set_morph(eng, controls, n_spk)
        refresh.append(refresh_span(eng))
    set_morph(engines["plain"], controls, n_spk)
    engines["plain"].flush_controls()
    n_slot_leases = len(eng._morph_slot)

    half = MORPH_TICKS // 2
    _, direct_finite, direct_a, direct_host_a, _ = timed_ticks(engines["direct"], audio, half)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    reset_launch_counts()
    peaks, finite, spans, host_ms, kept = timed_ticks(eng, audio, MORPH_TICKS, COMPARE_TICKS)
    counts = launch_counts()
    tick_mib = (torch.cuda.max_memory_allocated() - live) / 2**20
    if counts[form] != MORPH_TICKS or sum(counts.values()) != MORPH_TICKS:
        raise AssertionError(f"morph {config}: kernel launches {counts} in {MORPH_TICKS} ticks, "
                             f"expected {MORPH_TICKS} of the {form} form only")
    _, direct_finite_b, direct_b, direct_host_b, _ = timed_ticks(
        engines["direct"], audio[half:], MORPH_TICKS - half)
    if not (finite and direct_finite and direct_finite_b):
        raise AssertionError(f"morph {config}: non-finite engine output")
    morph_peak = float(peaks[:, 1::2].max(dim=0).values.min())
    if float(peaks.max(dim=1).values.min()) <= 1e-3 or morph_peak <= 1e-3:
        raise AssertionError(f"morph {config}: silent output (quietest morph stream {morph_peak})")

    diff = 0.0
    before = launch_counts()
    for k in range(COMPARE_TICKS):
        diff = max(diff, float((engines["plain"].tick(audio[k]) - kept[k]).abs().max()))
    if launch_counts() != before:
        raise AssertionError(f"morph {config}: the plain-upsampler engine launched the kernel")
    if not np.isfinite(diff) or diff > tol:
        raise AssertionError(f"morph {config}: kernel engine vs plain engine: max|d| {diff} > "
                             f"{tol}")
    direct = direct_a[MORPH_WARMUP_TICKS:] + direct_b
    times = spans[MORPH_WARMUP_TICKS:]
    log("morph", t0, config=config, kernel_form=form, capacity=CAPACITY,
        morph_streams=len(controls), morph_slots_leased=n_slot_leases, ticks=MORPH_TICKS,
        launches=counts, refresh_ms=[r[0] for r in refresh],
        refresh_host_ms=[r[1] for r in refresh],
        median_tick_ms=float(np.median(times)), p90_tick_ms=float(np.percentile(times, 90)),
        median_host_ms=float(np.median(host_ms[MORPH_WARMUP_TICKS:])),
        direct_median_tick_ms=float(np.median(direct)),
        direct_p90_tick_ms=float(np.percentile(direct, 90)),
        direct_median_host_ms=float(np.median(direct_host_a[MORPH_WARMUP_TICKS:] + direct_host_b)),
        live_mib=live / 2**20, tick_peak_over_live_mib=tick_mib,
        plain_engine_ticks=COMPARE_TICKS, plain_engine_max_abs_diff=diff,
        tol=tol,
        golden=morph_golden_check(device, config), nvidia_smi=card)
    return counts[form], (eng, engines["direct"], n_spk)


def morph_profile_phase(device, runs, card):
    """For each configuration's morph and direct engines, after all of
    them were timed: device launches per tick under torch.profiler
    (MORPH_PROFILE_TICKS ticks each), the lottery's own launches and host
    time, and the direct engine's ticks timed again after the profiler
    ran (MORPH_AFTER_PROFILER_TICKS, median after MORPH_WARMUP_TICKS)."""
    audio = engine_audio(device)
    start = MORPH_TICKS + MORPH_PROFILE_TICKS
    for config, (eng, direct, n_spk) in runs.items():
        t0 = time.perf_counter()
        lottery, lottery_us = lottery_launches(eng, n_spk)
        per_tick = {"morph": tick_launches(eng, audio[MORPH_TICKS:], MORPH_PROFILE_TICKS),
                    "direct": tick_launches(direct, audio[MORPH_TICKS:], MORPH_PROFILE_TICKS)}
        _, finite, after, after_host, _ = timed_ticks(direct, audio[start:],
                                                      MORPH_AFTER_PROFILER_TICKS)
        if not finite:
            raise AssertionError(f"morph profile {config}: non-finite engine output")
        log("morph_profile", t0, config=config, device_launches_per_tick=per_tick,
            lottery_launches=lottery, lottery_host_us=lottery_us,
            direct_median_tick_ms_after_profiler=float(np.median(after[MORPH_WARMUP_TICKS:])),
            direct_median_host_ms_after_profiler=float(np.median(after_host[MORPH_WARMUP_TICKS:])),
            nvidia_smi=card)


def morph_offline_phase(device, card):
    """convert_utterance with morph weights (golden.MORPH_WEIGHTS of
    MORPH_OFFLINE_STREAM) on klatt8 against the JAX package's output in
    tests/data/torch_morph_golden.npz at atol 1e-3."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    weights = np.asarray(golden.MORPH_WEIGHTS[golden.MORPH_OFFLINE_STREAM], np.float32)
    got = convert_utterance(params, VoiceConverterConfig.for_version(V20RC0), bank,
                            golden.offline_signal(), golden.OFFLINE_RATE,
                            ConversionSettings(**golden.OFFLINE_SETTINGS, morph_weights=weights),
                            chunk_frames=golden.OFFLINE_CHUNK_FRAMES, device=device)
    want = golden.load(MORPH_GOLDEN)["offline"]
    dev = golden.deviation(got, want)
    if got.shape != want.shape or not dev["max"] <= golden.F32_ATOL:
        raise AssertionError(f"morph offline vs the golden file: shape {got.shape} "
                             f"(want {want.shape}), {dev} > {golden.F32_ATOL}")
    log("morph_offline", t0, model="klatt8", weights=weights.tolist(), vs_golden=dev,
        tol=golden.F32_ATOL, nvidia_smi=card)


def serving_health(label, metrics, running=None):
    """The checks after every serving phase: no recovery, no last_error
    and, where there is a scheduler thread, that it is still alive."""
    if metrics.get("recoveries", 0) or "last_error" in metrics:
        raise AssertionError(f"{label}: recovered from a failure: "
                             f"{metrics.get('recoveries')}, {metrics.get('last_error')}")
    if running is False:
        raise AssertionError(f"{label}: the scheduler thread died")


def serve_golden_phase(device, card):
    """The serving scenario through the port's ModelHost, ticked by hand,
    against the JAX ModelHost's run in tests/data/torch_serve_golden.npz.
    Returns the f32 form's launches and the run."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.runtime import ModelHost

    t0 = time.perf_counter()
    ref = golden.load(SERVE_GOLDEN)
    seen = {}
    reset_launch_counts()
    got = golden.run_serve(ModelHost, MODEL_DIR, device=device,
                           inspect=lambda host: seen.update(host.metrics()))
    counts = launch_counts()
    # one launch a tick: the scenario's, and the graph's warm-up ticks
    want = {**dict.fromkeys(counts, 0),
            "float32": golden.SERVE_TICKS + seen.get("graph_warmup_ticks", 0)}
    if counts != want:
        raise AssertionError(f"serve_golden: kernel launches {counts}, expected {want}")
    serving_health("serve_golden", seen)
    devs = {}
    for i in range(len(golden._serve_sessions())):
        if not np.array_equal(got[f"s{i}_len"], ref[f"s{i}_len"]):
            raise AssertionError(f"serve_golden: session {i} pulled {got[f's{i}_len']}, "
                                 f"the golden run {ref[f's{i}_len']}")
        devs[f"s{i}"] = golden.deviation(got[f"s{i}"], ref[f"s{i}"])
        if not devs[f"s{i}"]["max"] <= golden.F32_ATOL or np.abs(got[f"s{i}"]).max() <= 1e-3:
            raise AssertionError(f"serve_golden: session {i} {devs[f's{i}']} (tol "
                                 f"{golden.F32_ATOL}) or silent")
    log("serve_golden", t0, model="klatt8", capacity=golden.SERVE_CAPACITY,
        ticks=golden.SERVE_TICKS, graph_warmup_ticks=seen.get("graph_warmup_ticks", 0),
        launches=counts, vs_golden=devs, tol=golden.F32_ATOL,
        serve_tick_p50_ms=seen["serve_tick_p50_ms"], engine_enqueue_p50_ms=seen["tick_p50_ms"],
        nvidia_smi=card)
    return counts["float32"], got


def serve_pipeline_phase(device, card, plain):
    """The serving scenario with pipeline=True against serve_golden's run
    one tick later, then pipeline mode with only row 0 live at capacity 8.
    Returns the f32 form's launches."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.models.io import load_model_dir
    from beatrice_vst_tpu_torch.runtime import (EngineConfig, ModelHost, StreamEngine,
                                                StreamingServer)

    t0 = time.perf_counter()
    seen = {}
    reset_launch_counts()
    piped = golden.run_serve(ModelHost, MODEL_DIR, device=device, pipeline=True,
                             inspect=lambda host: seen.update(host.metrics()))
    serving_health("serve_pipeline", seen)
    diff = 0.0
    for i in range(len(golden._serve_sessions())):
        a, b = golden.serve_blocks(plain, i), golden.serve_blocks(piped, i)
        if len(b) != len(a) or len(b[0]):
            raise AssertionError(f"serve_pipeline: session {i}: {len(b)} pulls, the first "
                                 f"{len(b[0])} samples long")
        for k in range(len(a) - 1):
            if a[k].shape != b[k + 1].shape:
                raise AssertionError(f"serve_pipeline: session {i} tick {k}: shapes differ")
            diff = max(diff, float(np.abs(a[k] - b[k + 1]).max(initial=0.0)))
    if not diff <= PIPELINE_TOL:
        raise AssertionError(f"serve_pipeline: max|d| {diff} against plain one tick later")

    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    engine = StreamEngine(EngineConfig(capacity=SERVE_ROW0_CAPACITY, model=cfg), params, bank,
                          device=device)
    srv = StreamingServer(engine, realtime=False, pipeline=True)
    s0 = srv.open_session(48000.0)
    srv.open_session(48000.0).close()
    s0.push(golden.serve_signal(48000, 0)[:480 * 6])
    got = []
    for _ in range(6):
        srv.tick_once()
        got.append(s0.pull(480))
    srv.flush_pipeline()
    got.append(s0.pull(480))
    y = np.concatenate(got)
    if len(y) != 480 * 6 or not np.isfinite(y).all() or np.abs(y).max() <= 1e-3:
        raise AssertionError(f"serve_pipeline, row 0 live of 8: {len(y)} samples, "
                             "not finite or silent")
    serving_health("serve_pipeline, row 0 live", srv.metrics())
    counts = launch_counts()
    warmup = seen.get("graph_warmup_ticks", 0) + engine.counters.get("graph_warmup_ticks", 0)
    want = {**dict.fromkeys(counts, 0), "float32": golden.SERVE_TICKS + 6 + warmup}
    if counts != want:
        raise AssertionError(f"serve_pipeline: kernel launches {counts}, expected {want}")
    log("serve_pipeline", t0, model="klatt8", ticks=golden.SERVE_TICKS + 6,
        graph_warmup_ticks=warmup, launches=counts,
        max_abs_diff_vs_plain_one_tick_later=diff, tol=PIPELINE_TOL,
        serve_tick_p50_ms=seen["serve_tick_p50_ms"], engine_enqueue_p50_ms=seen["tick_p50_ms"],
        nvidia_smi=card)
    return counts["float32"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tcp_client(i, port, out):
    """Client i of serve_tcp: connect at its rate, set a voice and a pitch
    shift (client 0: a two-voice morph through the morph pad), push 3 s in
    10 ms blocks at real-time pace while a reader thread takes the audio
    that comes back, until SERVE_TCP_MIN_RETURN of its duration is back.
    Leaves the open client in out[i]."""
    import socket
    import threading
    from beatrice_vst_tpu_torch.runtime.netserver import MSG_AUDIO, VCClient, recv_frame

    rate = SERVE_TCP_RATES[i % len(SERVE_TCP_RATES)]
    c = VCClient(("127.0.0.1", port), sample_rate=float(rate), timeout=60.0)
    out[i] = {"client": c, "rate": rate}
    edits = [("voice", i % 8), ("pitch_shift", float(i % 5 - 2))]
    if i == 0:
        edits = [("voice", 8), ("pitch_shift", 1.0), ("morph_marker_count", 2.0),
                 ("morph_marker_0_voice", 1.0), ("morph_marker_1_voice", 5.0),
                 ("morph_cursor_x", 0.35)]
    for name, value in edits:
        reply = c.set_parameter(name, value)
        if not reply.get("ok"):
            raise AssertionError(f"serve_tcp client {i}: {name} = {value} refused: {reply}")
    rng = np.random.default_rng(100 + i)
    n = np.arange(int(SERVE_TCP_SECONDS * rate)) / rate
    f0 = 90.0 + 25.0 * i
    x = (0.3 * np.sin(2 * np.pi * (f0 * n + 40.0 * n * n))
         + 0.02 * rng.standard_normal(n.size)).astype(np.float32)
    block = rate // 100
    # the reader has its own socket object (a dup of the connection), so
    # its short waits for a frame never shorten the pusher's send timeout
    reader, got, first, stop = c.sock.dup(), [c.pull(0, timeout=0)], [], threading.Event()
    start = time.monotonic()

    def read():
        while not stop.is_set():
            reader.settimeout(0.05)
            try:
                head = reader.recv(1)
            except socket.timeout:
                continue
            if not head:
                return
            reader.settimeout(60.0)
            kind, payload = recv_frame(reader, head)
            if kind == MSG_AUDIO:
                got.append(np.frombuffer(payload, np.float32))
                if not first:
                    first.append(time.monotonic() - start)

    th = threading.Thread(target=read)
    th.start()
    late = 0.0
    try:
        for k in range(len(x) // block):
            c.push(x[k * block:(k + 1) * block])
            wait = start + (k + 1) * 0.01 - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            else:
                late = max(late, -wait)
        pushed_s = time.monotonic() - start
        deadline = time.monotonic() + SERVE_TCP_DRAIN_S
        while sum(map(len, got)) < SERVE_TCP_MIN_RETURN * len(x) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        stop.set()
        th.join(timeout=10)
        reader.close()
    y = np.concatenate(got) if got else np.zeros(0, np.float32)
    out[i].update(pushed=len(x), returned=len(y), first_audio_s=first[0] if first else None,
                  push_seconds=pushed_s, most_late_push_s=late,
                  finite=bool(np.isfinite(y).all()), peak=float(np.abs(y).max(initial=0.0)),
                  seconds=time.monotonic() - start)


def serve_tcp_phase(device, card, dtype):
    """The TCP server through its CLI entry point in a subprocess, with
    SERVE_TCP_CLIENTS clients on their own threads (tcp_client)."""
    import signal
    import subprocess
    import threading

    from beatrice_vst_tpu_torch.runtime.netserver import VCClient

    t0 = time.perf_counter()
    port = free_port()
    cmd = [sys.executable, "-m", "beatrice_vst_tpu_torch.cli", "serve", "--model", MODEL_DIR,
           "--capacity", str(SERVE_TCP_CAPACITY), "--port", str(port), "--device", device.type]
    if dtype:
        cmd += ["--dtype", dtype]
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    lines = {"out": [], "err": []}
    readers = [threading.Thread(target=lambda f, k: lines[k].extend(f), args=(f, k), daemon=True)
               for f, k in ((proc.stdout, "out"), (proc.stderr, "err"))]
    for r in readers:
        r.start()
    clients, threads = {}, []
    try:
        deadline = SERVE_TCP_STARTUP_S
        while not any("serving" in ln for ln in lines["out"]):
            if proc.poll() is not None or time.perf_counter() - t0 > deadline:
                raise AssertionError(f"serve_tcp {dtype}: the server did not start (rc "
                                     f"{proc.poll()}): {''.join(lines['err'])[-3000:]}")
            time.sleep(0.05)
        startup_s = time.perf_counter() - t0
        # the server idle (one probe session, no audio) until it has
        # ticked SERVE_TCP_IDLE_TICKS times: its tick span without clients
        # (the first ticks of a process are its slowest), and the tick
        # count the clients' window starts from
        probe = VCClient(("127.0.0.1", port), timeout=60.0)
        idle = probe.metrics()
        while idle["ticks"] < SERVE_TCP_IDLE_TICKS and time.perf_counter() - t0 < deadline:
            time.sleep(0.1)
            idle = probe.metrics()
        probe.close()
        t_clients = time.monotonic()
        failures = []

        def run(i):
            try:
                tcp_client(i, port, clients)
            except Exception as e:  # noqa: BLE001 -- reported and raised below
                failures.append(f"client {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=run, args=(i,)) for i in range(SERVE_TCP_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=SERVE_TCP_SECONDS + SERVE_TCP_DRAIN_S + 60)
        if failures or any(th.is_alive() for th in threads):
            raise AssertionError(f"serve_tcp {dtype}: {failures or 'a client hung'}")
        metrics = clients[0]["client"].metrics()
        window_s = time.monotonic() - t_clients
    finally:
        for th in threads:
            th.join(timeout=5)
        for rec in clients.values():
            rec["client"].close()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed after 60 s"
        for r in readers:
            r.join(timeout=10)
    stderr = "".join(lines["err"])
    form = dtype or "float32"
    other = "float32" if dtype else "bfloat16"
    launches = metrics["upsampler_kernel_launches"]
    report = {i: {k: v for k, v in rec.items() if k != "client"} for i, rec in clients.items()}
    bad = [i for i, r in report.items()
           if not r["returned"] or not r["finite"] or r["peak"] <= 1e-3]
    if len(report) != SERVE_TCP_CLIENTS or bad:
        raise AssertionError(f"serve_tcp {dtype}: clients {bad} got no audio, silent or "
                             f"non-finite audio: {report}")
    if "Traceback" in stderr or rc != 0:
        raise AssertionError(f"serve_tcp {dtype}: server rc {rc}, stderr {stderr[-3000:]}")
    serving_health(f"serve_tcp {dtype}", metrics)
    # one launch a tick (the graph's warm-up ticks included), within the
    # one tick that may run between the two reads
    warmup = metrics.get("graph_warmup_ticks", 0)
    if not metrics["ticks"] or not 0 <= launches[form] - metrics["ticks"] - warmup <= 1 \
            or launches[other]:
        raise AssertionError(f"serve_tcp {dtype}: kernel launches {launches} for "
                             f"{metrics['ticks']} ticks and {warmup} warm-up ticks")
    log("serve_tcp", t0, model="klatt8", dtype=form, capacity=SERVE_TCP_CAPACITY,
        clients=SERVE_TCP_CLIENTS, audio_seconds_per_client=SERVE_TCP_SECONDS,
        server_startup_s=startup_s, ticks=metrics["ticks"], graph_warmup_ticks=warmup,
        kernel_launches=launches,
        serve_tick_p50_ms=metrics["serve_tick_p50_ms"],
        serve_tick_p90_ms=metrics["serve_tick_p90_ms"],
        serve_ticks_per_s=metrics.get("serve_ticks_per_s"),
        idle_serve_tick_p50_ms=idle["serve_tick_p50_ms"], idle_ticks=idle["ticks"],
        ticks_per_s_with_clients=(metrics["ticks"] - idle["ticks"]) / window_s,
        engine_enqueue_p50_ms=metrics["tick_p50_ms"], engine_underruns=metrics["underruns"],
        session_underruns=metrics["session_underruns"],
        session_dropped_in=metrics["session_dropped_in"],
        session_dropped_out=metrics["session_dropped_out"], clients_report=report,
        server_rc=rc, nvidia_smi=card)


def control_rows(engine, idx, after_ticks):
    """Stream idx's control values on the engine, once it has ticked
    `after_ticks` more times (each tick flushes the staged edits first)."""
    start = engine.metrics.ticks
    deadline = time.monotonic() + 60
    while engine.metrics.ticks < start + after_ticks:
        if time.monotonic() > deadline:
            raise AssertionError("serve_ws: the engine stopped ticking")
        time.sleep(0.01)
    c = engine.state["controls"]
    return {f: c[f][idx].item() for f in ("target_speaker", "pitch_shift", "formant_index",
                                          "active")}


def serve_ws_phase(device, card):
    """An in-process WebSocket server over a realtime ModelHost with one
    client: a round trip, a model swap with its controls replayed, audio
    after the swap.  Returns the f32 form's launches."""
    import threading
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.runtime import ModelHost
    from beatrice_vst_tpu_torch.runtime.wsserver import WSClient, WSServer

    t0 = time.perf_counter()
    reset_launch_counts()
    host = ModelHost(capacity=SERVE_WS_CAPACITY, realtime=True, device=device)
    if host.load_model(MODEL_DIR) != 0:
        raise AssertionError("serve_ws: klatt8 did not load")
    srv = WSServer(("127.0.0.1", 0), host)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    audio = golden.serve_signal(48000, 1)
    try:
        c = WSClient(srv.server_address, sample_rate=48000.0)
        for name, value in (("voice", 3), ("pitch_shift", 2.0), ("formant_shift", 0.5)):
            if not c.set_parameter(name, value).get("ok"):
                raise AssertionError(f"serve_ws: {name} refused")
        idx = next(iter(host.sessions.values())).stream.idx
        c.push(audio)
        before_out = c.pull(len(audio) - 960, timeout=60.0)
        old = host.engine
        before = control_rows(old, idx, 2)
        reply = c.set_parameter("model", SWAP_MODEL)
        new = host.engine
        if not reply.get("ok") or new is old:
            raise AssertionError(f"serve_ws: the swap failed: {reply}")
        idx_new = next(iter(host.sessions.values())).stream.idx
        after = control_rows(new, idx_new, 3)
        if after != before:
            raise AssertionError(f"serve_ws: controls before the swap {before}, after {after}")
        c.push(audio)
        after_out = c.pull(len(audio) - 960, timeout=60.0)
        metrics = c.metrics()
        running = host.server.running
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        host.stop()
    for label, y in (("before", before_out), ("after", after_out)):
        if len(y) < len(audio) - 960 or not np.isfinite(y).all() or np.abs(y).max() <= 1e-3:
            raise AssertionError(f"serve_ws: audio {label} the swap: {len(y)} samples, "
                                 "not finite or silent")
    serving_health("serve_ws", metrics, running)
    for eng in (old, new):
        serving_health("serve_ws", eng.metrics_snapshot())
    counts = launch_counts()
    ticks = old.metrics.ticks + new.metrics.ticks
    warmup = sum(e.counters.get("graph_warmup_ticks", 0) for e in (old, new))
    want = {**dict.fromkeys(counts, 0), "float32": ticks + warmup}
    if counts != want or not old.metrics.ticks or not new.metrics.ticks:
        raise AssertionError(f"serve_ws: kernel launches {counts}, engine ticks "
                             f"{old.metrics.ticks} + {new.metrics.ticks}")
    log("serve_ws", t0, models=["klatt8", "klatt8_r6"], capacity=SERVE_WS_CAPACITY,
        ticks_before_swap=old.metrics.ticks, ticks_after_swap=new.metrics.ticks,
        graph_warmup_ticks=warmup, graph_after_swap=new._graph is not None, launches=counts, controls=before, serve_tick_p50_ms=metrics["serve_tick_p50_ms"],
        nvidia_smi=card)
    return counts["float32"]


SOAK_FRAMES = 6000  # one minute a leg
SOAK_CHUNK = 600  # leg a's frames a tick of the chunk path, the JAX soak's default
LATENCY_SESSIONS = 4
LATENCY_CAPACITY = 8
LATENCY_SECONDS = 10.0
LATENCY_PACE_MS = 10.0  # the product cadence
LATENCY_MIN_DETECTION = 0.9


def soak_phase(device, card, by_path):
    """The long-stream soak's two legs for SOAK_FRAMES frames each (leg a
    with the float64 oracle over all of them), each leg's launches
    counted apart: every gate must hold, and the f32 form must have
    launched once a T = 1 tick and warm-up tick (a chunk engine runs
    the stage loop), a flip's replay included.  A flip that is a tie is
    held, as the soak holds it; any other fails its gate.  Adds each leg's
    launches to by_path."""
    from beatrice_vst_tpu_torch.models.io import load_model_dir
    from beatrice_vst_tpu_torch.runtime.engine import GRAPH_WARMUP_TICKS
    from beatrice_vst_tpu_torch.scripts import long_stream_soak as soak

    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    for leg, streams, chunk, oracle_frames in (("a", 2, SOAK_CHUNK, SOAK_FRAMES),
                                               ("b", soak.STREAMS_B, soak.CHUNK_FRAMES_B, 0)):
        t0 = time.perf_counter()
        reset_launch_counts()
        lines = []
        rep = soak.run_leg(params, bank, cfg, streams, SOAK_FRAMES, chunk, oracle_frames,
                           device=device, log=lines.append)
        counts = launch_counts()
        # and the T = 1 ticks of the flips' replays (`locate_flips`)
        want = {**dict.fromkeys(counts, 0), "float32": SOAK_FRAMES + GRAPH_WARMUP_TICKS
                + rep["flip_replay_t1_ticks"]}
        if not all(rep["gates"].values()) or counts != want:
            raise AssertionError(f"soak leg {leg}: gates {rep['gates']}, launches {counts} "
                                 f"(expected {want}); {lines}")
        by_path["float32"][f"soak_{leg}"] = counts["float32"]
        log("soak", t0, leg=leg, launches=counts, **rep, nvidia_smi=card)


def latency_phase(device, card, by_path):
    """The latency probe at the product cadence: raises unless it detects
    more than LATENCY_MIN_DETECTION of its bursts and the f32 form
    launched once a tick and warm-up tick of its engine.  Adds the
    launches to by_path."""
    from beatrice_vst_tpu_torch.scripts import latency_probe as probe

    t0 = time.perf_counter()
    reset_launch_counts()
    rep = probe.run_probe(MODEL_DIR, LATENCY_SESSIONS, LATENCY_SECONDS, LATENCY_CAPACITY,
                          pace_ms=LATENCY_PACE_MS, device=device, log=lambda s: None)
    counts = launch_counts()
    want = {**dict.fromkeys(counts, 0),
            "float32": rep["engine_ticks"] + rep["graph_warmup_ticks"]}
    if not rep["burst_detection_ratio"] > LATENCY_MIN_DETECTION or counts != want:
        raise AssertionError(f"latency: detection {rep['burst_detection_ratio']}, launches "
                             f"{counts} (expected {want}): {rep}")
    by_path["float32"]["latency"] = counts["float32"]
    log("latency", t0, launches=counts, probe_seconds=rep["seconds"],
        **{k: v for k, v in rep.items() if k not in ("note", "seconds")}, nvidia_smi=card)


def profile_phase(device, out_dir, config, ticks=20):
    """Where the engine's tick time goes in one configuration: `ticks`
    ticks at capacity 256 under torch.profiler after warm-up.  Prints
    device-busy and host time per tick, kernel launches per tick and the
    kernels with the most device time; writes the table and a gzipped
    Chrome trace to `out_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    audio = engine_audio(device)
    engine = build_engine(device, config)
    for k in range(WARMUP_TICKS):
        engine.tick(audio[k])
    torch.cuda.synchronize()
    host = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for k in range(WARMUP_TICKS, WARMUP_TICKS + ticks):
            t = time.perf_counter()
            engine.tick(audio[k])
            host.append((time.perf_counter() - t) * 1e3)
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / ticks

    # device-side events only: an operator's row repeats the time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / ticks / 1e3, e.count / ticks)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"tick_trace_{config}.json.gz"))
    table = [{"kernel": k[:120], "ms_per_tick": ms, "launches_per_tick": n} for k, ms, n in rows]
    with open(os.path.join(out_dir, f"tick_profile_{config}.json"), "w") as f:
        json.dump({"config": config, "capacity": CAPACITY, "ticks": ticks,
                   "span_ms_per_tick": span_ms, "device_busy_ms_per_tick": busy_ms,
                   "host_ms_per_tick": float(np.median(host)), "kernels": table}, f, indent=1)
    upsampler_ms = sum(ms for k, ms, _ in rows if "fused_upsampler" in k)
    log("profile", t0, config=config, capacity=CAPACITY, ticks=ticks,
        span_ms_per_tick=span_ms, upsampler_kernel_ms_per_tick=upsampler_ms,
        device_busy_ms_per_tick=busy_ms, idle_share=1.0 - busy_ms / span_ms,
        median_host_ms_per_tick=float(np.median(host)),
        device_launches_per_tick=sum(r[2] for r in rows), top=table[:12])


TRAIN_GOLDEN = os.path.join(HERE, "tests", "data", "torch_train_golden.npz")
SEQPAR_GOLDEN = os.path.join(HERE, "tests", "data", "torch_seqpar_golden.npz")
TRAIN_STEPS = 30
TRAIN_BATCH = 8  # the CLI's defaults
TRAIN_FRAMES = 32
TRAIN_RESUME_STEP = 15
TRAIN_RESUME_RTOL = 1e-6
TRAIN_DATA_STEPS = 10
TRAIN_DATA_TIMEOUT_S = 600
SEQPAR_SECONDS = 20.0
SEQPAR_SEGMENTS = (4, 8)


def klatt8_numpy():
    """(model config, params, bank) of klatt8 as numpy arrays."""
    from beatrice_vst_tpu_torch.models.io import load_model_dir

    _, cfg, params, bank = load_model_dir(MODEL_DIR)
    return cfg, params, bank


def no_upsampler_launches(label):
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: the fused upsampler was launched: {counts}")
    return counts


def train_golden_phase(device, card):
    """One distillation step and one GAN step (and each one's second step)
    on klatt8 on the batch stored in tests/data/torch_train_golden.npz,
    against the JAX package's losses and per-leaf gradient norms there
    (golden.train_gate: losses at 1e-4 relative, gradient norms at 1e-3)."""
    from beatrice_vst_tpu_torch import golden

    t0 = time.perf_counter()
    cfg, params, bank = klatt8_numpy()
    want = golden.load(TRAIN_GOLDEN)
    batch = {k: want[f"batch/{k}"] for k in ("audio16", "target24", "f0_bin")}
    reset_launch_counts()
    got = golden.run_train(cfg, params, bank, device, batch)
    counts = no_upsampler_launches("train_golden")
    worst, failed = {}, []
    for key, value in got.items():
        ok, dev, bound = golden.train_gate(key, value, float(want[key]))
        kind = key.split("/")[0] + ("/grad" if "grad/" in key else "/loss")
        if dev > worst.get(kind, (0.0, ""))[0]:
            worst[kind] = (dev, key)
        if not ok:
            failed.append((key, value, float(want[key]), dev, bound))
    if failed:
        raise AssertionError(f"train_golden: {len(failed)} numbers off the golden file: "
                             f"{failed[:8]}")
    log("train_golden", t0, model="klatt8", batch=list(batch["audio16"].shape),
        numbers=len(got), worst=worst, losses={k: v for k, v in got.items() if "grad" not in k},
        loss_rtol=golden.TRAIN_LOSS_RTOL, grad_rtol=golden.TRAIN_GRAD_RTOL,
        kernel_launches=counts, nvidia_smi=card)


def _train_run(device, kind, params, cfg, batch, steps, **kw):
    """`train` or `train_gan` over `steps` copies of one batch: (history
    [(step, loss)], seconds, peak MiB above the memory live before)."""
    import itertools

    import torch
    from beatrice_vst_tpu_torch.training import train, train_gan

    fn = train_gan if kind == "gan" else train
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, history = fn(params, cfg, itertools.repeat(batch), steps=steps, log_every=1,
                    log_fn=lambda *_: None, device=device, **kw)
    torch.cuda.synchronize()
    return history, time.perf_counter() - t, (torch.cuda.max_memory_allocated() - base) / 2**20


def train_phase(device, card):
    """`train` and `train_gan` on klatt8 at the CLI's defaults (batch 8, 32
    frames) for 30 steps each on one teacher batch: the loss finite and
    lower at the end than at step 0; steps per second, audio seconds per
    second, peak MiB; a run of 15 steps, checkpointed at its end and
    resumed, repeats steps 15-29 of the straight run within 1e-6 relative
    (deterministic algorithms on); the fused upsampler never launched."""
    import tempfile

    import torch
    from beatrice_vst_tpu_torch.models import chain
    from beatrice_vst_tpu_torch.training import make_teacher_batcher

    t0 = time.perf_counter()
    cfg, params, bank = klatt8_numpy()
    teacher = chain.init(torch.Generator().manual_seed(1), cfg, "cpu")
    batch = next(make_teacher_batcher(cfg, teacher, bank, batch=TRAIN_BATCH,
                                      frames=TRAIN_FRAMES, seed=0, device=device))
    audio_s = TRAIN_BATCH * TRAIN_FRAMES * 0.010
    torch.use_deterministic_algorithms(True, warn_only=True)
    reset_launch_counts()
    out = {}
    try:
        for kind in ("distill", "gan"):
            history, seconds, peak = _train_run(device, kind, params, cfg, batch, TRAIN_STEPS)
            losses = [loss for _, loss in history]
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                raise AssertionError(f"train {kind}: losses {losses}")
            with tempfile.TemporaryDirectory() as d:
                _train_run(device, kind, params, cfg, batch, TRAIN_RESUME_STEP, ckpt_dir=d)
                resumed, _, _ = _train_run(device, kind, params, cfg, batch, TRAIN_STEPS,
                                           ckpt_dir=d, resume=True)
            straight = dict(history)
            dev = max(abs(loss - straight[s]) / abs(straight[s]) for s, loss in resumed)
            if [s for s, _ in resumed] != list(range(TRAIN_RESUME_STEP, TRAIN_STEPS)) or \
                    not dev <= TRAIN_RESUME_RTOL:
                raise AssertionError(f"train {kind}: the resumed run deviates by {dev} "
                                     f"(steps {[s for s, _ in resumed]})")
            out[kind] = {"loss_first": losses[0], "loss_last": losses[-1],
                         "steps_per_s": TRAIN_STEPS / seconds,
                         "audio_seconds_per_s": TRAIN_STEPS * audio_s / seconds,
                         "seconds": seconds, "peak_mib": peak, "resume_max_rel_dev": dev}
    finally:
        torch.use_deterministic_algorithms(False)
    counts = no_upsampler_launches("train")
    log("train", t0, model="klatt8", batch=TRAIN_BATCH, frames=TRAIN_FRAMES,
        steps=TRAIN_STEPS, resume_step=TRAIN_RESUME_STEP, runs=out,
        kernel_launches=counts, nvidia_smi=card)


def make_pairs(root):
    """A small parallel corpus made by the port's synthesis.py, laid out
    as scripts/make_corpus.py lays out its pairs: inputs/, targets/,
    speakers.json and f0_plan.npz.  Returns the pairs directory."""
    from beatrice_vst_tpu_torch.audio_io import write_wav
    from beatrice_vst_tpu_torch.training.synthesis import (SR, default_speakers,
                                                            plan_f0_voiced, render,
                                                            sample_utterance)

    speakers = default_speakers(3)
    pairs = os.path.join(root, "pairs")
    for sub in ("inputs", "targets"):
        os.makedirs(os.path.join(pairs, sub))
    rng = np.random.default_rng(0)
    spk_map, plan = {}, {}
    for j in range(4):
        segs, f0 = sample_utterance(rng)
        renders = [render(segs, f0, spk, np.random.default_rng(131 * j + k), SR)
                   for k, spk in enumerate(speakers)]
        for s, t in ((0, 1), (1, 2), (2, 0)):
            name = f"u{j:03d}_s{s}_t{t}"
            write_wav(os.path.join(pairs, "inputs", name + ".wav"), renders[s], SR)
            write_wav(os.path.join(pairs, "targets", name + ".wav"), renders[t], SR)
            spk_map[name] = t
            plan[name] = plan_f0_voiced(segs, f0)
    with open(os.path.join(pairs, "speakers.json"), "w") as f:
        json.dump(spk_map, f)
    np.savez(os.path.join(pairs, "f0_plan.npz"), **plan)
    return pairs


def train_data_phase(device, card):
    """A corpus from the port's synthesis.py, then PairDataset and
    make_pair_batcher (one batch: shapes, finite, the speakers' cond rows),
    then `cli train --data` for 10 steps in a subprocess that exits 0 and
    writes a weights.npz the port loads, with klatt8's tree."""
    import tempfile

    import torch
    from beatrice_vst_tpu_torch.models.io import flatten_params, load_weights
    from beatrice_vst_tpu_torch.training import PairDataset, make_pair_batcher

    t0 = time.perf_counter()
    cfg, params, bank = klatt8_numpy()
    with tempfile.TemporaryDirectory() as root:
        pairs = make_pairs(root)
        corpus_s = time.perf_counter() - t0
        ds = PairDataset(pairs)
        batch = next(make_pair_batcher(ds, cfg, bank, batch=TRAIN_BATCH, frames=TRAIN_FRAMES,
                                       seed=0, prefetch=0, device=device))
        shapes = {k: list(batch[k].shape) for k in ("audio16", "target24", "f0_bin")}
        if shapes != {"audio16": [TRAIN_BATCH, TRAIN_FRAMES * 160],
                      "target24": [TRAIN_BATCH, TRAIN_FRAMES * 240],
                      "f0_bin": [TRAIN_BATCH, TRAIN_FRAMES]} or \
                not all(bool(torch.isfinite(batch[k]).all()) for k in ("audio16", "target24")):
            raise AssertionError(f"train_data: batch {shapes}")
        out = os.path.join(root, "weights.npz")
        cmd = [sys.executable, "-m", "beatrice_vst_tpu_torch.cli", "train", "--model",
               MODEL_DIR, "--data", pairs, "--steps", str(TRAIN_DATA_STEPS), "--output", out]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                              timeout=TRAIN_DATA_TIMEOUT_S)
        cli_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"cli train --data exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        trained = flatten_params(load_weights(out, device="cpu"))
        ref = flatten_params(params)
        if sorted(trained) != sorted(ref) or not all(
                tuple(trained[k].shape) == ref[k].shape and bool(torch.isfinite(trained[k]).all())
                for k in ref):
            raise AssertionError("cli train --data: weights.npz is not klatt8's tree")
    log("train_data", t0, utterances=len(ds.items), frames=ds.n_frames_total(),
        identity_mode=ds.identity_mode, corpus_seconds=corpus_s, batch=shapes,
        cli_steps=TRAIN_DATA_STEPS, cli_seconds=cli_s,
        cli_last_line=proc.stdout.strip().splitlines()[-1], nvidia_smi=card)


QUALITY_GOLDEN = os.path.join(HERE, "tests", "data", "torch_quality_golden.json")
QUALITY_UTTS = (45, 46)  # the first two held-out utterances: 12 of the golden file's 30 pairs
TRAIN_REAL_STEPS = 20
TRAIN_REAL_GAN_STEPS = 10
TRAIN_REAL_TIMEOUT_S = 600
R6_FLAGS = ("--f0-weight", "4", "--register-boost", "3", "--periodicity-weight", "2")


def quality_phase(device, card):
    """quality_eval's pairs of the held-out utterances 45 and 46 on klatt8
    (from their renditions, as the seed-0 corpus holds them), with and
    without soft pitch, and ood_eval's first noise (20 dB) and register
    (330 Hz) rows, each held to tests/data/torch_quality_golden.json (the
    JAX package's rows on the CPU): the model-free rows exactly, each
    converted row's MCD and LSD within 0.05 dB, voicing within 0.02 and
    F0 RMSE within 5 cents unless the tracker's decisions differ only at
    near-ties (located against the port's conversion on the CPU, and
    reported); the count of pairs worse than do-nothing equal; the
    kernel's forms never launched (the conversions run the stage loop)."""
    import tempfile

    from beatrice_vst_tpu_torch.scripts import make_corpus
    from beatrice_vst_tpu_torch.scripts import ood_eval as O
    from beatrice_vst_tpu_torch.scripts import quality_eval as Q

    t0 = time.perf_counter()
    golden = Q.load_golden(QUALITY_GOLDEN)
    model = Q.load_model(MODEL_DIR, device)
    with tempfile.TemporaryDirectory() as root:
        make_corpus.write_renditions(root, QUALITY_UTTS)
        corpus = Q.load_corpus(root)
        corpus_s = time.perf_counter() - t0
        pairs = [(r["utt"], r["src"], r["tgt"]) for r in golden["quality"]["pairs"]
                 if r["utt"] in QUALITY_UTTS]
        watch = Q.CaptureWatch()
        reset_launch_counts()
        t = time.perf_counter()
        rows = [Q.score_pair(model, corpus, j, s, t_, soft_ab=True) for j, s, t_ in pairs]
        # each condition's first case, as ood_eval scores it
        conditions = O.flagship_conditions(corpus)
        ood = {name: O.aggregate([O.score_case(model, next(conditions[name]),
                                               corpus.sample_rate)])
               for name in ("noise_snr_20db", "unseen_f0_high_330hz")}
        scored_s = time.perf_counter() - t
        counts = no_upsampler_launches("quality")
        captures = watch.stats()
        res = Q.golden_failures(model, corpus, rows, golden, subset=True)
        res_ood = O.golden_failures(model, None, corpus, ood, golden, subset=True)
    failures = res["failures"] + res_ood["failures"]
    ties = res["ties"] + res_ood["ties"]
    if failures:
        raise AssertionError(f"quality: {len(failures)} rows off the golden file: "
                             f"{failures[:8]}; ties {ties}")
    want = {Q.row_key(r): r for r in golden["quality"]["pairs"]}
    worst = {key: {m: max(abs(r[key][m] - want[Q.row_key(r)][key][m]) for r in rows
                          if r[key][m] is not None)
                   for m in Q.METRICS} for key in ("converted", "converted_soft")}
    log("quality", t0, model="klatt8", utterances=list(QUALITY_UTTS), pairs=len(rows),
        ood_rows=sorted(ood), checked=res["checked"] + res_ood["checked"], ties=ties,
        worse_than_do_nothing=res["worse_than_do_nothing"], worst_deviation=worst,
        summary=Q.summarize(rows), corpus_seconds=corpus_s, scored_seconds=scored_s,
        conversions=2 * len(rows) + len(ood), compiled_steps=captures,
        kernel_launches=counts, nvidia_smi=card)


def train_real_phase(device, card):
    """`python -m beatrice_vst_tpu_torch.scripts.train_real_model` with the
    r6 recipe's flags at batch 16 x 64 frames, TRAIN_REAL_STEPS distillation
    and TRAIN_REAL_GAN_STEPS GAN steps, resuming a copy of klatt8 on a small
    corpus (4 utterances by the 8 speakers, 48 pairs) from the port's
    make_corpus: exit 0, finite losses, the JAX report's keys, the kernel's
    forms never launched in the script's process."""
    import shutil
    import tempfile

    from beatrice_vst_tpu_torch.scripts import make_corpus

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        corpus = os.path.join(root, "corpus")
        manifest = make_corpus.make_corpus(corpus, utts=4, eval_utts=1, log=lambda _: None)
        model = os.path.join(root, "model")
        shutil.copytree(MODEL_DIR, model)
        report = os.path.join(root, "report.json")
        cmd = [sys.executable, "-m", "beatrice_vst_tpu_torch.scripts.train_real_model",
               "--corpus", corpus, "--out", model, "--resume", "--steps", str(TRAIN_REAL_STEPS),
               "--gan-steps", str(TRAIN_REAL_GAN_STEPS), *R6_FLAGS, "--report", report,
               "--ckpt-dir", os.path.join(root, "ckpt")]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                              timeout=TRAIN_REAL_TIMEOUT_S)
        script_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"train_real_model exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        with open(report) as f:
            got = json.load(f)
    with open(os.path.join(HERE, "docs", "TRAIN_R6_REPORT.json")) as f:
        keys = set(json.load(f)) - {"bursts"}
    losses = [v for _, v in got["distill"]["loss_curve"] + got["gan"]["g_loss_curve"]]
    if not keys <= set(got) or not np.isfinite(losses).all() or \
            (got["distill"]["steps_executed"], got["gan"]["steps_executed"]) != \
            (TRAIN_REAL_STEPS, TRAIN_REAL_GAN_STEPS) or any(got["upsampler_kernel_launches"].values()):
        raise AssertionError(f"train_real: report {sorted(got)}, losses {losses}, launches "
                             f"{got['upsampler_kernel_launches']}")
    log("train_real", t0, batch=got["batch"], frames=got["frames_per_example"],
        pairs=manifest["n_pairs"], steps=[TRAIN_REAL_STEPS, TRAIN_REAL_GAN_STEPS],
        loss_curve=got["distill"]["loss_curve"], g_loss_curve=got["gan"]["g_loss_curve"],
        distill={k: got["distill"].get(k) for k in ("wall_s", "steps_per_s", "peak_mib",
                                                    "compiled_steps")},
        gan={k: got["gan"].get(k) for k in ("wall_s", "steps_per_s", "peak_mib",
                                            "compiled_steps")},
        script_seconds=script_s, kernel_launches=got["upsampler_kernel_launches"],
        nvidia_smi=card)


def seqpar_phase(device, card):
    """convert_utterance_sp on klatt8: the golden signal at 4 segments
    against tests/data/torch_seqpar_golden.npz (the JAX package's), and a
    20 s signal at 4 and 8 segments against the port's convert_utterance,
    each at atol 1e-3; audio seconds per second of each, on the second of
    two runs."""
    import torch
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance
    from beatrice_vst_tpu_torch.runtime.seqpar import (chain_receptive_field_frames,
                                                       convert_utterance_sp)

    t0 = time.perf_counter()
    cfg, _, _ = klatt8_numpy()
    # tensors on the card: the compiled steps (keyed by the parameters'
    # identity) of the first run serve the second
    params, bank = klatt8(device)
    settings = ConversionSettings(**golden.OFFLINE_SETTINGS)
    rate = golden.OFFLINE_RATE
    reset_launch_counts()

    def timed(fn, audio):
        seconds = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = fn(audio)
            seconds.append(time.perf_counter() - t)
        return y, len(audio) / rate / seconds[-1]

    got = convert_utterance_sp(params, cfg, bank, golden.offline_signal(), rate, settings,
                               n_segments=golden.SEQPAR_SEGMENTS, device=device)
    vs_golden = golden.deviation(got, golden.load(SEQPAR_GOLDEN)["f32"])
    if not vs_golden["max"] <= golden.F32_ATOL:
        raise AssertionError(f"seqpar vs the golden file: {vs_golden}")
    long = golden.offline_signal(seconds=SEQPAR_SECONDS)
    ref, ref_rate = timed(lambda a: convert_utterance(params, cfg, bank, a, rate, settings,
                                                      device=device), long)
    runs = {}
    for n in SEQPAR_SEGMENTS:
        y, r = timed(lambda a: convert_utterance_sp(params, cfg, bank, a, rate, settings,
                                                    n_segments=n, device=device), long)
        dev = golden.deviation(y, ref)
        if y.shape != ref.shape or not dev["max"] <= golden.F32_ATOL:
            raise AssertionError(f"seqpar {n} segments vs convert_utterance: {dev}")
        runs[n] = {"vs_sequential": dev, "audio_seconds_per_s": r}
    counts = no_upsampler_launches("seqpar")
    log("seqpar", t0, model="klatt8", rate=rate, warmup_frames=chain_receptive_field_frames(cfg),
        golden_vs=vs_golden, audio_seconds=SEQPAR_SECONDS, sequential_audio_seconds_per_s=ref_rate,
        segments=runs, tol=golden.F32_ATOL, kernel_launches=counts, nvidia_smi=card)


# ---- the compiled offline, seqpar, parity and training steps ----

# name -> (seconds, chunk_frames: None auto (256-frame chunks beyond 384
# frames), 0 whole; compute dtype)
OFFLINE_GRAPH_CASES = {
    "chunked_20s_f32": (20.0, None, None),
    "chunked_20s_bf16": (20.0, None, "bfloat16"),
    "whole_1.5s_f32": (1.5, 0, None),
    "whole_1.5s_bf16": (1.5, 0, "bfloat16"),
}
SEQPAR_GRAPH_SEGMENTS = 4
TRAIN_GRAPH_STEPS = 8
TRAIN_GRAPH_RESUME_STEP = 4
# compiled against eager training, every logged loss (relative): the same
# kernels in the same order under deterministic algorithms (0 expected);
# the bound is the golden file's loss gate, golden.TRAIN_LOSS_RTOL
TRAIN_GRAPH_RTOL = 1e-4
FEATURE_GRAPH_STEPS = 4
SWAP_MODEL_DIR = os.path.join(HERE, "models_demo", "klatt8_r6")


def compiled_steps_stats():
    """The steps in the step cache: how many and their capture ms."""
    from beatrice_vst_tpu_torch.runtime import graphs

    steps = graphs.CACHE.steps()
    return {"captures": len(steps), "capture_ms": [s.capture_ms for s in steps],
            "capture_ms_total": sum(s.capture_ms for s in steps)}


def timed_call(fn):
    """(fn's result, host seconds to the end of its device work, peak MiB
    above the memory live before, MiB still allocated after above it)."""
    import torch

    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return (out, seconds, (torch.cuda.max_memory_allocated() - live) / 2**20,
            (torch.cuda.memory_allocated() - live) / 2**20)


def graph_vs_eager(run, audio_seconds):
    """`run(jit)` compiled against eager: eager first (it builds the lazily
    made constants), the compiled first call (it captures; the step cache
    emptied before it), then eager, compiled, compiled, eager.  Every
    output against the first eager one (max |d|); audio seconds per second
    of each on the median of its two timed calls; the first compiled
    call's seconds (capture included), captures and capture ms; each one's
    peak MiB and the MiB the compiled steps keep."""
    from beatrice_vst_tpu_torch.runtime import graphs

    graphs.CACHE.clear()
    ref, eager_first_s, eager_peak, _ = timed_call(lambda: run(False))
    got, first_s, capture_peak, kept = timed_call(lambda: run(True))
    stats = compiled_steps_stats()
    diff = float(np.abs(got - ref).max())
    seconds = {"graph": [], "eager": []}
    replay_peak = 0.0
    for jit in (False, True, True, False):
        y, s, peak, _ = timed_call(lambda: run(jit))
        seconds["graph" if jit else "eager"].append(s)
        if jit:
            replay_peak = max(replay_peak, peak)
        diff = max(diff, float(np.abs(y - ref).max()))
    if not diff <= GRAPH_TOL:
        raise AssertionError(f"compiled vs eager: max|d| {diff} > {GRAPH_TOL}")
    if not np.isfinite(ref).all() or np.abs(ref).max() <= 1e-3:
        raise AssertionError("compiled vs eager: output not finite or silent")
    return ref, {
        "max_abs_diff_graph_vs_eager": diff, "tol": GRAPH_TOL,
        "graph_audio_seconds_per_s": audio_seconds / float(np.median(seconds["graph"])),
        "eager_audio_seconds_per_s": audio_seconds / float(np.median(seconds["eager"])),
        "graph_seconds": seconds["graph"], "eager_seconds": seconds["eager"],
        "first_graph_call_s": first_s, "first_eager_call_s": eager_first_s, **stats,
        "eager_peak_mib": eager_peak, "capture_peak_mib": capture_peak,
        "replay_peak_mib": replay_peak, "compiled_steps_kept_mib": kept}


def offline_graph_phase(device, card):
    """convert_utterance compiled (the default) against eager (jit=False)
    on klatt8: 20 s at 44.1 kHz chunked and 1.5 s whole, f32 and bf16
    (graph_vs_eager); then the two-model check: klatt8 and klatt8_r6 (the
    same shapes), each compiled conversion bitwise equal to its own eager
    one and the two models' outputs apart.  The fused upsampler never
    launched (T > 1 runs the stage loop)."""
    import torch
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.models.io import load_model_dir, params_from_numpy
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings, convert_utterance

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    cfg = VoiceConverterConfig.for_version(V20RC0)
    settings = ConversionSettings(**golden.OFFLINE_SETTINGS)
    rate = golden.OFFLINE_RATE
    reset_launch_counts()
    cases = {}
    for name, (seconds, chunk, dtype) in OFFLINE_GRAPH_CASES.items():
        sig = golden.offline_signal(seconds=seconds)
        cd = getattr(torch, dtype) if dtype else None
        _, cases[name] = graph_vs_eager(
            lambda jit: convert_utterance(params, cfg, bank, sig, rate, settings,
                                          compute_dtype=cd, chunk_frames=chunk, device=device,
                                          jit=jit), seconds)
    sig = golden.offline_signal()
    models = {}
    for name, d in (("klatt8", MODEL_DIR), ("klatt8_r6", SWAP_MODEL_DIR)):
        _, mcfg, mparams, mbank = load_model_dir(d)
        mparams = params_from_numpy(mparams, device)
        got, want = (convert_utterance(mparams, mcfg, mbank, sig, rate, settings,
                                       chunk_frames=golden.OFFLINE_CHUNK_FRAMES, device=device,
                                       jit=jit) for jit in (True, False))
        diff = float(np.abs(got - want).max())
        if not diff <= GRAPH_TOL:
            raise AssertionError(f"offline {name}: compiled vs its own eager run: max|d| {diff}")
        models[name] = got
    apart = float(np.abs(models["klatt8"] - models["klatt8_r6"]).max())
    if not apart > 1e-3:
        raise AssertionError(f"offline: klatt8 and klatt8_r6 convert alike ({apart}): a step "
                             "read the other model's parameters")
    counts = no_upsampler_launches("offline_graph")
    log("offline_graph", t0, model="klatt8", rate=rate, cases=cases,
        two_models={"max_abs_diff_each_vs_own_eager": 0.0, "max_abs_diff_between": apart},
        kernel_launches=counts, nvidia_smi=card)


def seqpar_graph_phase(device, card):
    """convert_utterance_sp at SEQPAR_GRAPH_SEGMENTS segments on 20 s of
    klatt8 input, compiled (the default without a mesh: both passes and
    the resamplers) against eager (graph_vs_eager)."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings
    from beatrice_vst_tpu_torch.runtime.seqpar import convert_utterance_sp

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    cfg = VoiceConverterConfig.for_version(V20RC0)
    settings = ConversionSettings(**golden.OFFLINE_SETTINGS)
    sig = golden.offline_signal(seconds=SEQPAR_SECONDS)
    reset_launch_counts()
    _, out = graph_vs_eager(
        lambda jit: convert_utterance_sp(params, cfg, bank, sig, golden.OFFLINE_RATE, settings,
                                         n_segments=SEQPAR_GRAPH_SEGMENTS, device=device,
                                         jit=jit), SEQPAR_SECONDS)
    counts = no_upsampler_launches("seqpar_graph")
    log("seqpar_graph", t0, model="klatt8", segments=SEQPAR_GRAPH_SEGMENTS,
        audio_seconds=SEQPAR_SECONDS, **out, kernel_launches=counts, nvidia_smi=card)


def parity_graph_phase(device, card):
    """The kernel inside a compiled path: run_parity on klatt8, slots f32, capacity
    256, T = 25, with the compiled streaming half (jit=True: one CUDA graph
    over the donated tick, replayed once a frame) against the eager one
    (jit=False), in the order graph, eager, eager, graph, the launch counts
    set to 0 just before each compiled run and read just after.  Gates:
    each report within PARITY_TOL, the compiled report's max |d| and RMS
    equal to the eager one's (the same streaming outputs), the f32 form
    launched once per frame in the streaming ticks (replays counted),
    GRAPH_WARMUP_CALLS times in the capture and never in the chunk tick.
    Reported: each half's span per 10 ms of audio, host ms, the capture's
    span and host ms, peak MiB.  Returns the f32 form's launches of the
    compiled runs."""
    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.models.chain import VoiceConverterConfig
    from beatrice_vst_tpu_torch.parity import run_parity

    t0 = time.perf_counter()
    params, bank = klatt8(device)
    cfg = VoiceConverterConfig.for_version(V20RC0)
    audio = utterance(engine_audio(device, CHUNK))
    runs = {"graph": [], "eager": []}
    reports = {}
    launches = 0
    for jit in (True, False, False, True):
        spans = Spans()
        reset_launch_counts()
        report = run_parity(params, cfg, bank, audio, tolerance=PARITY_TOL,
                            controls=PARITY_CONTROLS, device=device, timer=spans, jit=jit)
        n = check_parity(report, spans, f"parity_graph (jit={jit})")
        name = "graph" if jit else "eager"
        if jit:
            launches += n
        reports.setdefault(name, report)
        runs[name].append({f"{half}_{k}": v for half, s in spans.out.items()
                           for k, v in s.items() if k != "launches"}
                          | {f"{half}_launches": s["launches"]["float32"]
                             for half, s in spans.out.items()})
    g, e = reports["graph"], reports["eager"]
    if (g.max_abs_diff, g.rms_diff) != (e.max_abs_diff, e.rms_diff):
        raise AssertionError(f"parity_graph: compiled {g} vs eager {e}")
    timed = {name: r[-1] for name, r in runs.items()}
    log("parity_graph", t0, model="klatt8", config="slots_f32", capacity=CAPACITY,
        frames=CHUNK, tol=PARITY_TOL, max_abs_diff=g.max_abs_diff, rms_diff=g.rms_diff,
        launches_graph_runs=launches, runs=runs,
        stream_span_ms_per_10ms_audio={name: t["stream_span_ms"] / CHUNK
                                       for name, t in timed.items()},
        capture_host_ms=timed["graph"]["capture_host_ms"], nvidia_smi=card)
    return launches


def _train_graph_run(device, kind, params, cfg, batches, steps, **kw):
    """`train` or `train_gan` over `batches`: (history, host seconds,
    peak MiB above the memory live before, the compiled steps' capture
    ms)."""
    from beatrice_vst_tpu_torch.runtime import graphs
    from beatrice_vst_tpu_torch.training import train, train_gan

    fn = train_gan if kind == "gan" else train
    graphs.CACHE.clear()
    history, seconds, peak, _ = timed_call(
        lambda: fn(params, cfg, iter(batches), steps=steps, log_every=1,
                   log_fn=lambda *_: None, device=device, **kw)[1])
    return history, seconds, peak, compiled_steps_stats()["capture_ms_total"]


def train_graph_phase(device, card):
    """`train` and `train_gan` on klatt8 at the CLI's defaults (batch 8,
    32 frames), compiled (the default: one CUDA graph a step) against
    eager (jit=False), TRAIN_GRAPH_STEPS steps over the same batches of
    the compiled teacher (make_teacher_batcher, its first batches against
    the eager teacher's), deterministic algorithms on: every step's loss
    within TRAIN_GRAPH_RTOL of the eager run's; steps per second of each
    (the compiled one without its capture, and with it), capture ms, peak
    MiB; a compiled run checkpointed at TRAIN_GRAPH_RESUME_STEP and
    resumed repeats the straight compiled run's losses and parameters
    bitwise; then golden.run_train through the compiled steps against
    tests/data/torch_train_golden.npz (golden.train_gate).  The fused
    upsampler never launched."""
    import tempfile

    import torch
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.models import chain
    from beatrice_vst_tpu_torch.training import make_teacher_batcher

    t0 = time.perf_counter()
    cfg, params, bank = klatt8_numpy()
    teacher = chain.init(torch.Generator().manual_seed(1), cfg, "cpu")
    reset_launch_counts()

    def batcher(jit):
        return make_teacher_batcher(cfg, teacher, bank, batch=TRAIN_BATCH, frames=TRAIN_FRAMES,
                                    seed=0, device=device, jit=jit)

    compiled, eager = batcher(True), batcher(False)
    batches = [next(compiled) for _ in range(TRAIN_GRAPH_STEPS)]
    teacher_diff = max(float((batches[k]["target24"] - next(eager)["target24"]).abs().max())
                       for k in range(2))
    if not teacher_diff <= GRAPH_TOL:
        raise AssertionError(f"train_graph: compiled teacher vs eager: max|d| {teacher_diff}")
    audio_s = TRAIN_BATCH * TRAIN_FRAMES * 0.010
    n = TRAIN_GRAPH_STEPS
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        for kind in ("distill", "gan"):
            res = {}
            for jit in (False, True):
                res[jit] = _train_graph_run(device, kind, params, cfg, batches, n, jit=jit)
            (h_e, s_e, p_e, _), (h_g, s_g, p_g, cap) = res[False], res[True]
            dev = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(h_g, h_e))
            if [s for s, _ in h_g] != list(range(n)) or not dev <= TRAIN_GRAPH_RTOL:
                raise AssertionError(f"train_graph {kind}: compiled vs eager losses deviate by "
                                     f"{dev}: {h_g} vs {h_e}")
            with tempfile.TemporaryDirectory() as d:
                _train_graph_run(device, kind, params, cfg, batches, TRAIN_GRAPH_RESUME_STEP,
                                 ckpt_dir=d)
                resumed = _train_graph_run(device, kind, params, cfg,
                                           batches[TRAIN_GRAPH_RESUME_STEP:], n, ckpt_dir=d,
                                           resume=True)[0]
            if resumed != h_g[TRAIN_GRAPH_RESUME_STEP:]:
                raise AssertionError(f"train_graph {kind}: the resumed compiled run {resumed} "
                                     f"is not the straight one's {h_g}")
            out[kind] = {"max_rel_dev_graph_vs_eager": dev, "tol": TRAIN_GRAPH_RTOL,
                         "loss_first": h_g[0][1], "loss_last": h_g[-1][1],
                         "eager_steps_per_s": n / s_e,
                         "graph_steps_per_s_without_capture": n / (s_g - cap / 1e3),
                         "graph_steps_per_s_with_capture": n / s_g,
                         "eager_audio_seconds_per_s": n * audio_s / s_e,
                         "graph_audio_seconds_per_s": n * audio_s / (s_g - cap / 1e3),
                         "capture_ms": cap, "eager_peak_mib": p_e, "graph_peak_mib": p_g,
                         "resume_bitwise": True}
        want = golden.load(TRAIN_GOLDEN)
        batch = {k: want[f"batch/{k}"] for k in ("audio16", "target24", "f0_bin")}
        got = golden.run_train(cfg, params, bank, device, batch, jit=True)
        worst = 0.0
        for key, value in got.items():
            ok, dev, bound = golden.train_gate(key, value, float(want[key]))
            if not ok:
                raise AssertionError(f"train_graph golden: {key} {value} vs {float(want[key])}: "
                                     f"{dev} > {bound}")
            if "grad/" not in key:
                worst = max(worst, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    counts = no_upsampler_launches("train_graph")
    log("train_graph", t0, model="klatt8", batch=TRAIN_BATCH, frames=TRAIN_FRAMES, steps=n,
        resume_step=TRAIN_GRAPH_RESUME_STEP, teacher_max_abs_diff_graph_vs_eager=teacher_diff,
        runs=out, golden_worst_loss_rel_dev=worst, golden_loss_rtol=golden.TRAIN_LOSS_RTOL,
        kernel_launches=counts, nvidia_smi=card)


def feature_distill_graph_phase(device, card):
    """module_step for each module on klatt8 (the teacher) and a student
    from chain.init, batch 8 x 32 frames, compiled (one CUDA graph a
    module) against eager, FEATURE_GRAPH_STEPS steps each, deterministic
    algorithms on: every loss within TRAIN_GRAPH_RTOL; step ms of each;
    then end_to_end_error and end_to_end_error_soft compiled against
    eager (every number within TRAIN_GRAPH_RTOL relative)."""
    import torch
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.models import chain
    from beatrice_vst_tpu_torch.models.io import params_from_numpy
    from beatrice_vst_tpu_torch.runtime import graphs
    from beatrice_vst_tpu_torch.training import distill
    from beatrice_vst_tpu_torch.training import feature_distill as FD

    t0 = time.perf_counter()
    cfg, params, bank = klatt8_numpy()
    teacher = params_from_numpy(params, device)
    batch = golden.train_inputs(cfg, bank, device, golden.train_batch(batch=TRAIN_BATCH,
                                                                      frames=TRAIN_FRAMES))
    student0 = chain.init(torch.Generator().manual_seed(2), cfg, "cpu")
    reset_launch_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    modules = {}
    try:
        for module in ("phone", "pitch", "wg"):
            losses, step_ms = {}, {}
            for jit in (False, True):
                graphs.CACHE.clear()
                student = distill.trainable(student0, device)
                opt = distill.Optimizer(student[module], 1e-3, betas=(0.9, 0.999),
                                        weight_decay=0.0)
                losses[jit], times = [], []
                for _ in range(FEATURE_GRAPH_STEPS):
                    _, t, _, _ = timed_call(lambda: losses[jit].append(float(FD.module_step(
                        student, opt, teacher, batch, cfg=cfg, module=module,
                        jit=jit)[-1]["loss"])))
                    times.append(t * 1e3)
                step_ms[jit] = times
            dev = max(abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False]))
            if not dev <= TRAIN_GRAPH_RTOL:
                raise AssertionError(f"feature_distill_graph {module}: compiled vs eager "
                                     f"losses {losses}")
            modules[module] = {"max_rel_dev_graph_vs_eager": dev, "losses": losses[True],
                               "eager_step_ms": float(np.median(step_ms[False][1:])),
                               "graph_step_ms": float(np.median(step_ms[True][1:])),
                               "graph_first_step_ms": step_ms[True][0]}
        student = params_from_numpy(student0, device)
        diags = {}
        for fn in (FD.end_to_end_error, FD.end_to_end_error_soft):
            got, want = (fn(student, teacher, batch, cfg=cfg, jit=jit) for jit in (True, False))
            dev = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-12)
                      for k in want)
            if not dev <= TRAIN_GRAPH_RTOL:
                raise AssertionError(f"{fn.__name__}: compiled {got} vs eager {want}")
            diags[fn.__name__] = dev
    finally:
        torch.use_deterministic_algorithms(False)
    counts = no_upsampler_launches("feature_distill_graph")
    log("feature_distill_graph", t0, model="klatt8 teacher, chain.init student",
        batch=TRAIN_BATCH, frames=TRAIN_FRAMES, steps=FEATURE_GRAPH_STEPS, tol=TRAIN_GRAPH_RTOL,
        modules=modules, diagnostics_max_rel_dev=diags, kernel_launches=counts,
        nvidia_smi=card)


MESH_RANKS = 2
MESH_SEQPAR_SEGMENTS = 5  # (s - 1) * B = 4 rows: 2 a rank
MESH_SEQPAR_TOL = 1e-5  # against the unsharded seqpar: the same operations, other batches
MESH_SEQPAR_CALLS = 3  # each form's calls on the mesh; the compiled one's first captures
PROFILED_TICKS = 3  # a rank tick_case whose last tick runs under torch.profiler
MESH_CONFIGS = ("slots_f32", "slots_bf16")
# mesh_engine's ticks held at KERNEL_TOL to one process at CAPACITY: before
# 128- and 256-row GEMMs' roundings have flipped a stream's pitch bin
MESH_EXACT_TICKS = 10
# the spawned group: imports, two CUDA contexts and every case (54 s on the
# H100's host in its first run), with the host's 2x spread between runs
RANK_LIMIT_S = 240


def mesh_cases(card_audio, params, bank):
    """Every case of the mesh phases, run by one 2-rank gloo group on the
    card (parallel/checks.py): the golden run on a 2 x 1 mesh, the engine
    at CAPACITY on 2 x 1, the golden run with the weights split on 1 x 2,
    the train golden numbers on 2 x 1 and on 1 x 2 (split weights), and
    seqpar on 2 x 1."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.parallel import checks
    from beatrice_vst_tpu_torch.runtime.offline import ConversionSettings
    from beatrice_vst_tpu_torch.speakers.bank import n_speakers

    rc0 = "2.0.0-rc.0"
    gold_audio = golden.swept_sine().reshape(golden.CAPACITY, golden.TICKS, 480).transpose(1, 0, 2)
    controls = stream_controls(CAPACITY, n_speakers(bank))
    want = golden.load(TRAIN_GOLDEN)
    batch = {k: want[f"batch/{k}"] for k in ("audio16", "target24", "f0_bin")}
    settings = ConversionSettings(**golden.OFFLINE_SETTINGS)
    cases = []
    for config in MESH_CONFIGS:
        kw = ENGINE_CONFIGS[config][0]
        gold = dict(params=params, bank=bank, audio=gold_audio, version=rc0,
                    capacity=golden.CAPACITY, admit="golden", engine_kw=kw, keep_state=False,
                    mesh_shape=(2, 1))
        engine = dict(params=params, bank=bank, audio=card_audio, version=rc0,
                      capacity=CAPACITY, admit=controls, engine_kw=kw, keep_state=False,
                      mesh_shape=(2, 1))
        # the eager twins (jit=False) and the compiled rank ticks (jit None)
        cases.append((f"golden_{config}", checks.tick_case, dict(gold, jit=False)))
        cases.append((f"graph_golden_{config}", checks.tick_case, gold))
        # on gloo ranks the tensor-parallel tick, whose all-reduces no graph
        # can hold, runs eagerly (graphs.resolve_jit)
        cases.append((f"tp_{config}", checks.tick_case,
                      dict(gold, mesh_shape=(1, 2), model_parallel=True)))
        cases.append((f"engine_{config}", checks.tick_case, dict(engine, jit=False)))
        cases.append((f"graph_engine_{config}", checks.tick_case, engine))
    cases.append(("train", checks.train_golden_case,
                  dict(params=params, bank=bank, batch=batch, mesh_shape=(2, 1))))
    cases.append(("tp_train", checks.train_golden_case,
                  dict(params=params, bank=bank, batch=batch, mesh_shape=(1, 2),
                       model_parallel=True)))
    long = golden.offline_signal(seconds=SEQPAR_SECONDS)
    for name, audio, n, kw in (
            ("seqpar", long, MESH_SEQPAR_SEGMENTS, dict(jit=False, calls=MESH_SEQPAR_CALLS)),
            ("graph_seqpar", long, MESH_SEQPAR_SEGMENTS, dict(calls=MESH_SEQPAR_CALLS)),
            ("seqpar_golden", golden.offline_signal(), golden.SEQPAR_SEGMENTS, {})):
        cases.append((name, checks.seqpar_case,
                      dict(params=params, bank=bank, audio=audio, rate=golden.OFFLINE_RATE,
                           n_segments=n, version=rc0, settings=settings, mesh_shape=(2, 1),
                           **kw)))
    # after every timed case: the host's launch calls of a rank tick, each
    # form, under torch.profiler (which slows later eager ticks)
    for config in MESH_CONFIGS:
        for mode, jit in (("eager", False), ("graph", None)):
            cases.append((f"calls_{mode}_{config}", checks.tick_case,
                          dict(params=params, bank=bank, audio=card_audio[:PROFILED_TICKS],
                               version=rc0, capacity=CAPACITY, admit=controls,
                               engine_kw=ENGINE_CONFIGS[config][0], keep_state=False,
                               mesh_shape=(2, 1), jit=jit, profile=True)))
    return cases, controls, long, settings


def rank_launches(label, results, form, ticks):
    """Each rank's launches of `form` in its ticks: one per tick and one
    per warm-up tick of a compiled tick's capture, none of the other form.
    Returns their sum."""
    for r, res in enumerate(results):
        want = {f: ticks + res["warmup_ticks"] if f == form else 0 for f in res["launches"]}
        if res["launches"] != want:
            raise AssertionError(f"{label}: rank {r} launched {res['launches']} in {ticks} "
                                 f"ticks, expected {want}")
    return sum(res["launches"][form] for res in results)


def tick_stats(res):
    """Median and p90 tick span (CUDA events), median host ms, peak MiB of a
    tick_case run, past its first WARMUP_TICKS ticks."""
    return {**tick_stats_ms(res["span_ms"], res["host_ms"], WARMUP_TICKS),
            "peak_mib": res["peak_mib"]}


def mesh_phases(device, card, by_path):
    """The mesh phases: one 2-rank gloo group on the one card runs every
    case of `mesh_cases`; each rank computes on the card.  Then mesh_nccl
    in this process.  Each phase adds its launches to by_path under
    mesh_*.  Two ranks on one card measure processes overlapping on one
    device, not multi-GPU scaling."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.parallel import checks, spawn_cpu_ranks
    from beatrice_vst_tpu_torch.runtime.offline import convert_utterance
    from beatrice_vst_tpu_torch.runtime.seqpar import convert_utterance_sp

    t0 = time.perf_counter()
    cfg, params, bank = klatt8_numpy()
    card_audio = engine_audio(device).cpu().numpy()
    cases, controls, long, settings = mesh_cases(card_audio, params, bank)
    results = spawn_cpu_ranks(MESH_RANKS, checks.run_cases, device.type, cases,
                              limit_s=RANK_LIMIT_S)
    spawn_s = time.perf_counter() - t0
    ref = golden.load(GOLDEN)

    for config in MESH_CONFIGS:  # mesh_golden and mesh_tp
        form = ENGINE_CONFIGS[config][1]
        for kind, shape in (("golden", [2, 1]), ("tp", [1, 2])):
            t = time.perf_counter()
            runs = [res[f"{kind}_{config}"] for res in results]
            if any(run["compiled"] for run in runs):
                raise AssertionError(f"mesh_{kind} {config}: an eager rank tick ran compiled")
            gates = [golden_gate(f"mesh_{kind} {config} rank {r}", form, run["out"],
                                 ref["f32"], ref["bf16"]) for r, run in enumerate(runs)]
            by_path[form][f"mesh_{kind}_{config}"] = rank_launches(
                f"mesh_{kind} {config}", runs, form, golden.TICKS)
            log(f"mesh_{kind}", t, config=config, mesh=shape, ranks=MESH_RANKS,
                rows_per_rank=[run["rows"] for run in runs],
                launches_per_rank=[run["launches"] for run in runs],
                golden=gates[0], ranks_equal=bool(np.array_equal(runs[0]["out"],
                                                                 runs[1]["out"])),
                spawn_seconds=spawn_s, nvidia_smi=card)

    for config in MESH_CONFIGS:  # mesh_engine
        t = time.perf_counter()
        form, tol = ENGINE_CONFIGS[config][1], KERNEL_TOL[ENGINE_CONFIGS[config][1]]
        runs = [res[f"engine_{config}"] for res in results]
        got = runs[0]["out"]
        kw = dict(version="2.0.0-rc.0", engine_kw=ENGINE_CONFIGS[config][0], keep_state=False,
                  jit=False, device=device)
        single = checks.tick_case(params, bank, card_audio, capacity=CAPACITY, admit=controls,
                                  **kw)
        rows = CAPACITY // MESH_RANKS
        blocks = np.concatenate(
            [checks.tick_case(params, bank, card_audio[:, r * rows:(r + 1) * rows], capacity=rows,
                              admit=controls[r * rows:(r + 1) * rows], **kw)["out"]
             for r in range(MESH_RANKS)], axis=1)
        vs_blocks = float(np.abs(got - blocks).max())
        d = np.abs(got - single["out"])  # [ticks, streams, samples]
        early = float(d[:MESH_EXACT_TICKS].max())
        early_level = float(np.abs(single["out"][:MESH_EXACT_TICKS]).max())
        per_stream, per_tick = d.max(axis=(0, 2)), d.max(axis=(1, 2))
        over = np.flatnonzero(per_tick > tol)
        if not np.isfinite(got).all() or not vs_blocks <= tol or not early <= tol \
                or not early_level > 1e-3:
            raise AssertionError(f"mesh_engine {config}: vs one process on each rank's rows "
                                 f"{vs_blocks}; vs one process at {CAPACITY} over the first "
                                 f"{MESH_EXACT_TICKS} ticks {early} (tol {tol}; output level "
                                 f"{early_level})")
        if not np.array_equal(got, runs[1]["out"]):
            raise AssertionError(f"mesh_engine {config}: the ranks gathered other outputs")
        by_path[form][f"mesh_engine_{config}"] = rank_launches(
            f"mesh_engine {config}", runs, form, TICKS)
        log("mesh_engine", t, config=config, capacity=CAPACITY, mesh=[2, 1], ticks=TICKS,
            rows_per_rank=[run["rows"] for run in runs],
            launches_per_rank=[run["launches"] for run in runs],
            ranks=[tick_stats(run) for run in runs], single_process=tick_stats(single),
            max_abs_diff_vs_rank_rows=vs_blocks,
            vs_single_process={f"max_abs_diff_first_{MESH_EXACT_TICKS}_ticks": early,
                               "output_max_first_ticks": early_level,
                               "max_abs_diff": float(per_stream.max()),
                               "first_tick_over_tol": int(over[0]) if over.size else None,
                               "median_stream_max_abs_diff": float(np.median(per_stream)),
                               "streams_over_tol": int((per_stream > tol).sum())},
            tol=tol, note="two processes sharing one card: process overlap, not multi-GPU "
            "scaling", nvidia_smi=card)

    t = time.perf_counter()  # mesh_tp (the train step) and mesh_train
    want = golden.load(TRAIN_GOLDEN)
    for kind, shape in (("train", [2, 1]), ("tp_train", [1, 2])):
        worst, failed = {}, []
        if any(res[kind]["compiled"] for res in results):
            raise AssertionError(f"mesh {kind}: a step whose collectives gloo runs through "
                                 "the host ran compiled")
        for r, res in enumerate(results):
            for key, value in res[kind]["numbers"].items():
                ok, dev, bound = golden.train_gate(key, value, float(want[key]))
                if dev > worst.get(key.split("/")[0], (0.0, ""))[0]:
                    worst[key.split("/")[0]] = (dev, key)
                if not ok:
                    failed.append((r, key, value, float(want[key]), dev, bound))
        if failed:
            raise AssertionError(f"mesh {kind}: {len(failed)} numbers off the golden file: "
                                 f"{failed[:8]}")
        log("mesh_tp" if kind == "tp_train" else "mesh_train", t, mesh=shape,
            steps="distill + gan, each with its second step, eager on gloo ranks",
            numbers=len(results[0][kind]["numbers"]),
            worst=worst, loss_rtol=golden.TRAIN_LOSS_RTOL, grad_rtol=golden.TRAIN_GRAD_RTOL,
            nvidia_smi=card)

    t = time.perf_counter()  # mesh_seqpar
    rate = golden.OFFLINE_RATE
    sequential = convert_utterance(params, cfg, bank, long, rate, settings, device=device)
    unsharded = convert_utterance_sp(params, cfg, bank, long, rate, settings,
                                     n_segments=MESH_SEQPAR_SEGMENTS, device=device)
    gold = golden.load(SEQPAR_GOLDEN)["f32"]
    out = {}
    for r, res in enumerate(results):
        vs_seq = golden.deviation(res["seqpar"]["out"], sequential)
        vs_sp = golden.deviation(res["seqpar"]["out"], unsharded)
        vs_gold = golden.deviation(res["seqpar_golden"]["out"], gold)
        if not (vs_seq["max"] <= golden.F32_ATOL and vs_sp["max"] <= MESH_SEQPAR_TOL
                and vs_gold["max"] <= golden.F32_ATOL):
            raise AssertionError(f"mesh_seqpar rank {r}: vs sequential {vs_seq}, vs "
                                 f"unsharded {vs_sp}, golden (unsplit) {vs_gold}")
        out[r] = {"vs_sequential": vs_seq, "vs_unsharded": vs_sp, "golden": vs_gold}
    log("mesh_seqpar", t, mesh=[2, 1], segments=MESH_SEQPAR_SEGMENTS,
        golden_segments=golden.SEQPAR_SEGMENTS, ranks=out,
        tol={"sequential": golden.F32_ATOL, "unsharded": MESH_SEQPAR_TOL}, nvidia_smi=card)

    mesh_graph_phase(results, card, ref, by_path)
    mesh_nccl_phase(device, card, params, bank, controls, card_audio, by_path)


def rank_tick_stats(res, calls):
    """tick_stats of a rank's tick_case run with its mode, capture ms and
    warm-up ticks, and the host launch calls of the profiled tick of
    `calls` (a short run of the same form)."""
    return {**tick_stats(res), "compiled": res["compiled"], "capture_ms": res["capture_ms"],
            "host_launch_calls_per_tick": calls["host_launch_calls"],
            "warmup_ticks": res["warmup_ticks"]}


def mesh_graph_phase(results, card, ref, by_path):
    """The compiled mesh steps in the 2-rank gloo group (ROADMAP C9): for
    each of MESH_CONFIGS the compiled stream-sharded tick (no collective
    in it, so compiled on gloo ranks) at CAPACITY on 2 x 1, gathered,
    against the eager rank tick (max |d| <= GRAPH_TOL), each rank's
    median and p90 span, host ms, host launch calls, capture ms and peak
    MiB beside the eager rank's; the golden run compiled on 2 x 1 against
    the golden file and the eager golden run; seqpar compiled on 2 x 1
    against eager (max |d| <= GRAPH_TOL) with audio seconds per second of
    each (on the median of the calls after the first: the compiled first
    call captures)."""
    from beatrice_vst_tpu_torch import golden

    for config in MESH_CONFIGS:
        t = time.perf_counter()
        form = ENGINE_CONFIGS[config][1]
        out = {}
        for kind, ticks in (("engine", TICKS), ("golden", golden.TICKS)):
            graph = [res[f"graph_{kind}_{config}"] for res in results]
            eager = [res[f"{kind}_{config}"] for res in results]
            modes = [(g["compiled"], e["compiled"]) for g, e in zip(graph, eager)]
            if modes != [(True, False)] * len(results):
                raise AssertionError(f"mesh_graph {kind} {config}: (compiled, eager) modes "
                                     f"{modes}")
            diff = max(float(np.abs(g["out"] - e["out"]).max()) for g, e in zip(graph, eager))
            level = float(np.abs(eager[0]["out"]).max())
            if not diff <= GRAPH_TOL or not np.isfinite(graph[0]["out"]).all() or level <= 1e-3:
                raise AssertionError(f"mesh_graph {kind} {config}: compiled vs eager rank tick "
                                     f"max|d| {diff} (tol {GRAPH_TOL}; output level {level})")
            if not np.array_equal(graph[0]["out"], graph[1]["out"]):
                raise AssertionError(f"mesh_graph {kind} {config}: the ranks gathered other "
                                     "outputs")
            by_path[form][f"mesh_graph_{kind}_{config}"] = rank_launches(
                f"mesh_graph {kind} {config}", graph, form, ticks)
            out[kind] = {"max_abs_diff_graph_vs_eager": diff,
                         "launches_per_rank": [g["launches"] for g in graph]}
            if kind == "golden":
                out[kind]["golden"] = [golden_gate(f"mesh_graph golden {config} rank {r}", form,
                                                   g["out"], ref["f32"], ref["bf16"])
                                       for r, g in enumerate(graph)]
            else:
                out[kind]["ranks"] = {
                    mode: [rank_tick_stats(run, res[f"calls_{mode}_{config}"])
                           for run, res in zip(runs, results)]
                    for mode, runs in (("graph", graph), ("eager", eager))}
                by_path[form][f"mesh_graph_calls_{config}"] = sum(
                    rank_launches(f"mesh_graph calls {mode} {config}",
                                  [res[f"calls_{mode}_{config}"] for res in results], form,
                                  PROFILED_TICKS) for mode in ("graph", "eager"))
        log("mesh_graph", t, config=config, capacity=CAPACITY, mesh=[2, 1], ticks=TICKS,
            golden_ticks=golden.TICKS, tol=GRAPH_TOL, **out,
            note="two gloo ranks sharing one card: process overlap, not multi-GPU scaling",
            nvidia_smi=card)

    t = time.perf_counter()
    seq = {}
    for r, res in enumerate(results):
        graph, eager = res["graph_seqpar"], res["seqpar"]
        diff = float(np.abs(graph["out"] - eager["out"]).max())
        if not graph["compiled"] or eager["compiled"] or not diff <= GRAPH_TOL:
            raise AssertionError(f"mesh_graph seqpar rank {r}: compiled {graph['compiled']}, "
                                 f"eager {eager['compiled']}, max|d| {diff}")
        seq[r] = {"max_abs_diff_graph_vs_eager": diff,
                  "graph_audio_seconds_per_s": SEQPAR_SECONDS / np.median(graph["seconds"][1:]),
                  "eager_audio_seconds_per_s": SEQPAR_SECONDS / np.median(eager["seconds"][1:]),
                  "graph_seconds": graph["seconds"], "eager_seconds": eager["seconds"]}
    log("mesh_graph", t, path="seqpar", mesh=[2, 1], seconds=SEQPAR_SECONDS,
        segments=MESH_SEQPAR_SEGMENTS, ranks=seq, tol=GRAPH_TOL, nvidia_smi=card)


def mesh_nccl_phase(device, card, params, bank, controls, card_audio, by_path):
    """A world-size-1 NCCL group (distributed_init's default backend on
    CUDA, env:// rendezvous) and a 1 x 1 mesh in this process: one tick
    of each configuration equal to the unsharded tick, to 0.0; then, in
    the same group, mesh_nccl_graph."""
    import torch
    import torch.distributed as dist
    from beatrice_vst_tpu_torch.parallel import checks, distributed_init

    t0 = time.perf_counter()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0")
    distributed_init()
    try:
        backend = dist.get_backend()
        one = torch.ones(1, device=device)
        dist.all_reduce(one)
        out = {}
        for config in MESH_CONFIGS:
            form = ENGINE_CONFIGS[config][1]
            kw = dict(params=params, bank=bank, audio=card_audio[:1], version="2.0.0-rc.0",
                      capacity=CAPACITY, admit=controls, engine_kw=ENGINE_CONFIGS[config][0],
                      keep_state=False, device=device)
            sharded = checks.tick_case(mesh_shape=(1, 1), **kw)
            plain = checks.tick_case(**kw)
            diff = float(np.abs(sharded["out"] - plain["out"]).max())
            if diff != 0.0:
                raise AssertionError(f"mesh_nccl {config}: 1 x 1 mesh vs unsharded: {diff}")
            by_path[form][f"mesh_nccl_{config}"] = rank_launches(
                f"mesh_nccl {config}", [sharded], form, 1)
            by_path[form][f"mesh_nccl_plain_{config}"] = rank_launches(
                f"mesh_nccl plain {config}", [plain], form, 1)
            out[config] = {"max_abs_diff": diff, "launches": sharded["launches"],
                           "compiled": sharded["compiled"]}
        if backend != "nccl" or float(one) != 1.0:
            raise AssertionError(f"mesh_nccl: backend {backend}, all_reduce gave {float(one)}")
        log("mesh_nccl", t0, backend=backend, mesh=[1, 1], configs=out, nvidia_smi=card)
        mesh_nccl_graph_phase(device, card, params, bank, controls, card_audio, by_path)
    finally:
        dist.destroy_process_group()


NCCL_GRAPH_TICKS = 60
NCCL_TRAIN_STEPS = 6  # each form's steps; the rate is over the steps after the first


def nccl_in_graph(device, params, bank, controls):
    """Where the tensor-parallel tick's NCCL all-reduces sit, after every
    timing in the process: a TickStep on the 1 x 1 mesh with the weights
    split, captured under torch.profiler: the collectives check_capture
    counted while it captured, and c10d's host records of them."""
    from torch.profiler import ProfilerActivity, profile

    from beatrice_vst_tpu_torch.constants import V20RC0
    from beatrice_vst_tpu_torch.parallel import make_mesh, params_sharding, shard_tree
    from beatrice_vst_tpu_torch.parallel import mesh as mesh_mod
    from beatrice_vst_tpu_torch.parallel import state_sharding
    from beatrice_vst_tpu_torch.runtime.engine import EngineConfig, StreamEngine, TickStep

    cfg = EngineConfig.realtime(CAPACITY, V20RC0, **ENGINE_CONFIGS["slots_f32"][0])
    eng = StreamEngine(cfg, params, bank, device=device, jit=False)
    for c in controls:
        i = eng.admit()
        for field, value in c.items():
            eng.set_control(i, field, value)
    eng.flush_controls()
    mesh = make_mesh(1, 1, device_type="cuda")
    p = shard_tree(eng.params, params_sharding(eng.params, mesh, model_parallel=True), mesh)
    state = shard_tree(eng.state, state_sharding(eng.state, mesh, capacity=CAPACITY), mesh)
    before = mesh_mod.captured_collectives
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tick = TickStep(p, eng.bank, state, cfg=cfg, mesh=mesh)
    return {"compiled": tick.compiled,
            "collectives_captured": mesh_mod.captured_collectives - before,
            "c10d_host_records_in_warmups_and_capture": {
                e.key: e.count for e in prof.key_averages() if e.key.startswith("nccl:")}}


def mesh_nccl_graph_phase(device, card, params, bank, controls, card_audio, by_path):
    """The compiled mesh steps whose bodies issue NCCL collectives, on the
    world-size-1 NCCL group of mesh_nccl (1 x 1, the weights split over
    'model': the all-reduces of the forward, the backward and the clip):
    for each of MESH_CONFIGS the compiled tensor-parallel tick at CAPACITY
    against its eager twin (max |d| <= GRAPH_TOL), spans, host ms,
    capture ms; one distillation and one GAN step compiled
    against eager (losses within TRAIN_GRAPH_RTOL relative) and
    NCCL_TRAIN_STEPS steps each for steps/s; the train golden numbers
    through the compiled mesh steps (golden.train_gate); then, after
    every timing, each tick form's host launch calls in a profiled tick
    and nccl_in_graph.  Every compiled form asserted compiled."""
    import torch
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.parallel import checks

    rc0 = "2.0.0-rc.0"
    for config in MESH_CONFIGS:
        t = time.perf_counter()
        form = ENGINE_CONFIGS[config][1]
        kw = dict(params=params, bank=bank, audio=card_audio[:NCCL_GRAPH_TICKS], version=rc0,
                  capacity=CAPACITY, admit=controls, engine_kw=ENGINE_CONFIGS[config][0],
                  keep_state=False, mesh_shape=(1, 1), model_parallel=True, device=device)
        runs = {"eager": checks.tick_case(jit=False, **kw), "graph": checks.tick_case(**kw)}
        graph, eager = runs["graph"], runs["eager"]
        diff = float(np.abs(graph["out"] - eager["out"]).max())
        if not graph["compiled"] or eager["compiled"] or not graph["captured_collectives"]:
            raise AssertionError(f"mesh_nccl_graph tick {config}: compiled {graph['compiled']}, "
                                 f"eager {eager['compiled']}, collectives captured "
                                 f"{graph['captured_collectives']}")
        if not diff <= GRAPH_TOL or not np.isfinite(graph["out"]).all():
            raise AssertionError(f"mesh_nccl_graph tick {config}: compiled vs eager max|d| "
                                 f"{diff}")
        by_path[form][f"mesh_nccl_graph_{config}"] = (
            rank_launches(f"mesh_nccl_graph {config}", [graph], form, NCCL_GRAPH_TICKS)
            + rank_launches(f"mesh_nccl_graph eager {config}", [eager], form,
                            NCCL_GRAPH_TICKS))
        log("mesh_nccl_graph", t, path="tick", config=config, mesh=[1, 1],
            model_parallel=True, capacity=CAPACITY, ticks=NCCL_GRAPH_TICKS,
            max_abs_diff_graph_vs_eager=diff, tol=GRAPH_TOL,
            collectives_captured=graph["captured_collectives"],
            **{name: {**tick_stats_ms(r["span_ms"], r["host_ms"], WARMUP_TICKS),
                      "compiled": r["compiled"], "capture_ms": r["capture_ms"],
                      "peak_mib": r["peak_mib"], "launches": r["launches"]}
               for name, r in runs.items()}, nvidia_smi=card)

    t = time.perf_counter()
    batch = golden.train_batch(batch=TRAIN_BATCH, frames=TRAIN_FRAMES)
    reset_launch_counts()
    steps = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, fn, extra in (("distill", checks.distill_case, {}),
                                ("gan", checks.gan_case, {"disc": golden.disc_params()})):
            runs = {mode: fn(params, bank, batch, version=rc0, mesh_shape=(1, 1),
                             model_parallel=True, jit=jit, steps=NCCL_TRAIN_STEPS,
                             device=device, **extra)
                    for mode, jit in (("graph", None), ("eager", False))}
            graph, eager = runs["graph"], runs["eager"]
            dev = max(abs(graph["metrics"][k] - v) / max(abs(v), 1e-12)
                      for k, v in eager["metrics"].items())
            params_diff = max(float(np.abs(graph[k][leaf] - eager[k][leaf]).max())
                              for k in ("params", "g", "d") if k in eager
                              for leaf in eager[k])
            if not graph["compiled"] or eager["compiled"] or not dev <= TRAIN_GRAPH_RTOL \
                    or not graph["captured_collectives"]:
                raise AssertionError(f"mesh_nccl_graph {name}: compiled {graph['compiled']}, "
                                     f"losses max rel dev {dev}, collectives captured "
                                     f"{graph['captured_collectives']}")
            steps[name] = {
                "losses_max_rel_dev": dev, "params_max_abs_diff_after_steps": params_diff,
                "collectives_captured": graph["captured_collectives"],
                **{f"{mode}_steps_per_s": (len(r["step_s"]) - 1) / sum(r["step_s"][1:])
                   for mode, r in runs.items()},
                "graph_first_step_s": graph["step_s"][0], "capture_ms": graph["capture_ms"]}
    finally:
        torch.use_deterministic_algorithms(False)
    want = golden.load(TRAIN_GOLDEN)
    gold = checks.train_golden_case(
        params, bank, {k: want[f"batch/{k}"] for k in ("audio16", "target24", "f0_bin")},
        mesh_shape=(1, 1), model_parallel=True, device=device)
    failed, worst = [], (0.0, "")
    for key, value in gold["numbers"].items():
        ok, d, bound = golden.train_gate(key, value, float(want[key]))
        worst = max(worst, (d, key))
        if not ok:
            failed.append((key, value, float(want[key]), d, bound))
    if not gold["compiled"] or failed:
        raise AssertionError(f"mesh_nccl_graph train golden: compiled {gold['compiled']}, "
                             f"{len(failed)} numbers off: {failed[:8]}")
    counts = no_upsampler_launches("mesh_nccl_graph training")
    log("mesh_nccl_graph", t, path="train", mesh=[1, 1], model_parallel=True,
        batch=[TRAIN_BATCH, TRAIN_FRAMES], steps=NCCL_TRAIN_STEPS, tol=TRAIN_GRAPH_RTOL,
        **steps, train_golden={"numbers": len(gold["numbers"]), "worst": worst,
                               "compiled": gold["compiled"]},
        kernel_launches=counts, nvidia_smi=card)

    t = time.perf_counter()  # after every timing: the profiled runs
    calls = {}
    for config in MESH_CONFIGS:
        form = ENGINE_CONFIGS[config][1]
        for mode, jit in (("eager", False), ("graph", None)):
            r = checks.tick_case(params, bank, card_audio[:PROFILED_TICKS], rc0, CAPACITY,
                                 mesh_shape=(1, 1), model_parallel=True, admit=controls,
                                 engine_kw=ENGINE_CONFIGS[config][0], keep_state=False,
                                 jit=jit, profile=True, device=device)
            calls[f"{mode}_{config}"] = {"host_launch_calls": r["host_launch_calls"],
                                         "replay_nccl_kernels": r["nccl_kernels"]}
            by_path[form][f"mesh_nccl_graph_calls_{mode}_{config}"] = rank_launches(
                f"mesh_nccl_graph calls {mode} {config}", [r], form, PROFILED_TICKS)
    reset_launch_counts()
    where = nccl_in_graph(device, params, bank, controls)
    by_path["float32"]["mesh_nccl_in_graph"] = launch_counts()["float32"]
    if not where["compiled"] or not where["collectives_captured"]:
        raise AssertionError(f"mesh_nccl_graph: no NCCL collective inside the graph: {where}")
    log("mesh_nccl_graph", t, path="nccl_in_graph", **where,
        tensor_parallel_tick_profiled=calls,
        note="world size 1: NCCL runs an in-place sum of one rank without a kernel, so a "
        "replay shows none",
        nvidia_smi=card)


MULTICARD_LIMIT_S = 900  # the NCCL group: imports, one context a card, every case


def multicard_cases(params, bank, audio, controls, n, batch, frames):
    """The cases every rank of an n-rank NCCL group runs in the
    `--nccl-ranks` mode, one rank a card: on an n x 1 mesh the
    stream-sharded tick, on the tensor-parallel mesh (n/2 x 2, or 1 x n)
    the tick with the weights split, each eager (jit=False) and compiled
    (jit None), in both MESH_CONFIGS; the distillation and GAN steps on
    the tensor-parallel mesh with the weights split, eager and compiled,
    NCCL_TRAIN_STEPS steps each; the train golden numbers through the
    compiled steps there; the dry run; then, after every timing, each
    configuration's compiled tensor-parallel tick with its last tick
    under torch.profiler (the NCCL kernels of one replay)."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.parallel import checks
    from beatrice_vst_tpu_torch.parallel.dryrun import dryrun_rank

    rc0 = "2.0.0-rc.0"
    tp = (n // 2, 2) if n % 2 == 0 and n > 2 else (1, n)
    capacity = audio.shape[1]
    cases = [("bringup", checks.bringup_case, {"mesh_shape": tp})]
    tick = {config: dict(params=params, bank=bank, audio=audio, version=rc0,
                         capacity=capacity, admit=controls,
                         engine_kw=ENGINE_CONFIGS[config][0], keep_state=False)
            for config in MESH_CONFIGS}
    for config in MESH_CONFIGS:
        for kind, shape, split in (("streams", (n, 1), False), ("tp", tp, True)):
            for mode, jit in (("eager", False), ("graph", None)):
                cases.append((f"{kind}_{mode}_{config}", checks.tick_case,
                              dict(tick[config], mesh_shape=shape, model_parallel=split,
                                   jit=jit)))
    train = golden.train_batch(batch=batch, frames=frames)
    for name, fn, extra in (("distill", checks.distill_case, {}),
                            ("gan", checks.gan_case, {"disc": golden.disc_params()})):
        for mode, jit in (("eager", False), ("graph", None)):
            cases.append((f"{name}_{mode}", fn,
                          dict(params=params, bank=bank, batch=train, version=rc0,
                               mesh_shape=tp, model_parallel=True, jit=jit,
                               steps=NCCL_TRAIN_STEPS, **extra)))
    want = golden.load(TRAIN_GOLDEN)
    cases.append(("train_golden", checks.train_golden_case,
                  dict(params=params, bank=bank, mesh_shape=tp, model_parallel=True,
                       batch={k: want[f"batch/{k}"] for k in ("audio16", "target24",
                                                               "f0_bin")})))
    cases.append(("dryrun", dryrun_rank, {"rank": None, "n_devices": n}))
    for config in MESH_CONFIGS:
        cases.append((f"profiled_tp_{config}", checks.tick_case,
                      dict(tick[config], audio=audio[:PROFILED_TICKS], mesh_shape=tp,
                           model_parallel=True, profile=True)))
    return cases, tp


def multicard_phase(device, card, n, ticks=NCCL_GRAPH_TICKS, capacity=CAPACITY,
                    batch=TRAIN_BATCH, frames=TRAIN_FRAMES, spawn=None):
    """The compiled mesh steps across n cards (`--nccl-ranks n`): every
    case of `multicard_cases` in one n-rank NCCL group (`spawn_nccl_ranks`,
    rank r on card r), held as mesh_graph and mesh_nccl_graph hold them:
    each compiled tick equal to its eager twin (max |d| <= GRAPH_TOL) and
    the same on every rank, each compiled train step's losses within
    TRAIN_GRAPH_RTOL of the eager step's, collectives captured in every
    collective-holding graph, the train golden numbers
    (golden.train_gate), the dry run finite and compiled, and NCCL
    kernels in a replay of the tensor-parallel tick on every rank.
    Returns each form's launches."""
    from beatrice_vst_tpu_torch import golden
    from beatrice_vst_tpu_torch.parallel import checks, spawn_nccl_ranks
    from beatrice_vst_tpu_torch.speakers.bank import n_speakers

    t0 = time.perf_counter()
    cfg, params, bank = klatt8_numpy()
    audio = engine_audio("cpu", frames=ticks).numpy()[:, :capacity]
    controls = stream_controls(capacity, n_speakers(bank))
    cases, tp = multicard_cases(params, bank, audio, controls, n, batch, frames)
    spawn = spawn or spawn_nccl_ranks
    cuda = device.type == "cuda"  # the CPU, for a dry run: no capture, no kernel
    results = spawn(n, checks.run_cases, device.type, cases, limit_s=MULTICARD_LIMIT_S)
    spawn_s = time.perf_counter() - t0
    launches = {form: 0 for form in KERNEL_NAME}
    backends = {r["bringup"]["backend"] for r in results}
    for config in MESH_CONFIGS:
        t = time.perf_counter()
        form = ENGINE_CONFIGS[config][1]
        out = {}
        for kind, shape in (("streams", [n, 1]), ("tp", list(tp))):
            eager = [r[f"{kind}_eager_{config}"] for r in results]
            graph = [r[f"{kind}_graph_{config}"] for r in results]
            diff = max(float(np.abs(g["out"] - e["out"]).max()) for g, e in zip(graph, eager))
            same = all(np.array_equal(g["out"], graph[0]["out"]) for g in graph)
            held = [g["captured_collectives"] for g in graph]
            if not all(g["compiled"] and not e["compiled"] for g, e in zip(graph, eager)) \
                    or not diff <= GRAPH_TOL or not same or not np.isfinite(graph[0]["out"]).all() \
                    or cuda and (kind == "tp") != all(held):
                raise AssertionError(f"multicard {kind} {config}: compiled vs eager max|d| "
                                     f"{diff}, ranks equal {same}, collectives captured {held}")
            for runs in (graph, eager):
                if cuda:
                    launches[form] += rank_launches(f"multicard {kind} {config}", runs, form,
                                                    ticks)
            out[kind] = {"mesh": shape, "rows_per_rank": graph[0]["rows"],
                         "max_abs_diff_graph_vs_eager": diff, "collectives_captured": held,
                         **{mode: [{**(tick_stats_ms(r["span_ms"], r["host_ms"],
                                                     min(WARMUP_TICKS, ticks // 2))
                                       if cuda else {}),
                                    "capture_ms": r["capture_ms"], "peak_mib": r["peak_mib"]}
                                   for r in runs]
                            for mode, runs in (("graph", graph), ("eager", eager))}}
        profiled = [r[f"profiled_tp_{config}"] for r in results]
        nccl = [r["nccl_kernels"] for r in profiled]
        if cuda:
            launches[form] += rank_launches(f"multicard profiled {config}", profiled, form,
                                            PROFILED_TICKS)
        if cuda and not all(nccl):
            raise AssertionError(f"multicard {config}: no NCCL kernel in a replay of the "
                                 f"tensor-parallel tick's graph: {nccl}")
        log("multicard", t, config=config, ranks=n, backend=sorted(backends), ticks=ticks,
            capacity=capacity, tol=GRAPH_TOL, **out,
            replay_nccl_kernels_per_rank=nccl,
            replay_host_launch_calls_per_rank=[r["host_launch_calls"] for r in profiled],
            spawn_seconds=spawn_s, nvidia_smi=card)

    t = time.perf_counter()
    steps = {}
    for name in ("distill", "gan"):
        eager = [r[f"{name}_eager"] for r in results]
        graph = [r[f"{name}_graph"] for r in results]
        dev = max(abs(g["metrics"][k] - v) / max(abs(v), 1e-12)
                  for g, e in zip(graph, eager) for k, v in e["metrics"].items())
        held = [g["captured_collectives"] for g in graph]
        if not all(g["compiled"] and not e["compiled"] for g, e in zip(graph, eager)) \
                or not dev <= TRAIN_GRAPH_RTOL or cuda and not all(held):
            raise AssertionError(f"multicard {name}: losses max rel dev {dev}, collectives "
                                 f"captured {held}")
        steps[name] = {"losses_max_rel_dev": dev, "collectives_captured": held,
                       **{f"{mode}_steps_per_s": [(len(r["step_s"]) - 1) / sum(r["step_s"][1:])
                                                  for r in runs]
                          for mode, runs in (("graph", graph), ("eager", eager))},
                       "capture_ms": [g["capture_ms"] for g in graph]}
    want = golden.load(TRAIN_GOLDEN)
    failed, worst = [], (0.0, "")
    for r, res in enumerate(results):
        if not res["train_golden"]["compiled"]:
            raise AssertionError(f"multicard train golden: rank {r} ran eagerly")
        for key, value in res["train_golden"]["numbers"].items():
            ok, d, bound = golden.train_gate(key, value, float(want[key]))
            worst = max(worst, (d, key))
            if not ok:
                failed.append((r, key, value, float(want[key]), d, bound))
    if failed:
        raise AssertionError(f"multicard train golden: {len(failed)} numbers off: "
                             f"{failed[:8]}")
    dry = [r["dryrun"] for r in results]
    if not all(np.isfinite(d["loss"]) and d["tick_finite"] and all(d["compiled"].values())
               for d in dry):
        raise AssertionError(f"multicard dry run: {dry}")
    log("multicard", t, path="train", ranks=n, mesh=list(tp), model_parallel=True,
        batch=[batch, frames], steps=NCCL_TRAIN_STEPS, tol=TRAIN_GRAPH_RTOL, **steps,
        train_golden={"worst": worst}, dryrun={"mesh": dry[0]["mesh"], "loss": dry[0]["loss"],
                                               "compiled": dry[0]["compiled"]},
        nvidia_smi=card)
    return launches


def multicard_main(n: int) -> int:
    """`--nccl-ranks n`: the build, then multicard_phase on n cards; the
    card lines, and the last line with the card count."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = torch.device("cuda")
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    log("env", t0, python=platform.python_version(), torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(), nvidia_smi=card)
    from beatrice_vst_tpu_torch import cuda_build
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    t0 = time.perf_counter()
    log("build", t0, built=sorted(cuda_build.build(sorted(set(FU.FORMS.values())))))
    launches = multicard_phase(device, card, n)
    print(json.dumps({"multicard_launches": launches}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    # deterministic cuBLAS for the train phase's resume check; set before
    # the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    t0 = time.perf_counter()
    card = nvidia_smi_line()
    log("env", t0, python=platform.python_version(), torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        device_count=torch.cuda.device_count(), nvidia_smi=card)

    from beatrice_vst_tpu_torch import cuda_build

    t0 = time.perf_counter()
    from beatrice_vst_tpu_torch.models import fused_upsampler as FU

    sources = sorted({*FU.FORMS.values(), *FU.YARDSTICKS.values()})
    logs = cuda_build.build(sources)
    ptxas = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
             for name, text in logs.items()}
    hmma = {name: cuda_build.sass(name).count("HMMA") for name in sources}
    if not hmma[FU.FORMS[torch.bfloat16]]:
        raise AssertionError("the tensor-core bf16 form has no HMMA instruction in its SASS")
    log("build", t0, built=sorted(logs), ptxas=ptxas, sass_hmma=hmma)

    entries = {form: kernel_phase(device, form) for form in KERNEL_NAME}
    by_path = {form: {} for form in KERNEL_NAME}
    graph_runs = {}
    for config, (_, form) in ENGINE_CONFIGS.items():
        by_path[form][f"graph_{config}"], graph_runs[config] = graph_phase(device, config, card)
    for config, (_, form) in ENGINE_CONFIGS.items():
        by_path[form][f"engine_{config}"] = engine_phase(device, config)
    morph_runs = {}
    for config, (_, form) in ENGINE_CONFIGS.items():
        by_path[form][f"morph_{config}"], morph_runs[config] = morph_phase(device, config, card)
    graph_profile_phase(device, graph_runs, card)
    morph_profile_phase(device, morph_runs, card)
    del morph_runs, graph_runs
    morph_offline_phase(device, card)
    by_path["float32"]["parity_stream"] = parity_phase(device)
    offline_phase(device)
    by_path["float32"]["versions"] = versions_phase(device)
    by_path["float32"]["serve_golden"], plain_serve = serve_golden_phase(device, card)
    by_path["float32"]["serve_pipeline"] = serve_pipeline_phase(device, card, plain_serve)
    for dtype in (None, "bfloat16"):
        serve_tcp_phase(device, card, dtype)
    by_path["float32"]["serve_ws"] = serve_ws_phase(device, card)
    soak_phase(device, card, by_path)
    latency_phase(device, card, by_path)
    train_golden_phase(device, card)
    train_phase(device, card)
    train_data_phase(device, card)
    quality_phase(device, card)
    train_real_phase(device, card)
    seqpar_phase(device, card)
    offline_graph_phase(device, card)
    seqpar_graph_phase(device, card)
    by_path["float32"]["parity_graph"] = parity_graph_phase(device, card)
    train_graph_phase(device, card)
    feature_distill_graph_phase(device, card)
    mesh_phases(device, card, by_path)
    for form, entry in entries.items():
        entry["launches"] = sum(by_path[form].values())
        entry["launches_by_path"] = by_path[form]
        entry["main_path"] = MAIN_CONFIG[form]
    if "--profile" in sys.argv[1:]:
        for config in ENGINE_CONFIGS:
            profile_phase(device, sys.argv[sys.argv.index("--profile") + 1], config)

    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--nccl-ranks" in sys.argv[1:]:
        sys.exit(multicard_main(int(sys.argv[sys.argv.index("--nccl-ranks") + 1])))
    sys.exit(main())
