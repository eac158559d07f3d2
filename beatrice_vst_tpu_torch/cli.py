"""Command-line interface of the port (port of `beatrice_vst_tpu/cli.py`).

    python -m beatrice_vst_tpu_torch.cli init-model DIR [--version V] [--voices N]
    python -m beatrice_vst_tpu_torch.cli info --model DIR
    python -m beatrice_vst_tpu_torch.cli convert IN.wav OUT.wav --model DIR
        [--voice N | --morph w0,w1,...] [--pitch-shift ST] [--formant-shift ST]
        [--intonation X] [--pitch-correction X] [--vq-neighbors N]
        [--seq-parallel N] ...
    python -m beatrice_vst_tpu_torch.cli train --model DIR [--teacher DIR | --data DIR]
        [--steps N] [--batch B] [--frames T] [--lr LR] [--gan] [--ckpt-dir D
        --save-every N --resume] [--output weights.npz]
    python -m beatrice_vst_tpu_torch.cli parity [--version V] [--frames T]
    python -m beatrice_vst_tpu_torch.cli serve --model DIR [--port P] [--capacity C]
        [--dtype bfloat16] [--ws | --grpc]

The same verbs and parameters as the JAX CLI, over the port's offline
converter (sequential or sequence-parallel), the trainer, the parity
harness and the streaming server.  `convert`, `train`, `parity` and
`serve` run on the card unless `--device cpu` is given.  `train` writes a
`weights.npz` that the JAX package's `load_model_dir` reads; without
`--teacher` or `--data` its teacher is a random model from the port's
`chain.init` seeded with seed + 1 (a CPU generator, so its values are not
the JAX CLI's).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

import numpy as np

VERSION_NAMES = ["2.0.0-alpha.2", "2.0.0-beta.1", "2.0.0-rc.0"]


def cmd_init_model(args):
    from .models.io import init_random_model_dir

    config, *_ = init_random_model_dir(args.dir, version=args.version, n_voices=args.voices,
                                       seed=args.seed)
    print(f"initialized {args.version} model with {config.voice_count} voices at {args.dir}")


def cmd_info(args):
    from .models.io import flatten_params, load_model_dir

    config, _, params, _ = load_model_dir(args.model)
    n_params = sum(int(np.prod(v.shape)) for v in flatten_params(params).values())
    info = {
        "version": config.version,
        "name": config.name,
        "voices": [v.name for v in config.voices],
        "average_pitches": [v.average_pitch for v in config.voices],
        "parameters": n_params,
        "phone_channels": config.spec.phone_channels,
        "pitch_bins": config.spec.pitch_bins,
    }
    print(json.dumps(info, indent=2))


def cmd_convert(args):
    import torch

    from .audio_io import read_wav, write_wav
    from .models.io import load_model_dir
    from .runtime.offline import ConversionSettings, convert_utterance

    _, model_cfg, params, bank = load_model_dir(args.model)
    audio, sr = read_wav(args.input)
    morph = None
    if args.morph:
        morph = np.asarray([float(w) for w in args.morph.split(",")], np.float32)
    settings = ConversionSettings(
        target_speaker=args.voice,
        formant_shift=args.formant_shift,
        pitch_shift=args.pitch_shift,
        average_source_pitch=args.average_source_pitch,
        intonation_intensity=args.intonation,
        pitch_correction=args.pitch_correction,
        pitch_correction_type=args.pitch_correction_type,
        vq_num_neighbors=args.vq_neighbors,
        morph_weights=morph,
        soft_pitch=args.soft_pitch,
    )
    kw = dict(out_sample_rate=args.output_rate or sr,
              compute_dtype=getattr(torch, args.dtype) if args.dtype else None,
              device=args.device)
    t0 = time.perf_counter()
    if args.seq_parallel:
        from .runtime.seqpar import convert_utterance_sp

        out = convert_utterance_sp(params, model_cfg, bank, audio, sr, settings,
                                   n_segments=args.seq_parallel, **kw)
    else:
        out = convert_utterance(params, model_cfg, bank, audio, sr, settings, **kw)
    dt = time.perf_counter() - t0
    write_wav(args.output, out, args.output_rate or sr)
    dur = len(audio) / sr
    print(f"converted {dur:.2f}s of audio in {dt:.2f}s ({dur / dt:.1f}x real-time) "
          f"-> {args.output}")


def cmd_train(args):
    import torch

    from .models import chain as chain_mod
    from .models.io import load_model_dir, save_weights
    from .training import make_teacher_batcher, train, train_gan

    _, model_cfg, params, bank = load_model_dir(args.model)
    if args.data:
        from .training import PairDataset, make_pair_batcher

        ds = PairDataset(args.data)
        print(f"dataset: {len(ds.items)} utterances, {ds.n_frames_total()} frames"
              f"{' (identity mode)' if ds.identity_mode else ''}")
        batches = make_pair_batcher(ds, model_cfg, bank, batch=args.batch, frames=args.frames,
                                    seed=args.seed, device=args.device)
    else:
        if args.teacher:
            _, teacher_cfg, teacher_params, teacher_bank = load_model_dir(args.teacher)
            if teacher_cfg != model_cfg:
                raise SystemExit("teacher/student configs differ")
        else:
            teacher_params = chain_mod.init(torch.Generator().manual_seed(args.seed + 1),
                                            model_cfg, "cpu")
            teacher_bank = bank
        batches = make_teacher_batcher(model_cfg, teacher_params, teacher_bank,
                                       batch=args.batch, frames=args.frames, seed=args.seed,
                                       device=args.device)
    common = dict(steps=args.steps, lr=args.lr, ckpt_dir=args.ckpt_dir,
                  save_every=args.save_every, resume=args.resume, device=args.device)
    if args.gan:
        params, history = train_gan(params, model_cfg, batches, seed=args.seed, **common)
    else:
        params, history = train(params, model_cfg, batches, **common)
    out = args.output or f"{args.model}/weights.npz"
    save_weights(out, params)
    print(f"trained {args.steps} steps; final loss {history[-1][1]:.4f}; saved {out}")


def cmd_parity(args):
    from .constants import VERSIONS
    from .parity import run_parity

    report = run_parity(spec=VERSIONS[args.version], n_frames=args.frames, device=args.device)
    print(report)
    raise SystemExit(0 if report.passed else 1)


def _exit_on_signal(signum, frame):
    # unwinds serve_forever / wait_for_termination through their finally
    # blocks, which stop the scheduler before the process exits
    raise SystemExit(0)


def cmd_serve(args):
    signal.signal(signal.SIGTERM, _exit_on_signal)
    signal.signal(signal.SIGINT, _exit_on_signal)
    if args.ws:
        from .runtime.wsserver import serve_ws as serve
    elif args.grpc:
        from .runtime.grpcserver import serve_grpc as serve
    else:
        from .runtime.netserver import serve
    serve(args.model, args.port, args.capacity, args.dtype, device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="beatrice_vst_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("init-model", help="create a random-init model directory")
    pi.add_argument("dir")
    pi.add_argument("--version", default="2.0.0-rc.0", choices=VERSION_NAMES)
    pi.add_argument("--voices", type=int, default=4)
    pi.add_argument("--seed", type=int, default=0)
    pi.set_defaults(fn=cmd_init_model)

    pn = sub.add_parser("info", help="print model card info")
    pn.add_argument("--model", required=True)
    pn.set_defaults(fn=cmd_info)

    pc = sub.add_parser("convert", help="offline voice conversion")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--model", required=True, help="model dir or config.toml")
    pc.add_argument("--voice", type=int, default=0)
    pc.add_argument("--morph", default=None,
                    help="comma-separated per-voice morph weights (enables morph mode)")
    pc.add_argument("--pitch-shift", type=float, default=0.0)
    pc.add_argument("--formant-shift", type=float, default=0.0)
    pc.add_argument("--average-source-pitch", type=float, default=52.0)
    pc.add_argument("--intonation", type=float, default=1.0)
    pc.add_argument("--pitch-correction", type=float, default=0.0)
    pc.add_argument("--pitch-correction-type", type=int, default=0, choices=[0, 1])
    pc.add_argument("--vq-neighbors", type=int, default=0)
    pc.add_argument("--soft-pitch", action="store_true",
                    help="condition the vocoder on E[bin] over the pitch logits instead of "
                         "the argmax")
    pc.add_argument("--output-rate", type=int, default=None)
    pc.add_argument("--dtype", default=None, choices=[None, "bfloat16"], nargs="?")
    pc.add_argument("--seq-parallel", type=int, default=0, metavar="N",
                    help="cut the utterance into N segments run as one batch "
                         "(runtime/seqpar.py)")
    pc.set_defaults(fn=cmd_convert)

    pt = sub.add_parser("train", help="distillation training loop")
    pt.add_argument("--model", required=True, help="student model dir")
    pt.add_argument("--teacher", default=None, help="teacher model dir")
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--batch", type=int, default=8)
    pt.add_argument("--frames", type=int, default=32)
    pt.add_argument("--lr", type=float, default=2e-4)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--output", default=None)
    pt.add_argument("--data", default=None,
                    help="WAV-pair dataset dir (inputs/ [+ targets/]); identity mode when "
                         "targets/ is absent")
    pt.add_argument("--gan", action="store_true",
                    help="adversarial training (MPD+MRD+PCD critics, feature matching)")
    pt.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (params + optimizer state)")
    pt.add_argument("--save-every", type=int, default=500)
    pt.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    pt.set_defaults(fn=cmd_train)

    ps = sub.add_parser("serve", help="streaming voice-conversion server "
                                      "(TCP, WebSocket or gRPC)")
    ps.add_argument("--model", required=True)
    ps.add_argument("--port", type=int, default=7777)
    ps.add_argument("--capacity", type=int, default=64)
    ps.add_argument("--dtype", default=None, choices=[None, "bfloat16"], nargs="?")
    ps.add_argument("--ws", action="store_true",
                    help="serve the WebSocket protocol instead of raw TCP")
    ps.add_argument("--grpc", action="store_true",
                    help="serve the gRPC protocol instead of raw TCP")
    ps.set_defaults(fn=cmd_serve)

    pp = sub.add_parser("parity", help="streaming-vs-chunk parity gate")
    pp.add_argument("--version", default="2.0.0-rc.0", choices=VERSION_NAMES)
    pp.add_argument("--frames", type=int, default=25)
    pp.set_defaults(fn=cmd_parity)

    for sp in (pc, pt, ps, pp):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the engine runs (default: the card)")

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
