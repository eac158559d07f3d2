"""Command-line interface of the port (port of `beatrice_vst_tpu/cli.py`).

    python -m beatrice_vst_tpu_torch.cli init-model DIR [--version V] [--voices N]
    python -m beatrice_vst_tpu_torch.cli info --model DIR
    python -m beatrice_vst_tpu_torch.cli convert IN.wav OUT.wav --model DIR
        [--voice N | --morph w0,w1,...] [--pitch-shift ST] [--formant-shift ST]
        [--intonation X] [--pitch-correction X] [--vq-neighbors N] ...
    python -m beatrice_vst_tpu_torch.cli parity [--version V] [--frames T]
    python -m beatrice_vst_tpu_torch.cli serve --model DIR [--port P] [--capacity C]
        [--dtype bfloat16] [--ws | --grpc]

The same parameters as the JAX CLI, over the port's offline converter, the
parity harness and the streaming server.  `convert`, `parity` and `serve`
run on the card unless `--device cpu` is given.  `train` and
`convert --seq-parallel` are not ported yet.
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
    t0 = time.perf_counter()
    out = convert_utterance(params, model_cfg, bank, audio, sr, settings,
                            out_sample_rate=args.output_rate or sr,
                            compute_dtype=getattr(torch, args.dtype) if args.dtype else None,
                            device=args.device)
    dt = time.perf_counter() - t0
    write_wav(args.output, out, args.output_rate or sr)
    dur = len(audio) / sr
    print(f"converted {dur:.2f}s of audio in {dt:.2f}s ({dur / dt:.1f}x real-time) "
          f"-> {args.output}")


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
    pc.set_defaults(fn=cmd_convert)

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

    for sp in (pc, ps, pp):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the engine runs (default: the card)")

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
