"""Text -> speech CLI of the PyTorch port: Tacotron mel -> WaveRNN
waveform (ports ``gen_tacotron.py``).

    python -m wavernn_tpu_torch.gen_tacotron --input_text "Hello there." \\
        --tts_weights TACO.msgpack [--hp_file hparams.py] [--device cuda] \\
        wavernn --voc_weights bench_assets/wavernn_mol_golden.msgpack

    python -m wavernn_tpu_torch.gen_tacotron --input_text "Hello there." \\
        --tts_weights TACO.msgpack griffinlim [--iters 32]

Without ``--input_text`` every line of ``sentences.txt`` (in the working
directory) is synthesized.  The device defaults to ``cuda`` and is never
swapped for another: without CUDA the command fails.  ``--device cpu``
runs the kernels' plain PyTorch versions instead, at CPU speed.  The
``griffinlim`` vocoder is ``dsp/torch_audio.py::reconstruct_waveform``
(NNLS mel inversion and Griffin-Lim on the device).  ``--save_attention``
writes each utterance's attention beside its WAV, as ``<stem>.png`` and
``<stem>_attention.npy`` (``utils/display.py::save_attention``).

``--mesh`` shards the WaveRNN vocoder's fold rows over a device mesh, as
``gen_wavernn --mesh`` does (Tacotron decodes one utterance at a time, on
``--device``).  ``--int8`` / ``--no_int8`` set ``hp.gen_int8``, the
WaveRNN decode kernel's ``int8_gates`` variant, as in ``gen_wavernn``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import audio, wavio
from wavernn_tpu_torch.dsp.torch_audio import reconstruct_waveform
from wavernn_tpu_torch.infer.pipeline import mel_from_linear
from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.gen_wavernn import int8_overrides
from wavernn_tpu_torch.infer.wavernn import make_generator
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.parallel.mesh import add_mesh_args, mesh_from_args
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.text.symbols import symbols
from wavernn_tpu_torch.training.tacotron import r_for_step
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from wavernn_tpu_torch.utils.display import save_attention


def load_weights(path, model_id: str, kind: str):
    """(variables, step) of the weights at ``path``, or, where ``path`` is
    None, of the latest checkpoint ``checkpoints/<model_id>.<kind>``."""
    path = Path(path if path else Path("checkpoints") / f"{model_id}.{kind}"
                / "latest_weights.msgpack")
    blob = load_pytree(path)
    return ({"params": blob["params"], "batch_stats": blob["batch_stats"]},
            int(blob.get("step", 0)))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="TTS generator of the PyTorch port")
    parser.add_argument("--input_text", "-i", type=str,
                        help="[string] the text to synthesize")
    parser.add_argument("--tts_weights", type=str,
                        help="[string/path] Tacotron weights (.msgpack as "
                             "the JAX package writes them)")
    parser.add_argument("--save_attention", "-a", dest="save_attn",
                        action="store_true", help="save attention plots")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--tts_backend", choices=["auto", "kernel", "plain"],
                        default="auto",
                        help="decoder backend: the CUDA kernel (B=1) or the "
                             "plain PyTorch decoder")
    int8_group = parser.add_mutually_exclusive_group()
    int8_group.add_argument("--int8", action="store_true",
                            help="int8 gate weights in the vocoder kernel "
                                 "(int8_gates; sets hp.gen_int8)")
    int8_group.add_argument("--no_int8", action="store_true",
                            help="no int8 gate weights (overrides "
                                 "hp.gen_int8)")
    add_mesh_args(parser)
    parser.add_argument("--output_dir", type=str,
                        help="where the WAVs go (default "
                             "model_outputs/<tts_model_id>.tacotron)")
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py",
                        help="the file to use for the hyperparameters")
    subparsers = parser.add_subparsers(required=True, dest="vocoder")
    wr = subparsers.add_parser("wavernn", aliases=["wr"])
    wr.add_argument("--batched", "-b", dest="batched", action="store_true")
    wr.add_argument("--unbatched", "-u", dest="batched",
                    action="store_false")
    wr.add_argument("--overlap", "-o", type=int,
                    help="[int] crossover samples")
    wr.add_argument("--target", "-t", type=int,
                    help="[int] samples per batch index")
    wr.add_argument("--voc_weights", type=str,
                    help="[string/path] WaveRNN weights")
    wr.set_defaults(batched=None)
    gl = subparsers.add_parser("griffinlim", aliases=["gl"])
    gl.add_argument("--iters", type=int, default=32,
                    help="[int] griffinlim iterations")
    args = parser.parse_args(argv)

    hp.configure(args.hp_file, **int8_overrides(args))
    out_dir = Path(args.output_dir if args.output_dir else
                   Path("model_outputs") / f"{hp.tts_model_id}.tacotron")
    tts_cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
    tts_vars, tts_step = load_weights(args.tts_weights, hp.tts_model_id,
                                      "tacotron")
    r = r_for_step(tts_step, hp.tts_schedule)
    tts = TTSGenerator(tts_cfg, tts_vars, args.device,
                       backend=args.tts_backend)
    tts_k = tts_step // 1000
    head = (f"Using device: {tts.device} | Tacotron {tts_k}k, r={r}, "
            f"{tts.backend} decode | ")

    if args.vocoder in ("griffinlim", "gl"):
        v_type = "griffinlim"
        print(head + f"Griffin-Lim, {args.iters} iterations")

        def vocode(mel, path):
            wav = reconstruct_waveform(mel, n_iter=args.iters,
                                       device=args.device)
            audio.save_wav(wav, path)
            return wav
    else:
        target = hp.voc_target if args.target is None else args.target
        overlap = hp.voc_overlap if args.overlap is None else args.overlap
        batched = hp.voc_gen_batched if args.batched is None else args.batched
        voc_cfg = WaveRNNConfig.from_hp(hp)
        voc_vars, voc_step = load_weights(args.voc_weights, hp.voc_model_id,
                                          "wavernn")
        voc = make_generator(voc_cfg, voc_vars, args.device,
                             mesh=mesh_from_args(args, hp.get("mesh_shape")))
        v_type = "wavernn_batched" if batched else "wavernn_unbatched"
        print(head + f"WaveRNN {voc_step // 1000}k, "
              f"{'batched' if batched else 'unbatched'} target {target} "
              f"overlap {overlap}{', int8_gates' if voc.int8_gates else ''}")

        def vocode(mel, path):
            wav = voc(mel, batched=batched, target=target, overlap=overlap,
                      mu_law=hp.mu_law)
            wavio.save_pcm16(wav, path, voc_cfg.sample_rate)
            return wav

    if args.input_text:
        texts = [args.input_text]
    else:
        with open("sentences.txt") as f:
            texts = [line for line in f if line.strip()]
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for i, text in enumerate(texts, 1):
        print(f"| Generating {i}/{len(texts)}")
        _, m, attention = tts(text_to_sequence(text.strip(),
                                               hp.tts_cleaner_names), r=r)
        path = out_dir / (f"__input_{args.input_text[:10]}_{v_type}_{tts_k}k"
                          ".wav" if args.input_text
                          else f"{i}_{v_type}_{tts_k}k.wav")
        if args.save_attn:
            save_attention(attention, path, save_raw=True)
        wav = vocode(mel_from_linear(m), path)
        print(f"| {m.shape[1]} frames -> {len(wav)} samples: {path}")
        written.append(path)
    print("Done.")
    return written


if __name__ == "__main__":
    main()
