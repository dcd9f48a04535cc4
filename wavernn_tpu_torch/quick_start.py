"""Quick-start synthesis from pretrained checkpoints (ports
``quick_start.py``, after the reference's ``quick_start.py``).

    python -m wavernn_tpu_torch.quick_start [-i TEXT] [-b | -u] \\
        [--hp_file hparams.py] [--device cuda] [-c]

Unzips the pretrained archives, where they exist under ``pretrained/``,
into ``quick_start/`` and synthesizes every line of ``sentences.txt``, or
``--input_text``: Tacotron text -> mel (the TTS kernel on the card), then
the WaveRNN vocoder (the decode kernel), batched at target 11,000 /
overlap 550 or unbatched.  The archives hold
``latest_weights.msgpack`` as either package writes it; a reference
``.pyt`` converts with ``python -m
wavernn_tpu_torch.tools.convert_torch_checkpoint``.  The WAVs land in
``quick_start/`` under the JAX package's names.  The device defaults to
``cuda`` and is never swapped for another: without CUDA the command fails;
``-c`` / ``--force_cpu`` means ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import zipfile
from pathlib import Path

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import audio
from wavernn_tpu_torch.gen_tacotron import load_weights
from wavernn_tpu_torch.infer.pipeline import mel_from_linear
from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.infer.wavernn import make_generator
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.text import text_to_sequence
from wavernn_tpu_torch.text.symbols import symbols
from wavernn_tpu_torch.tools import device_of
from wavernn_tpu_torch.training.tacotron import r_for_step
from wavernn_tpu_torch.utils.display import simple_table

VOC_ZIP = "pretrained/ljspeech.wavernn.mol.800k.zip"
TTS_ZIP = "pretrained/ljspeech.tacotron.r2.180k.zip"
VOC_WEIGHTS = "quick_start/voc_weights/latest_weights.msgpack"
TTS_WEIGHTS = "quick_start/tts_weights/latest_weights.msgpack"
TARGET, OVERLAP = 11_000, 550


def maybe_unzip(zip_path: str, out_dir: str):
    if Path(zip_path).exists():
        os.makedirs(out_dir, exist_ok=True)
        with zipfile.ZipFile(zip_path, "r") as zf:
            zf.extractall(out_dir)


def main(argv=None) -> list:
    """Synthesize; returns the written WAV paths."""
    parser = argparse.ArgumentParser(description="TTS Generator (quick start)")
    parser.add_argument("--input_text", "-i", type=str,
                        help="[string] type in something here and TTS will "
                             "generate it!")
    parser.add_argument("--batched", "-b", dest="batched",
                        action="store_true",
                        help="fast batched generation (lower quality)")
    parser.add_argument("--unbatched", "-u", dest="batched",
                        action="store_false",
                        help="slower unbatched generation (better quality)")
    parser.add_argument("--force_cpu", "-c", action="store_true",
                        help="force CPU-only generation (--device cpu)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--hp_file", metavar="FILE", default="hparams.py",
                        help="the file to use for the hyperparameters")
    parser.set_defaults(batched=True, input_text=None)
    args = parser.parse_args(argv)

    hp.configure(args.hp_file)
    dev = device_of("cpu" if args.force_cpu else args.device)
    print("Using device:", dev)

    maybe_unzip(VOC_ZIP, "quick_start/voc_weights/")
    maybe_unzip(TTS_ZIP, "quick_start/tts_weights/")

    print("\nInitialising WaveRNN Model...\n")
    voc_cfg = WaveRNNConfig.from_hp(hp)
    voc_vars, voc_step = load_weights(VOC_WEIGHTS, hp.voc_model_id, "wavernn")
    # one Generator for every sentence, float out for audio.save_wav
    voc = make_generator(voc_cfg, voc_vars, dev, output_dtype="float64")

    print("\nInitialising Tacotron Model...\n")
    tts_cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
    tts_vars, tts_step = load_weights(TTS_WEIGHTS, hp.tts_model_id,
                                      "tacotron")
    r = r_for_step(tts_step, hp.tts_schedule)

    if args.input_text:
        inputs = [text_to_sequence(args.input_text.strip(),
                                   hp.tts_cleaner_names)]
    else:
        with open("sentences.txt") as f:
            inputs = [text_to_sequence(line.strip(), hp.tts_cleaner_names)
                      for line in f]

    voc_k = voc_step // 1000
    tts_k = tts_step // 1000
    simple_table([
        ("WaveRNN", str(voc_k) + "k"),
        (f"Tacotron(r={r})", str(tts_k) + "k"),
        ("Generation Mode", "Batched" if args.batched else "Unbatched"),
        ("Target Samples", TARGET if args.batched else "N/A"),
        ("Overlap Samples", OVERLAP if args.batched else "N/A"),
    ])

    tts = TTSGenerator(tts_cfg, tts_vars, dev)
    os.makedirs("quick_start", exist_ok=True)
    written = []
    for i, x in enumerate(inputs, 1):
        print(f"\n| Generating {i}/{len(inputs)}")
        _, m, _ = tts(x, r=r)

        if args.input_text:
            save_path = f"quick_start/__input_{args.input_text[:10]}_{tts_k}k.wav"
        else:
            save_path = f"quick_start/{i}_batched{str(args.batched)}_{tts_k}k.wav"

        wav = voc(mel_from_linear(m), batched=args.batched, target=TARGET,
                  overlap=OVERLAP, mu_law=hp.mu_law)
        audio.save_wav(wav, save_path)
        written.append(Path(save_path))

    print("\n\nDone.\n")
    return written


if __name__ == "__main__":
    main()
