"""Trained two-stage end-to-end TTS proof on a synthetic corpus (ports
``examples/e2e_tts.py``).

    python -m wavernn_tpu_torch.examples.e2e_tts [--workspace DIR] [--keep] \\
        [--voc_steps 3000] [--tts_steps 6000] [--seed 0] [--gates_only] \
        [--device cuda]

The reference's convergence criterion is a diagonal attention alignment
plus recognizable audio (ref: README.md:36, train_tacotron.py:163-166).
This demo builds a tiny note-language corpus (each symbol is a pure
tone), drives the port's CLIs end to end -

    preprocess -> train_tacotron (curriculum + GTA export)
               -> train_wavernn --gta -> gen_tacotron (both kernels)

- from scratch to trained weights, then GATES the result:

  1. attention diagonality: the argmax attention path of every generated
     utterance must be monotone, cover the text and be sharp;
  2. output spectrum: each generated wav, segmented per symbol, must
     reproduce that symbol's tone (dominant-frequency match).

The CLIs run in this process (:func:`run_cli`), from the workspace, with
the ``hp`` singleton cleared before and after each, so that no
configuration outlives a run.  Artifacts (wavs, attention PNG + .npy) land
in ``<workspace>/model_outputs``.  :func:`run_pipeline` and
:func:`measure_gates` let a caller run a cut corpus and depth.  The device
defaults to ``cuda`` and is never swapped for another: without CUDA the
command fails.  ``--seed`` is the Tacotron trainer's mask seed
(``train_tacotron --seed``; 0 is the JAX example's stream).  Prints one
JSON line with the measured gates.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

from wavernn_tpu_torch.tools import device_of

REPO = Path(__file__).resolve().parents[2]

# The note language: one SYMBOL (after text normalization) = one pure
# tone.  Notes are SHORT (~10 mel frames) so note transitions - the
# moments where the decoder cannot predict the next frame from its own
# output and must consult the text - are frequent: that is what forces the
# attention to become diagonal.  Texts VARY in length so training batches
# contain padded text positions; audio ends in silence so the decoder
# learns the stop condition.  The corpus routes through the full
# english_cleaners frontend: raw texts carry digits (verbalized, "2" ->
# "two") and {ARPAbet} phoneme spans (@phoneme symbols), and the audio is
# synthesized from the CLEANED symbol sequence.
NOTE_SECONDS = 0.125
TAIL_SILENCE_SECONDS = 0.25
SR = 22050
CLEANERS = ["english_cleaners"]
GATES = dict(min_monotone=0.85, min_coverage=0.7, min_sharpness=0.4,
             min_spectral=0.6)

# The corpus must be LARGE relative to the decoder's capacity: with a few
# dozen melodies the decoder memorizes each sequence and attention
# collapses onto the leading characters.  ~1200 random melodies make
# alignment the only strategy that fits the data.
_rng = np.random.default_rng(7)


def _melody(n):
    return "".join(_rng.choice(list("abcde"), int(n)))


TRAIN_TEXTS = (
    ["abcdeabcde", "ebcadebcad", "dcbaedcbae", "abc 2 de", "ab {AH} cde"]
    + [_melody(n) for n in _rng.integers(8, 13, 1075)]
    # digit + phoneme-span melodies: frequent enough that the decoder
    # learns the verbalized "two" and the @AH symbol like any note
    + [f"{_melody(4)} 2 {_melody(4)}" for _ in range(60)]
    + [f"{_melody(4)} {{AH}} {_melody(4)}" for _ in range(60)]
)
EVAL_TEXTS = ["abcdeabcde", "abc 2 de", "ab {AH} cde"]


def _seq(text):
    from wavernn_tpu_torch.text import text_to_sequence

    return text_to_sequence(text, CLEANERS)


def _symbol_tones():
    """Deterministic symbol-id -> tone map over every symbol the corpus
    uses after cleaning, spaced 28% apart so the spectral gate's +-12%
    windows never overlap.  Every symbol gets a tone, the space included,
    so utterances are continuous tone streams (an in-utterance silence
    would mimic the mel padding and trip the stop condition)."""
    used = sorted({sid for text in TRAIN_TEXTS + EVAL_TEXTS
                   for sid in _seq(text)})
    return {sid: 261.6 * (1.28 ** k) for k, sid in enumerate(used)}


def build_corpus(wav_dir: Path, texts: Sequence[str] = TRAIN_TEXTS):
    """One WAV per text (its cleaned symbols as enveloped tones, then a
    silent tail) and an LJSpeech ``metadata.csv``."""
    from wavernn_tpu_torch.dsp import wavio

    tones = _symbol_tones()
    wav_dir.mkdir(parents=True, exist_ok=True)
    n = int(NOTE_SECONDS * SR)
    t = np.arange(n) / SR
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / 300.0)
    tail = np.zeros(int(TAIL_SILENCE_SECONDS * SR), np.float32)
    lines = []
    for i, text in enumerate(texts):
        wav = np.concatenate([
            0.5 * env * np.sin(2 * np.pi * tones[sid] * t)
            for sid in _seq(text)
        ] + [tail]).astype(np.float32)
        wavio.save_wav(wav, wav_dir / f"utt{i}.wav", sr=SR)
        lines.append(f"utt{i}|{text}|{text}")
    (wav_dir / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")


HP_TEMPLATE = """
import sys; sys.path.insert(0, {repo!r})
from hparams import *

wav_path = 'wavs'
data_path = 'data'
tts_cleaner_names = ['english_cleaners']

# vocoder: RAW mu-law, mid-size dims (tones are easy; speed over capacity)
voc_mode = 'RAW'
voc_rnn_dims = 256
voc_fc_dims = 256
voc_batch_size = 16
voc_total_steps = {voc_steps}
voc_checkpoint_every = 100000
voc_gen_at_checkpoint = 0
voc_test_samples = 2
voc_lr = 4e-4

# tacotron: compact config; reference-style curriculum starting at high r
# (fewer decoder steps per char force the attention to advance) and the
# reference's 0.5 prenet dropout (starves the autoregressive path so the
# decoder MUST read the text)
tts_embed_dims = 128
tts_encoder_dims = 64
tts_decoder_dims = 128
tts_postnet_dims = 64
tts_encoder_K = 8
tts_lstm_dims = 256
tts_postnet_K = 4
tts_num_highways = 2
tts_schedule = [(7, 1e-3, {tts_s1}, 8),
                (2, 3e-4, {tts_s2}, 8)]
tts_checkpoint_every = 100000
tts_max_mel_len = 2000
tts_bin_lengths = False
# bucket padded batch shapes so the varied-length corpus makes a couple of
# batch shapes instead of one per (L_max, T_max) combination
tts_pad_text_multiple = 16
tts_pad_mel_multiple = 16
"""


def run_cli(main, argv, cwd: Path, tag: str):
    """A CLI's ``main(argv)`` in this process from ``cwd``, with ``hp``
    cleared before and after it."""
    from wavernn_tpu_torch.config import hp

    print(f"\n=== {tag}: {' '.join(argv)}", flush=True)
    here = os.getcwd()
    hp.reset()
    os.chdir(cwd)
    try:
        return main(argv)
    finally:
        os.chdir(here)
        hp.reset()


def run_pipeline(ws: Path, voc_steps: int, tts_steps: int, device: str,
                 texts: Sequence[str] = TRAIN_TEXTS,
                 num_workers: int = None, seed: int = 0) -> None:
    """The corpus of ``texts``, the hp file and the four CLI runs in
    ``ws``; ``num_workers`` is the preprocess CLI's (its default when
    None), ``seed`` the Tacotron trainer's."""
    from wavernn_tpu_torch import (
        gen_tacotron, preprocess, train_tacotron, train_wavernn,
    )

    build_corpus(ws / "wavs", texts)
    (ws / "hp_e2e.py").write_text(HP_TEMPLATE.format(
        repo=str(REPO), voc_steps=voc_steps,
        tts_s1=tts_steps // 3, tts_s2=tts_steps,
    ), encoding="utf-8")
    (ws / "sentences.txt").write_text("\n".join(EVAL_TEXTS), encoding="utf-8")

    hp = ["--hp_file", "hp_e2e.py"]
    dev = ["--device", device]
    workers = [] if num_workers is None else ["--num_workers",
                                              str(num_workers)]
    run_cli(preprocess.main, ["--path", "wavs"] + workers + hp, ws,
            "preprocess")
    run_cli(train_tacotron.main, hp + dev + ["--seed", str(seed)], ws,
            "train_tacotron (+GTA export)")
    run_cli(train_wavernn.main, ["--gta"] + hp + dev, ws,
            "train_wavernn (GTA)")
    run_cli(gen_tacotron.main, ["--save_attention"] + hp + dev
            + ["wavernn", "--batched"], ws, "gen_tacotron")


def diagonality(attn: np.ndarray, text_len: int):
    """Monotonicity + coverage of the argmax attention path - the numeric
    form of the reference's 'diagonal attention plot' criterion.

    Sharpness is measured over the attention MARCH (decoder steps up to the
    path's first arrival at its final text position), not the whole decode:
    once the text is rendered, the decoder emits near-silence frames until
    the stop fires and attends diffusely, which says nothing about
    alignment.  Flat attention stays caught: the coverage gate kills a
    path that does not march."""
    path = attn.argmax(axis=1)
    steps = np.diff(path)
    monotone = float((steps >= 0).mean()) if len(steps) else 0.0
    coverage = float(len(np.unique(path))) / max(text_len, 1)
    reached = int(np.nonzero(path >= path.max())[0][0])
    sharp = float(attn[: reached + 1].max(axis=1).mean())
    return monotone, coverage, sharp


def dominant_freq(seg: np.ndarray) -> float:
    w = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    w[:4] = 0.0  # ignore DC drift
    return float(np.fft.rfftfreq(len(seg), 1 / SR)[int(np.argmax(w))])


def spectral_match(wav: np.ndarray, seq, tones):
    """Fraction of CLEANED symbols whose generated segment peaks at that
    symbol's note (within 12%)."""
    n = int(NOTE_SECONDS * SR)
    hits = total = 0
    for i, sid in enumerate(seq):
        seg = wav[i * n: (i + 1) * n]
        if len(seg) < n // 2:
            break
        total += 1
        if abs(dominant_freq(seg) - tones[sid]) / tones[sid] < 0.12:
            hits += 1
    return hits / max(total, 1)


def measure_gates(ws: Path) -> dict:
    """The gates of the EVAL_TEXTS' generated attention and WAVs under
    ``ws/model_outputs/*.tacotron``: per utterance and their minima."""
    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.text.symbols import symbols

    tones = _symbol_tones()
    out_dir = next((ws / "model_outputs").glob("*.tacotron"))
    gates = {"cleaners": CLEANERS, "utterances": []}
    for i, text in enumerate(EVAL_TEXTS, 1):
        attn = np.load(next(out_dir.glob(f"{i}_*_attention.npy")))
        wav = wavio.load_wav(next(out_dir.glob(f"{i}_*.wav")), sr=SR)
        seq = _seq(text)
        mono, cov, sharp = diagonality(attn, len(seq))
        spec = spectral_match(np.asarray(wav, np.float64), seq, tones)
        gates["utterances"].append({
            "text": text,
            # the post-frontend symbol string: the verbalized digits and
            # {ARPAbet} spans that flowed through the pipeline
            "cleaned": "".join(
                s if len(s) == 1 else f"[{s}]" for s in
                (symbols[sid] for sid in seq)),
            "attn_monotone": round(mono, 3),
            "attn_coverage": round(cov, 3), "attn_sharpness": round(sharp, 3),
            "spectral_match": round(spec, 3),
            "audio_s": round(len(wav) / SR, 2),
        })
    for key, field in (("min_monotone", "attn_monotone"),
                       ("min_coverage", "attn_coverage"),
                       ("min_sharpness", "attn_sharpness"),
                       ("min_spectral", "spectral_match")):
        gates[key] = min(u[field] for u in gates["utterances"])
    gates["workspace"] = str(ws)
    return gates


def gates_pass(gates: dict) -> bool:
    """Monotone alone is met by flat attention (a constant argmax path), so
    the criterion is the conjunction: monotone path + full text coverage +
    sharp attention + tone-accurate audio."""
    return all(gates[k] >= v for k, v in GATES.items())


def evaluate_gates(ws: Path, args) -> dict:
    gates = measure_gates(ws)
    print(json.dumps(gates))
    if not gates_pass(gates):
        raise SystemExit(
            f"E2E gates FAILED: {json.dumps(gates)} - attention not diagonal "
            "enough or output tones off; artifacts kept at " + str(ws))
    print("E2E TTS gates PASSED (diagonal attention + tone-accurate audio)")
    if not args.keep and args.workspace is None:
        shutil.rmtree(ws, ignore_errors=True)
    return gates


def main(argv=None) -> dict:
    """Returns the measured gates (raises SystemExit when they fail)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workspace", default=None,
                    help="working dir (default: a temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the workspace after the run")
    ap.add_argument("--voc_steps", type=int, default=3000)
    ap.add_argument("--tts_steps", type=int, default=6000,
                    help="total Tacotron steps across the 2-session schedule")
    ap.add_argument("--seed", type=int, default=0,
                    help="the Tacotron trainer's mask seed (default 0)")
    ap.add_argument("--gates_only", action="store_true",
                    help="skip the pipeline and re-evaluate the gates on an "
                         "existing workspace's artifacts")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the CLIs (default cuda)")
    args = ap.parse_args(argv)
    if not args.gates_only:
        device_of(args.device)

    ws = Path(args.workspace or tempfile.mkdtemp(prefix="e2e_tts_"))
    ws.mkdir(parents=True, exist_ok=True)
    print(f"workspace: {ws}")
    if not args.gates_only:
        run_pipeline(ws, args.voc_steps, args.tts_steps, args.device,
                     seed=args.seed)
    return evaluate_gates(ws, args)


if __name__ == "__main__":
    main()
