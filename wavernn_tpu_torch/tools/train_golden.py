"""Train the golden checkpoints with the port's trainers, into an output
directory (ports ``tools/train_golden.py``).

    python -m wavernn_tpu_torch.tools.train_golden --which WHICH --out DIR
        [--steps N] [--taco_steps1 N] [--taco_steps2 N] [--from DIR]
        [--hp_file PATH] [--device cuda|cpu]

The corpora are the JAX tool's, copied here byte for byte in numpy: a
harmonic tone with vibrato, a speech-shaped formant signal, and a
note-language text corpus in which each symbol is a pure tone.  Training
runs through the port's trainers (``training/wavernn.py::make_train_step``,
``training/tacotron.py::make_tts_train_step``) on ``--device``; the pins
are decoded by the port's plain float32 decoders on the CPU, as the JAX
tool pins on the CPU.  ``--hp_file`` (default ``hparams.py``) gives the
audio parameters, and for ``full`` the model and the fold geometry of its
MCD.

``--which`` (each file lands in ``--out``, never elsewhere):

* ``tiny``: the miniature RAW WaveRNN, ``--steps`` (300) steps on the
  harmonic corpus; ``tiny_wavernn_raw.msgpack``, the deterministic scan
  decode of its first 120 frames ``tiny_wavernn_raw_wav.npy`` and that mel
  ``tiny_wavernn_raw_mel.npy``.
* ``taco``: the tiny Tacotron (``TACO_DIMS``) on the note corpus,
  ``--taco_steps1`` steps at r = 7 then ``--taco_steps2`` at r = 2;
  ``tiny_tacotron.msgpack``, ``tiny_tacotron_gt_mel.npy`` and
  ``tiny_tacotron_meta.json``, then the pin below.
* ``taco-pin``: decodes the eval text with the trained Tacotron of
  ``--from`` (default ``--out``; the committed ``tests/golden`` for the
  repository's golden) and checks its attention gates; writes
  ``tiny_tacotron_mel.npy``, ``tiny_tacotron_attn.npy`` and the meta with
  the measured gates under ``pinned_gates_cpu_xla`` (the key the
  repository's readers of the pin use).
* ``full``: the full-size MOL WaveRNN of the hp file, ``--steps`` (3000)
  steps on the speech corpus; ``wavernn_mol_golden.msgpack``,
  ``golden_eval_mel.npy`` (its first 1200 frames) and ``golden_meta.json``
  with the copy-synthesis MCD of the float32 scan decoder (6 seeds) and,
  on the card, of the decode kernel (3 seeds).

``--out`` may not lie inside ``tests/golden`` or ``bench_assets``: those
hold the JAX package's pins and stay as they are.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from wavernn_tpu_torch.tools import REPO, card, device_of, hparams, metric

PINNED_DIRS = (REPO / "tests" / "golden", REPO / "bench_assets")


def harmonic_signal(sr: int, seconds: float) -> np.ndarray:
    """Harmonic tone with mild vibrato: spectral structure for MCD, easy
    for an overfit vocoder (the corpus of ``kernel_quality`` too)."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = 180.0 + 8.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = sum((0.5 ** k) * np.sin((k + 1) * phase) for k in range(4))
    return (0.45 * y / np.abs(y).max()).astype(np.float32)


# vowel formant targets (F1, F2, F3) Hz: a rough adult-male vowel space
_VOWELS = [(730, 1090, 2440),   # /a/
           (270, 2290, 3010),   # /i/
           (300, 870, 2240),    # /u/
           (530, 1840, 2480),   # /e/
           (570, 840, 2410)]    # /o/


def speech_signal(sr: int, seconds: float, seed: int = 3) -> np.ndarray:
    """Speech-shaped corpus: a glottal pulse train with a wandering f0,
    filtered through per-"phone" formant resonator cascades, between
    unvoiced fricative-like noise and short pauses."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    t = np.arange(n) / sr
    # phrase-level f0: declining contour + slow wander, 90-160 Hz
    f0 = 120.0 * 2 ** (0.25 * np.sin(2 * np.pi * 0.37 * t)
                       + 0.12 * np.sin(2 * np.pi * 1.7 * t + 1.0))
    phase_frac = np.cumsum(f0) / sr % 1.0
    # sawtooth source ~ glottal pulse train (-6 dB/oct harmonics)
    source = (2.0 * phase_frac - 1.0).astype(np.float64)

    out = np.zeros(n)
    pos = 0
    while pos < n:
        seg_len = int(rng.uniform(0.12, 0.3) * sr)
        seg_len = min(seg_len, n - pos)
        kind = rng.uniform()
        if kind < 0.12:                      # pause
            pass
        elif kind < 0.30:                    # unvoiced fricative: shaped noise
            noise = rng.standard_normal(seg_len)
            fc = rng.uniform(2500.0, 6000.0)
            r = 0.92
            w = 2 * np.pi * fc / sr
            seg = lfilter([1.0, -1.0], [1.0, -2 * r * np.cos(w), r * r],
                          noise)
            peak = np.abs(seg).max()
            out[pos: pos + seg_len] = 0.25 * seg / max(peak, 1e-9)
        else:                                # voiced vowel: formant cascade
            f1, f2, f3 = _VOWELS[rng.integers(0, len(_VOWELS))]
            seg = source[pos: pos + seg_len].copy()
            for fc, bw in ((f1, 80.0), (f2, 110.0), (f3, 160.0)):
                r = np.exp(-np.pi * bw / sr)
                w = 2 * np.pi * fc / sr
                seg = lfilter([1.0 - r], [1.0, -2 * r * np.cos(w), r * r],
                              seg)
            peak = np.abs(seg).max()
            out[pos: pos + seg_len] = seg / max(peak, 1e-9)
        pos += seg_len
    # 5 ms segment-boundary smoothing removes filter-edge clicks
    k = int(0.005 * sr)
    win = np.hanning(2 * k + 1)
    win /= win.sum()
    out = np.convolve(out, win, mode="same")
    return (0.45 * out / np.abs(out).max()).astype(np.float32)


def batches(mel, y, labels, mode: str, batch_size: int, seq_len: int,
            pad: int, hop: int, bits: int, seed: int = 0):
    """The training batch sampler: a function that draws ``batch_size``
    random windows of (mel, audio) from one long utterance, (x, target,
    mels) as the vocoder's train step takes them."""
    from wavernn_tpu_torch.dsp.audio import label_2_float

    rng = np.random.default_rng(seed)
    mel_win = seq_len // hop + 2 * pad
    max_off = mel.shape[1] - 2 - (mel_win + 2 * pad)

    def batch():
        offs = rng.integers(0, max_off, batch_size)
        ms = np.stack([mel[:, o: o + mel_win]
                       for o in offs]).transpose(0, 2, 1)
        if mode == "RAW":
            lab = np.stack([labels[(o + pad) * hop:][: seq_len + 1]
                            for o in offs])
            x = label_2_float(lab[:, :-1].astype(np.float32), bits)
            return x.astype(np.float32), lab[:, 1:].astype(np.int32), ms
        seg = np.stack([y[(o + pad) * hop:][: seq_len + 1]
                        for o in offs]).astype(np.float32)
        return seg[:, :-1], seg[:, 1:], ms

    return batch


def train(cfg, mel, y, labels, steps: int, batch_size: int, seq_len: int,
          lr: float, clip: float, pad: int, hop: int, device,
          log_every: int = 200):
    """Train a WaveRNN (weights from ``torch.manual_seed(0)``) on random
    windows of one utterance.  Returns (state, last loss, seconds)."""
    import torch

    from wavernn_tpu_torch.models.wavernn import WaveRNN
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )
    from wavernn_tpu_torch.training.wavernn import make_train_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = WaveRNN(cfg)
    opt = make_optimizer(lr, clip)
    state = new_train_state(model.to(device), opt)
    train_step = make_train_step(opt, cfg.mode)
    batch = batches(mel, y, labels, cfg.mode, batch_size, seq_len, pad, hop,
                    cfg.bits)
    t0 = time.perf_counter()
    loss = float("nan")
    for i in range(1, steps + 1):
        state, loss, _ = train_step(state, *batch())
        if i % log_every == 0:
            print(f"step {i}/{steps} loss={float(loss):.4f}",
                  file=sys.stderr)
    loss = float(loss)
    return state, loss, time.perf_counter() - t0


def run_tiny(out: Path, steps: int, device) -> dict:
    from wavernn_tpu_torch.dsp import audio
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.utils.checkpoints import save_pytree

    cfg = WaveRNNConfig(
        rnn_dims=32, fc_dims=32, bits=9, pad=2, upsample_factors=(5, 5, 11),
        feat_dims=80, compute_dims=16, res_out_dims=16, res_blocks=2,
        hop_length=275, sample_rate=22050, mode="RAW",
    )
    y = harmonic_signal(cfg.sample_rate, 12.0)
    mel = audio.melspectrogram(y).astype(np.float32)
    labels = audio.encode_mu_law(y, 2 ** cfg.bits).astype(np.int64)
    state, loss, secs = train(cfg, mel, y, labels, steps=steps,
                              batch_size=16, seq_len=5 * cfg.hop_length,
                              lr=4e-4, clip=4.0, pad=cfg.pad,
                              hop=cfg.hop_length, device=device,
                              log_every=50)
    tree = state.weights_tree()
    save_pytree(tree, out / "tiny_wavernn_raw.msgpack")
    # the pin: the float32 scan decoder on the CPU
    gen = Generator(cfg, tree, "cpu", backend="scan", frame_bucket=16,
                    fold_bucket=4, deterministic=True)
    eval_mel = mel[:, :120]
    wav = gen(eval_mel, batched=True, target=2750, overlap=550, mu_law=True)
    np.save(out / "tiny_wavernn_raw_wav.npy", wav.astype(np.float32))
    np.save(out / "tiny_wavernn_raw_mel.npy", eval_mel)
    return {"which": "tiny", "final_loss": loss,
            metric("train_seconds", device): secs,
            "wav_len": int(len(wav)), "wav_std": float(np.std(wav))}


# --- the tiny Tacotron golden ----------------------------------------------

# The dims of the e2e_tts recipe (attention aligns on the note corpus with
# this capacity; smaller decoders collapsed).  num_chars is the whole
# symbol table, so the real text frontend drives training and decode.
TACO_DIMS = dict(
    embed_dims=128, num_chars=148, encoder_dims=64, decoder_dims=128,
    n_mels=80, fft_bins=80, postnet_dims=64, encoder_K=8, lstm_dims=256,
    postnet_K=4, num_highways=2,
)
TACO_EVAL_TEXT = "abcdeabcde"
NOTE_SECONDS = 0.125
TAIL_SECONDS = 0.25
CLEANERS = ["english_cleaners"]
STOP_PATIENCE = 6  # survive brief note-boundary energy dips in free run


def taco_corpus_texts() -> list:
    """~1100 random melodies: a corpus large against the decoder's
    capacity, so that it learns the notes rather than the sequences."""
    rng = np.random.default_rng(7)
    return ([TACO_EVAL_TEXT, "ebcadebcad", "dcbaedcbae"]
            + ["".join(rng.choice(list("abcde"), int(n)))
               for n in rng.integers(8, 13, 1100)])


def taco_tones(texts) -> dict:
    """symbol id -> tone frequency, spaced 28% apart."""
    from wavernn_tpu_torch.text import text_to_sequence

    used = sorted({sid for t in texts
                   for sid in text_to_sequence(t, CLEANERS)})
    return {sid: 261.6 * (1.28 ** k) for k, sid in enumerate(used)}


def taco_wav(seq, tones: dict, sr: int) -> np.ndarray:
    n = int(NOTE_SECONDS * sr)
    t = np.arange(n) / sr
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / 300.0)
    tail = np.zeros(int(TAIL_SECONDS * sr), np.float32)
    return np.concatenate(
        [0.5 * env * np.sin(2 * np.pi * tones[sid] * t) for sid in seq]
        + [tail]).astype(np.float32)


def _round_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def run_taco(out: Path, steps1: int, steps2: int, device, hp) -> dict:
    """Train the tiny Tacotron (r = 7, then r = 2), write it with its
    ground-truth eval mel and meta, then pin its decode."""
    import torch

    from wavernn_tpu_torch.dsp import audio
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, from_jax_variables, init_variables, to_jax_variables,
    )
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )
    from wavernn_tpu_torch.training.tacotron import make_tts_train_step
    from wavernn_tpu_torch.utils.checkpoints import save_pytree

    sr = hp.sample_rate
    texts = taco_corpus_texts()
    tones = taco_tones(texts)
    seqs = [text_to_sequence(t, CLEANERS) for t in texts]
    # every text padded to one L, every mel to one T that r = 7 and r = 2
    # both divide
    L = _round_to(max(len(s) for s in seqs), 16)
    mels = [audio.melspectrogram(taco_wav(seq, tones, sr)).astype(
        np.float32).T for seq in seqs]
    T_pad = _round_to(max(m.shape[0] for m in mels) + 1, 14)
    chars = np.zeros((len(seqs), L), np.int32)
    mel_b = np.zeros((len(seqs), T_pad, 80), np.float32)
    for i, (seq, m) in enumerate(zip(seqs, mels)):
        chars[i, :len(seq)] = seq
        mel_b[i, :m.shape[0]] = m
    mel_b = mel_b * 8.0 - 4.0  # dataset scaling; padding = -4 (silence)

    cfg = TacotronConfig(**TACO_DIMS)
    model = from_jax_variables(init_variables(cfg, 0), cfg, device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device)
    B = 8
    t0 = time.perf_counter()
    total = 0
    loss = float("nan")
    for r, lr, steps in [(7, 1e-3, steps1), (2, 3e-4, steps2)]:
        opt = make_optimizer(lr, 1.0)  # the reference clips at 1.0
        state = new_train_state(model, opt)
        tstep = make_tts_train_step(model, opt, r)
        for _ in range(steps):
            idx = rng.integers(0, len(seqs), B)
            gen.manual_seed(total)
            state, loss, _, attn, _ = tstep(state, chars[idx], mel_b[idx],
                                            gen)
            total += 1
            if total % 500 == 0:
                path = attn[0].argmax(dim=1).cpu().numpy()
                mono = float((np.diff(path) >= 0).mean())
                print(f"step {total} r={r} loss={float(loss):.4f} "
                      f"attn_monotone={mono:.2f}", file=sys.stderr)
    loss = float(loss)
    v = to_jax_variables(model)
    save_pytree({"params": v["params"], "batch_stats": v["batch_stats"],
                 "step": np.asarray(total)}, out / "tiny_tacotron.msgpack")
    gt_mel = audio.melspectrogram(
        taco_wav(text_to_sequence(TACO_EVAL_TEXT, CLEANERS), tones, sr))
    np.save(out / "tiny_tacotron_gt_mel.npy", gt_mel.astype(np.float32))
    meta = {"which": "taco", "dims": TACO_DIMS, "eval_text": TACO_EVAL_TEXT,
            "train_steps": total, "final_loss": loss,
            metric("train_seconds", device): time.perf_counter() - t0,
            "r": 2}
    (out / "tiny_tacotron_meta.json").write_text(json.dumps(meta, indent=1))
    return {**meta, "pin": run_taco_pin(out, out)}


def run_taco_pin(src: Path, out: Path) -> dict:
    """Pin the decode of ``src``'s tiny Tacotron: the plain float32 decoder
    on the CPU; its attention must be diagonal, cover the text and keep
    the tempo.  Writes the mel, the attention and the meta with the gates
    to ``out``."""
    from wavernn_tpu_torch.infer.gates import tts_gates
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import TacotronConfig
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.tools import load_variables

    meta = json.loads((src / "tiny_tacotron_meta.json").read_text())
    gen = TTSGenerator(TacotronConfig(**meta["dims"]),
                       load_variables(src / "tiny_tacotron.msgpack"), "cpu",
                       steps=400, backend="plain",
                       stop_patience=STOP_PATIENCE)
    seq = text_to_sequence(meta["eval_text"], CLEANERS)
    mel, _, attn = gen(seq, r=meta["r"])
    # the gates compare a tempo-normalised mel with the ground truth, saved
    # on the [0, 1] scale
    gt_mel = np.load(src / "tiny_tacotron_gt_mel.npy") * 8.0 - 4.0
    gates = tts_gates(mel, attn, len(seq), gt_mel)
    if not (gates["attn_monotone"] >= 0.9 and gates["attn_coverage"] >= 0.7
            and 0.6 < gates["tempo"] < 1.5 and gates["mel_gt_l1"] < 0.6):
        raise RuntimeError(f"the tiny Tacotron fails its gates: {gates}")
    np.save(out / "tiny_tacotron_mel.npy", mel.astype(np.float32))
    np.save(out / "tiny_tacotron_attn.npy", attn.astype(np.float32))
    meta["pinned_gates_cpu_xla"] = gates
    (out / "tiny_tacotron_meta.json").write_text(json.dumps(meta, indent=1))
    return {"which": "taco-pin", **gates}


def run_full(out: Path, steps: int, device, hp) -> dict:
    from wavernn_tpu_torch.dsp import audio
    from wavernn_tpu_torch.infer.eval import copy_synthesis_mcd
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.utils.checkpoints import save_pytree

    cfg = WaveRNNConfig.from_hp(hp)
    # a speech-shaped corpus, so that the MCD gate's sensitivity resembles
    # real vocoding error
    y = speech_signal(hp.sample_rate, 90.0)
    mel = audio.melspectrogram(y).astype(np.float32)
    state, loss, secs = train(cfg, mel, y, None, steps=steps, batch_size=32,
                              seq_len=hp.voc_seq_len, lr=hp.voc_lr, clip=4.0,
                              pad=hp.voc_pad, hop=hp.hop_length,
                              device=device)
    tree = state.weights_tree()
    save_pytree(tree, out / "wavernn_mol_golden.msgpack")
    eval_mel = mel[:, :1200]
    np.save(out / "golden_eval_mel.npy", eval_mel)

    meta = {"which": "full", "mode": "MOL", "corpus": "speech_formant",
            "train_steps": steps, "final_loss": loss,
            metric("train_seconds", device): secs,
            "eval_frames": int(eval_mel.shape[1])}
    # the kernel at full width only on the card (on the CPU its plain
    # version would take 12,100 steps per fold row)
    backends = ("scan", "kernel") if device.type == "cuda" else ("scan",)
    for backend in backends:
        gen = Generator(cfg, tree, device, backend=backend, fold_bucket=16)
        # scan is the gate's baseline: 6 seeds, so that its spread (the
        # corridor's unit) is measured
        n_seeds = 6 if backend == "scan" else 3
        scores = [copy_synthesis_mcd(
            gen, eval_mel, batched=True, target=hp.voc_target,
            overlap=hp.voc_overlap, mu_law=hp.mu_law, seed=s)[0]
            for s in range(n_seeds)]
        meta[f"mcd_{backend}_mean"] = float(np.mean(scores))
        meta[f"mcd_{backend}_max"] = float(np.max(scores))
        if backend == "scan":
            meta["mcd_scan_spread"] = float(np.max(scores) - np.mean(scores))
    (out / "golden_meta.json").write_text(json.dumps(meta, indent=1))
    return meta


def check_out(out) -> Path:
    """``out`` as an absolute path; raises if it lies inside a directory
    of the repository's pins."""
    out = Path(out).resolve()
    for pinned in PINNED_DIRS:
        if out == pinned.resolve() or out.is_relative_to(pinned.resolve()):
            raise ValueError(f"--out {out} lies inside {pinned}, which holds "
                             "the JAX package's pins: choose another "
                             "directory")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", choices=["tiny", "full", "taco", "taco-pin"],
                    required=True)
    ap.add_argument("--out", required=True,
                    help="directory the files are written to")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (tiny: 300, full: 3000)")
    ap.add_argument("--taco_steps1", type=int, default=2000,
                    help="r=7 session steps for --which taco")
    ap.add_argument("--taco_steps2", type=int, default=4000,
                    help="r=2 session steps for --which taco")
    ap.add_argument("--hp_file", default=None,
                    help="the hp file (default: hparams.py)")
    ap.add_argument("--from", dest="src", default=None,
                    help="--which taco-pin: the directory holding the "
                         "trained tiny Tacotron (default: --out)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    out = check_out(args.out)
    out.mkdir(parents=True, exist_ok=True)

    with hparams(args.hp_file, voc_mode="MOL") as hp:
        if args.which == "tiny":
            rec = run_tiny(out, args.steps or 300, dev)
        elif args.which == "taco":
            rec = run_taco(out, args.taco_steps1, args.taco_steps2, dev, hp)
        elif args.which == "taco-pin":
            rec = run_taco_pin(Path(args.src or out), out)
        else:
            rec = run_full(out, args.steps or 3000, dev, hp)
    rec = {"device": card(dev), "out": str(out), **rec}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
