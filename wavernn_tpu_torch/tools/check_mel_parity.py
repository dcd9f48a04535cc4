"""Mel-feature parity: the MCD between the port's two mel pipelines (ports
``tools/check_mel_parity.py``; the gate: MCD < 0.1 dB).

    python -m wavernn_tpu_torch.tools.check_mel_parity [wav ...]
        [--device cuda|cpu]

The host pipeline, ``dsp/audio.py::melspectrogram`` (numpy), against the
device pipeline, ``dsp/torch_audio.py::melspectrogram_hp`` (cuFFT on the
card; ``--device cpu`` runs it on the CPU), on the given wavs or on three
synthetic signals (a 440 Hz tone, a chirp, uniform noise; 2 s each),
with the audio parameters of ``hparams.py``.
Where librosa imports, each signal's mel by the reference's own librosa
calls is held against the host pipeline too (printed, not gated).  Prints
a line per signal, then one JSON line; exits non-zero when the worst
numpy-vs-torch MCD reaches 0.1 dB.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from wavernn_tpu_torch.tools import card, device_of, hparams

GATE_DB = 0.1


def synth_signals() -> dict:
    rng = np.random.default_rng(0)
    sr = 22050
    t = np.arange(sr * 2) / sr
    return {
        "tone440": (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
        "chirp": (0.5 * np.sin(2 * np.pi * (200 + 1500 * t / t[-1]) * t)
                  ).astype(np.float32),
        "noise": rng.uniform(-0.5, 0.5, sr * 2).astype(np.float32),
    }


def librosa_mel(y: np.ndarray, hp):
    """The reference's mel by librosa's calls, or None without librosa."""
    try:
        import librosa
    except ImportError:
        return None
    from wavernn_tpu_torch.dsp import audio

    D = librosa.stft(y=y, n_fft=hp.n_fft, hop_length=hp.hop_length,
                     win_length=hp.win_length)
    S = librosa.feature.melspectrogram(
        S=np.abs(D), sr=hp.sample_rate, n_fft=hp.n_fft, n_mels=hp.num_mels,
        fmin=hp.fmin)
    return audio.normalize(audio.amp_to_db(S))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wavs", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.dsp import audio, torch_audio
    from wavernn_tpu_torch.dsp.metrics import mcd

    tag = card(dev)
    rec = {"device": tag, "signals": {}}
    with hparams() as hp:
        signals = ({Path(a).stem: audio.load_wav(a) for a in args.wavs}
                   or synth_signals())
        worst = {"torch": 0.0}
        for name, y in signals.items():
            m_np = audio.melspectrogram(y)
            m_dev = torch_audio.melspectrogram_hp(y, dev).cpu().numpy()
            d = float(mcd(m_np, m_dev))
            rec["signals"][name] = {"numpy_vs_torch_mcd": d}
            worst["torch"] = max(worst["torch"], d)
            line = f"[{tag}] {name:10s} numpy-vs-torch MCD = {d:.4f} dB"
            m_lib = librosa_mel(y, hp)
            if m_lib is not None:
                d2 = float(mcd(m_np, m_lib))
                rec["signals"][name]["numpy_vs_librosa_mcd"] = d2
                worst["librosa"] = max(worst.get("librosa", 0.0), d2)
                line += f" | numpy-vs-librosa MCD = {d2:.4f} dB"
            print(line, flush=True)
    rec["worst_numpy_vs_torch_mcd"] = worst["torch"]
    if "librosa" in worst:
        rec["worst_numpy_vs_librosa_mcd"] = worst["librosa"]
    else:
        print("librosa does not import here: the numpy pipeline reimplements "
              "its conventions (centered reflect STFT, periodic Hann, Slaney "
              "mel and norm), pinned by tests/test_torch_dsp.py")
    rec["gate_db"] = GATE_DB
    rec["ok"] = worst["torch"] < GATE_DB
    print(json.dumps(rec))
    if not rec["ok"]:
        raise SystemExit(f"the numpy and torch mel pipelines diverge: worst "
                         f"MCD {worst['torch']:.4f} dB >= {GATE_DB}")
    return rec


if __name__ == "__main__":
    main()
