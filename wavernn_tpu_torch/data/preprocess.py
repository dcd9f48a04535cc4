"""Dataset preprocessing: wav → (mel.npy, quant.npy) + manifests (ports
``wavernn_tpu/data/preprocess.py`` over the port's ``dsp/audio.py``; ref:
preprocess.py).

Multiprocess fan-out over wav files; each worker computes the normalized mel
spectrogram and the quantized signal (mu-law or bit labels per voc_mode).
Writes ``dataset.pkl`` [(id, mel_len)].  The workers are spawned, not
forked (the parent may hold torch's threads), so each one receives the
parent's hyperparameters when it starts.  With more than one worker the
manifest lists utterances in the order they finish, as in the JAX package.
"""

from __future__ import annotations

import multiprocessing
import pickle
import types
from functools import partial
from pathlib import Path
from typing import List, Tuple

import numpy as np

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import audio
from wavernn_tpu_torch.paths import Paths


def convert_file(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """wav file → (mel float32 (n_mels, T), quant int64 labels)."""
    y = audio.load_wav(path)
    peak = np.abs(y).max()
    if hp.peak_norm or peak > 1.0:
        y /= peak
    mel = audio.melspectrogram(y)
    if hp.voc_mode == "RAW":
        if hp.mu_law:
            quant = audio.encode_mu_law(y, mu=2 ** hp.bits)
        else:
            quant = audio.float_2_label(y, bits=hp.bits)
    elif hp.voc_mode == "MOL":
        quant = audio.float_2_label(y, bits=16)
    else:
        raise ValueError(f"Unknown voc_mode {hp.voc_mode}")
    return mel.astype(np.float32), quant.astype(np.int64)


def _process_wav(paths_tuple, path: Path):
    mel_dir, quant_dir = paths_tuple
    wav_id = path.stem
    m, x = convert_file(path)
    np.save(Path(mel_dir) / f"{wav_id}.npy", m, allow_pickle=False)
    np.save(Path(quant_dir) / f"{wav_id}.npy", x, allow_pickle=False)
    return wav_id, m.shape[-1]


def _configure_worker(values: dict) -> None:
    hp.configure_from_dict(values)


def _hp_values() -> dict:
    """The hyperparameters a worker needs: the values, without the modules
    and functions an hp file may define (they do not pickle)."""
    return {k: v for k, v in hp.snapshot().items()
            if not isinstance(v, types.ModuleType) and not callable(v)}


def preprocess_dataset(
    wav_files: List[Path],
    paths: Paths,
    n_workers: int = None,
    progress=None,
) -> List[Tuple[str, int]]:
    """Run the preprocessing pool over wav_files; returns the dataset manifest."""
    if n_workers is None:
        n_workers = max(1, multiprocessing.cpu_count() - 1)
    n_workers = max(1, n_workers)

    func = partial(_process_wav, (str(paths.mel), str(paths.quant)))
    dataset: List[Tuple[str, int]] = []

    if n_workers == 1:
        for i, wav in enumerate(wav_files, 1):
            dataset.append(func(wav))
            if progress:
                progress(i, len(wav_files))
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(processes=n_workers, initializer=_configure_worker,
                      initargs=(_hp_values(),)) as pool:
            for i, res in enumerate(pool.imap_unordered(func, wav_files), 1):
                dataset.append(res)
                if progress:
                    progress(i, len(wav_files))

    with open(paths.data / "dataset.pkl", "wb") as f:
        pickle.dump(dataset, f)
    return dataset
