"""Vocoder + TTS datasets, collation, and length-binned sampling
(ref: utils/dataset.py).

Conventions kept from the reference:
  * deterministic 50-utterance test split via seed 1234 shuffle,
  * vocoder training crops: random mel-aligned windows of
    ``voc_seq_len`` samples + pad context, x = labels[:-1], y = labels[1:],
  * TTS batches: padded char sequences + mels padded to an r-multiple,
    rescaled to [-4, 4]; length-binned shuffling to minimize padding.

A copy of ``wavernn_tpu/data/dataset.py`` (numpy only): channel-last mel
layout (B, T, C) and numpy outputs, batch for batch those of the JAX
package under the same seeds.
"""

from __future__ import annotations

import pickle
import random
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.data.loader import DataLoader, Dataset, Sampler
from wavernn_tpu_torch.dsp.audio import label_2_float
from wavernn_tpu_torch.text import text_to_sequence


###############################################################################
# Vocoder dataset
###############################################################################


class VocoderDataset(Dataset):
    def __init__(self, path: Path, dataset_ids: Sequence[str], train_gta: bool = False):
        self.metadata = list(dataset_ids)
        self.mel_path = path / "gta" if train_gta else path / "mel"
        self.quant_path = path / "quant"

    def __getitem__(self, index: int):
        item_id = self.metadata[index]
        m = np.load(self.mel_path / f"{item_id}.npy")
        x = np.load(self.quant_path / f"{item_id}.npy")
        return m, x

    def __len__(self) -> int:
        return len(self.metadata)


def _split_ids(path: Path) -> Tuple[List[str], List[str]]:
    with open(path / "dataset.pkl", "rb") as f:
        dataset = pickle.load(f)
    dataset_ids = [x[0] for x in dataset]
    random.Random(1234).shuffle(dataset_ids)
    test_ids = dataset_ids[-hp.voc_test_samples:]
    train_ids = dataset_ids[: -hp.voc_test_samples]
    return train_ids, test_ids


def get_vocoder_datasets(path: Path, batch_size: int, train_gta: bool):
    """Returns (train_loader, test_loader).  Test loader yields single
    utterances (mel, quant) for audition generation."""
    train_ids, test_ids = _split_ids(path)

    train_dataset = VocoderDataset(path, train_ids, train_gta)
    test_dataset = VocoderDataset(path, test_ids, train_gta)

    train_set = DataLoader(
        train_dataset,
        collate_fn=collate_vocoder,
        batch_size=batch_size,
        num_workers=2,
        shuffle=True,
        drop_last=True,
    )
    test_set = DataLoader(
        test_dataset, batch_size=1, num_workers=1, shuffle=False,
        collate_fn=lambda items: items[0],
    )
    return train_set, test_set


def collate_vocoder(batch):
    """Random-window crop + teacher-forcing shift (ref: utils/dataset.py:67-93).

    Returns (x (B,T) float32, y (B,T) float|int, mels (B, mel_win, n_mels)).
    """
    mel_win = hp.voc_seq_len // hp.hop_length + 2 * hp.voc_pad
    max_offsets = [x[0].shape[-1] - 2 - (mel_win + 2 * hp.voc_pad) for x in batch]
    mel_offsets = [np.random.randint(0, offset) for offset in max_offsets]
    sig_offsets = [(offset + hp.voc_pad) * hp.hop_length for offset in mel_offsets]

    mels = [
        x[0][:, mel_offsets[i]: mel_offsets[i] + mel_win]
        for i, x in enumerate(batch)
    ]
    labels = [
        x[1][sig_offsets[i]: sig_offsets[i] + hp.voc_seq_len + 1]
        for i, x in enumerate(batch)
    ]

    mels = np.stack(mels).astype(np.float32)
    labels = np.stack(labels).astype(np.int64)

    x = labels[:, : hp.voc_seq_len]
    y = labels[:, 1:]

    bits = 16 if hp.voc_mode == "MOL" else hp.bits
    x = label_2_float(x.astype(np.float32), bits)
    if hp.voc_mode == "MOL":
        y = label_2_float(y.astype(np.float32), bits)

    mels = np.transpose(mels, (0, 2, 1))  # channel-last
    return x.astype(np.float32), y, mels


###############################################################################
# TTS dataset
###############################################################################


class TTSDataset(Dataset):
    def __init__(self, path: Path, dataset_ids: Sequence[str], text_dict):
        self.path = path
        self.metadata = list(dataset_ids)
        self.text_dict = text_dict

    def __getitem__(self, index: int):
        item_id = self.metadata[index]
        x = text_to_sequence(self.text_dict[item_id], hp.tts_cleaner_names)
        mel = np.load(self.path / "mel" / f"{item_id}.npy")
        mel_len = mel.shape[-1]
        return x, mel, item_id, mel_len

    def __len__(self) -> int:
        return len(self.metadata)


def get_tts_datasets(path: Path, batch_size: int, r: int,
                     drop_last: bool = True):
    """Returns (train_loader, attn_example_id).

    ``drop_last=True`` keeps the training batch size fixed; the GTA export
    pass uses ``drop_last=False`` so that every utterance is covered."""
    with open(path / "dataset.pkl", "rb") as f:
        dataset = pickle.load(f)

    dataset_ids, mel_lengths = [], []
    for item_id, length in dataset:
        if length <= hp.tts_max_mel_len:
            dataset_ids.append(item_id)
            mel_lengths.append(length)

    with open(path / "text_dict.pkl", "rb") as f:
        text_dict = pickle.load(f)

    train_dataset = TTSDataset(path, dataset_ids, text_dict)

    sampler = None
    if hp.tts_bin_lengths:
        sampler = BinnedLengthSampler(mel_lengths, batch_size, batch_size * 3)

    train_set = DataLoader(
        train_dataset,
        collate_fn=lambda batch: collate_tts(batch, r),
        batch_size=batch_size,
        sampler=sampler,
        shuffle=sampler is None,
        num_workers=1,
        drop_last=drop_last,
    )

    longest = mel_lengths.index(max(mel_lengths))
    attn_example = dataset_ids[longest]  # attention-plot utterance
    return train_set, attn_example


def pad1d(x, max_len):
    return np.pad(x, (0, max_len - len(x)), mode="constant")


def pad2d(x, max_len):
    return np.pad(x, ((0, 0), (0, max_len - x.shape[-1])), mode="constant")


def collate_tts(batch, r: int):
    """Pad chars to max length and mels to an r-multiple; rescale mels to
    [-4, 4] (ref: utils/dataset.py:166-190).

    Returns (chars (B,L) int32, mel (B, T, n_mels) f32, ids, mel_lens).
    """
    # Optional shape bucketing: padding text/mel up to coarse multiples
    # collapses the per-batch (L_max, T_max) shape variety into a handful
    # of shapes.  Defaults of 1 reproduce the reference's exact batch-max
    # padding (ref: utils/dataset.py:166-190).
    import math

    text_mult = int(hp.get("tts_pad_text_multiple", 1))
    mel_mult = int(hp.get("tts_pad_mel_multiple", 1))

    x_lens = [len(x[0]) for x in batch]
    max_x_len = -(-max(x_lens) // text_mult) * text_mult
    chars = np.stack([pad1d(x[0], max_x_len) for x in batch]).astype(np.int32)

    spec_lens = [x[1].shape[-1] for x in batch]
    max_spec_len = max(spec_lens) + 1
    step = math.lcm(r, mel_mult)
    if max_spec_len % step != 0:
        max_spec_len += step - max_spec_len % step

    mel = np.stack([pad2d(x[1], max_spec_len) for x in batch]).astype(np.float32)
    mel = (mel * 8.0) - 4.0  # scale [0,1] → [-4,4]
    mel = np.transpose(mel, (0, 2, 1))  # channel-last

    ids = [x[2] for x in batch]
    mel_lens = [x[3] for x in batch]
    return chars, mel, ids, mel_lens


class BinnedLengthSampler(Sampler):
    """Sort by length, shuffle within bins of bin_size, shuffle bins
    (ref: utils/dataset.py:193-222)."""

    def __init__(self, lengths: Sequence[int], batch_size: int, bin_size: int,
                 seed: int = 1234):
        self.idx = np.argsort(np.asarray(lengths))
        self.batch_size = batch_size
        self.bin_size = bin_size
        self._rng = random.Random(seed)
        assert self.bin_size % self.batch_size == 0

    def __iter__(self):
        idx = self.idx.copy()
        bins = []
        for i in range(len(idx) // self.bin_size):
            this_bin = list(idx[i * self.bin_size: (i + 1) * self.bin_size])
            self._rng.shuffle(this_bin)
            bins.append(this_bin)
        self._rng.shuffle(bins)
        binned_idx = [i for b in bins for i in b]
        if len(binned_idx) < len(idx):
            last_bin = list(idx[len(binned_idx):])
            self._rng.shuffle(last_bin)
            binned_idx.extend(last_bin)
        return iter(int(i) for i in binned_idx)

    def __len__(self):
        return len(self.idx)
