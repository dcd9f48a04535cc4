"""Artifact-tree management (a copy of ``wavernn_tpu/paths.py``: the port
writes and reads the same file names, so a checkpoint moves between the
packages as it is).

Capability parity with the reference's path registry (ref:
utils/paths.py:5-62): one object computes and creates the directory tree
connecting the pipeline stages — preprocessed features, per-model-id
checkpoints, outputs, logs and plots.

The tree is built compositionally: each model (vocoder, TTS) gets a
:class:`ModelArtifacts` bundle derived from its id and kind, and the
reference's flat ``voc_*`` / ``tts_*`` attribute names are preserved as a
dynamic prefix view over those bundles (they are the public surface every
CLI and the checkpoint layer consume).  Checkpoint files use ``.msgpack``
(flax serialization) instead of torch pickles; the latest/named pairing
contract is unchanged.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, Tuple, Union

_CKPT_EXT = "msgpack"


class ModelArtifacts:
    """Checkpoint + output locations for one model id.

    ``extra_dirs`` adds named subdirectories under the checkpoint dir
    (e.g. the TTS attention/mel-plot dumps).
    """

    def __init__(self, base: Path, model_id: str, kind: str,
                 extra_dirs: Tuple[str, ...] = ()):
        self.checkpoints = base / "checkpoints" / f"{model_id}.{kind}"
        self.output = base / "model_outputs" / f"{model_id}.{kind}"
        self.latest_weights = self._pair("latest")[0]
        self.latest_optim = self._pair("latest")[1]
        self.step = self.checkpoints / "step.npy"
        self.log = self.checkpoints / "log.txt"
        self._extra_dirs = extra_dirs
        for d in extra_dirs:
            setattr(self, d, self.checkpoints / d)

    def _pair(self, name: str) -> Tuple[Path, Path]:
        """The (weights, optimizer) file pair of a named checkpoint."""
        return (self.checkpoints / f"{name}_weights.{_CKPT_EXT}",
                self.checkpoints / f"{name}_optim.{_CKPT_EXT}")

    def named_weights(self, name: str) -> Path:
        return self._pair(name)[0]

    def named_optim(self, name: str) -> Path:
        return self._pair(name)[1]

    def dirs(self) -> Iterator[Path]:
        yield self.checkpoints
        yield self.output
        for d in self._extra_dirs:
            yield getattr(self, d)


class Paths:
    """The full artifact tree for one (data, vocoder-id, tts-id) triple.

    Flat accessors (``voc_latest_weights``, ``tts_attention``, ...) resolve
    through the per-model bundles, keeping the reference's public names.
    """

    def __init__(self, data_path: Union[str, Path], voc_id: str, tts_id: str,
                 base: Union[str, Path, None] = None):
        self.base = Path(base if base is not None else os.getcwd())
        self.base = self.base.expanduser().resolve()

        self.data = Path(data_path).expanduser().resolve()
        self.quant = self.data / "quant"
        self.mel = self.data / "mel"
        self.gta = self.data / "gta"

        self.voc = ModelArtifacts(self.base, voc_id, "wavernn")
        self.tts = ModelArtifacts(self.base, tts_id, "tacotron",
                                  extra_dirs=("attention", "mel_plots"))
        self.create_paths()

    def __getattr__(self, name: str):
        # flat compat names: voc_<attr> / tts_<attr>; 'mel_plots' is
        # historically exposed as 'tts_mel_plot' (singular)
        prefix, _, attr = name.partition("_")
        if prefix in ("voc", "tts") and attr:
            bundle = object.__getattribute__(self, prefix)
            if attr == "mel_plot":
                attr = "mel_plots"
            try:
                return getattr(bundle, attr)
            except AttributeError:
                pass
        raise AttributeError(name)

    def create_paths(self) -> None:
        for p in (self.data, self.quant, self.mel, self.gta,
                  *self.voc.dirs(), *self.tts.dirs()):
            os.makedirs(p, exist_ok=True)

    # named-checkpoint accessors (same contract as the reference's
    # get_{tts,voc}_named_{weights,optim})
    def get_tts_named_weights(self, name: str) -> Path:
        return self.tts.named_weights(name)

    def get_tts_named_optim(self, name: str) -> Path:
        return self.tts.named_optim(name)

    def get_voc_named_weights(self, name: str) -> Path:
        return self.voc.named_weights(name)

    def get_voc_named_optim(self, name: str) -> Path:
        return self.voc.named_optim(name)
