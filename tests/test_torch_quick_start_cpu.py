"""``python -m wavernn_tpu_torch.quick_start`` end to end on the CPU, in
the directory of ``tests/test_torch_quick_start.py`` (the tiny goldens
zipped under the reference's archive names, an hp file with their dims).

With ``-c`` on a machine without CUDA the port decodes text -> mel, then
vocodes it through the decode kernel's plain version (unbatched, a
one-letter text: 16 frames), with one Generator built: its WAV must hold
(frames - 1) * hop samples of the mel it vocoded.  Without ``-c`` or
``--device`` the command fails without CUDA."""

from pathlib import Path

import numpy as np
import pytest
import torch

from wavernn_tpu_torch import quick_start
from wavernn_tpu_torch.dsp import wavio
from tests.test_torch_quick_start import workdir  # noqa: F401
from tests.torch_cpu import one_torch_thread  # noqa: F401


def test_quick_start_end_to_end_on_cpu(workdir, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mels, built = [], []
    real_mel, real_gen = quick_start.mel_from_linear, quick_start.make_generator
    monkeypatch.setattr(quick_start, "mel_from_linear",
                        lambda m: mels.append(real_mel(m)) or mels[-1])
    monkeypatch.setattr(quick_start, "make_generator",
                        lambda *a, **kw: built.append(1) or real_gen(*a, **kw))
    (path,) = quick_start.main(["-i", "a", "-u", "-c", "--hp_file",
                                "hp_tiny.py"])
    assert "Using device: cpu" in capsys.readouterr().out
    assert path == Path("quick_start/__input_a_6k.wav")
    x, sr = wavio.read_wav_raw(path)
    assert len(mels) == len(built) == 1
    assert sr == 22050 and x.shape == ((mels[0].shape[1] - 1) * 275,)
    assert np.std(x.astype(np.float64)) > 0


def test_quick_start_fails_without_cuda(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quick_start.main(["-i", "a", "--hp_file", "hp_tiny.py"])
