"""Text -> speech serving: the Tacotron generator and the WaveRNN
vocoder in one call (ports ``wavernn_tpu/infer/pipeline.py``)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from wavernn_tpu_torch.infer.tacotron import TTSGenerator
from wavernn_tpu_torch.models.tacotron import TacotronConfig
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.text import text_to_sequence


def mel_from_linear(m_linear) -> np.ndarray:
    """Tacotron output on its [-4, 4] training scale -> the vocoder's
    normalised [0, 1] mel."""
    return np.clip((np.asarray(m_linear) + 4) / 8, 0, 1)


class TTSPipeline:
    """End-to-end synthesis on one ``device``: text strings -> waveforms.

    ``backend`` is the vocoder's (``kernel`` or ``scan``), ``tts_backend``
    the Tacotron decoder's (``auto``, ``kernel`` or ``plain``).
    ``output_dtype='int16'`` serves 16-bit PCM faded on the device;
    ``input_dtype='float16'`` uploads the mels at half the bytes.
    ``mesh`` (a local ``parallel.mesh.MeshPlan`` whose first device is
    ``device``) shards the vocoder's fold rows over its devices, as
    ``gen_wavernn --mesh`` does; the Tacotron decode stays on ``device``.
    ``int8_gates`` is the vocoder's (``Generator``'s), off by default."""

    def __init__(self, tts_cfg: TacotronConfig, tts_variables,
                 voc_cfg: WaveRNNConfig, voc_variables,
                 cleaner_names: Sequence[str], r: int, device,
                 backend: str = "kernel", tts_steps: int = 2000,
                 tts_backend: str = "auto", int8_gates: bool = False,
                 deterministic: bool = False, mesh=None,
                 output_dtype: str = "float64",
                 input_dtype: str = "float16"):
        self.r = r
        self.cleaners = list(cleaner_names)
        self.tts = TTSGenerator(tts_cfg, tts_variables, device,
                                steps=tts_steps, backend=tts_backend)
        self.voc = Generator(voc_cfg, voc_variables, device=device,
                             backend=backend, fold_bucket=16,
                             int8_gates=int8_gates,
                             deterministic=deterministic, mesh=mesh,
                             output_dtype=output_dtype,
                             input_dtype=input_dtype)

    def __call__(self, texts: Sequence[str], target: int = 11_000,
                 overlap: int = 550, mu_law: bool = True,
                 seed: int = 0) -> List[np.ndarray]:
        """Synthesize every text: one batched text->mel decode (plain
        decoder), then the vocoder per utterance."""
        seqs = [text_to_sequence(t.strip(), self.cleaners) for t in texts]
        mels = [mel_from_linear(m_linear)
                for _, m_linear, _ in self.tts.batch(seqs, r=self.r)]
        return self.voc.generate_batch(mels, target=target, overlap=overlap,
                                       mu_law=mu_law, seed=seed)

    def stream_synthesize(self, texts: Sequence[str], target: int = 11_000,
                          overlap: int = 550, mu_law: bool = True,
                          seed: int = 0, lookahead: int = 1):
        """Yield each text's waveform in order as soon as it is ready.
        ``lookahead`` text->mel decodes are submitted ahead of the
        vocoder; utterance i uses vocoder seed ``seed + i``.  The text->mel
        decode reads its stop values on the host, so a submit returns when
        its mel is done; the vocoder's submit queues on the device and its
        result is copied back while the next utterance decodes."""
        seqs = [text_to_sequence(t.strip(), self.cleaners) for t in texts]
        n = len(seqs)
        tts_h = {i: self.tts.submit(seqs[i], r=self.r)
                 for i in range(min(lookahead + 1, n))}
        voc_prev = None
        for i in range(n):
            _, m_linear, _ = self.tts.collect(tts_h.pop(i))
            vh = self.voc.submit(mel_from_linear(m_linear), True, target,
                                 overlap, mu_law, seed + i)
            self.voc.prefetch(vh)
            nxt = i + lookahead + 1
            if nxt < n:
                tts_h[nxt] = self.tts.submit(seqs[nxt], r=self.r)
            if voc_prev is not None:
                yield self.voc.collect(voc_prev)
            voc_prev = vh
        if voc_prev is not None:
            yield self.voc.collect(voc_prev)
