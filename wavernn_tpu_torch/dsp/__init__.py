"""DSP of the port: on the host (numpy, as in the JAX package)
:mod:`~wavernn_tpu_torch.dsp.audio` (STFT, Slaney mel, mu-law and label
codecs, the hp-bound feature API), :mod:`~wavernn_tpu_torch.dsp.metrics`
(MCD) and :mod:`~wavernn_tpu_torch.dsp.wavio` (WAV I/O); on the device
:mod:`~wavernn_tpu_torch.dsp.torch_audio` (STFT, mel, the Griffin-Lim
vocoder ``reconstruct_waveform``)."""

from wavernn_tpu_torch.dsp.audio import (  # noqa: F401
    amp_to_db,
    db_to_amp,
    combine_signal,
    decode_mu_law,
    de_emphasis,
    denormalize,
    encode_16bits,
    encode_mu_law,
    float_2_label,
    label_2_float,
    linear_to_mel,
    load_wav,
    melspectrogram,
    mel_filterbank,
    normalize,
    pre_emphasis,
    save_wav,
    spectrogram,
    split_signal,
    stft,
)
from wavernn_tpu_torch.dsp.torch_audio import reconstruct_waveform  # noqa: F401,E402
