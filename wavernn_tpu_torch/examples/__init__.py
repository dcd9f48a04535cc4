"""Examples of the PyTorch port (ports of ``examples/`` of the JAX
package).  Each runs as ``python -m wavernn_tpu_torch.examples.<name>``, on
the card by default: ``--device cuda`` raises where CUDA is absent, and
``--device cpu`` runs on the CPU.

  * ``nb1_sine_wave``: the DeepMind dual-softmax WaveRNN overfits a sine
    wave, then generates it (the reference's NB1 notebook);
  * ``nb2_fit_single_sample``: the production WaveRNN overfits one
    utterance through a hand-rolled window sampler, then re-synthesizes
    it through the decode kernel (NB2);
  * ``nb3_fit_long_sample``: a synthetic long corpus through preprocess,
    the loader and ``voc_train_loop``, its audition through the decode
    kernel (NB3);
  * ``nb4_alternative_model``: the MOL WaveRNN from 16-bit preprocessing to
    batched fold generation through the decode kernel (NB4a/b);
  * ``pruning_example``: training with the cubic magnitude-pruning ramp;
  * ``serving_demo``: the serving modes (batch, two-stage streaming, raw
    handles, the multi-session ``StreamServer``, the HTTP daemon) on tiny
    models, through both kernels;
  * ``e2e_tts``: a note-language corpus through the four CLIs (Tacotron
    and vocoder training, then text -> wav through both kernels) and the
    attention and spectrum gates.
"""
