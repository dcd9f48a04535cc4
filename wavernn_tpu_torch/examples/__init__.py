"""Examples of the PyTorch port (ports of ``examples/`` of the JAX
package).  Each runs as ``python -m wavernn_tpu_torch.examples.<name>``, on
the card by default: ``--device cuda`` raises where CUDA is absent, and
``--device cpu`` runs on the CPU.

  * ``nb1_sine_wave``: the DeepMind dual-softmax WaveRNN overfits a sine
    wave, then generates it (the reference's NB1 notebook).
"""
