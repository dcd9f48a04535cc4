"""The Tacotron decoder-step kernel against the plain decoder through the
whole ``TTSGenerator`` (ports ``tools/tts_kernel_parity.py``).

    python -m wavernn_tpu_torch.tools.tts_kernel_parity [--train N] [--int8]
        [--steps 400] [--passes 3] [--device cuda|cpu]

``TacotronConfig()`` with seeded weights (``init_variables(cfg, 0)``),
r = 2, a 60-symbol text from ``np.random.default_rng(3)`` (drawn after the
two draws of the JAX tool's init inputs, so that the text is the JAX
tool's).  The model is untrained, so the stop never fires and a decode
runs ``--steps`` frames.  ``--train N`` first overfits a synthetic text ->
mel pair (B 4, L 40, T 120, r 2, from ``np.random.default_rng(11)``; Adam
1e-3, clip 1.0, masks from a generator seeded 5) through
``training/tacotron.py::make_tts_train_step``, so that the decoders are
compared at trained weight and activation ranges.

Each decoder, ``backend="plain"`` and ``backend="kernel"`` (and the kernel
with ``int8_lstm=True`` under ``--int8``), decodes the text once to warm,
then ``--passes`` times; frames/s is the frames over the best pass's wall
time.  The mel, linear and attention deltas are over the common prefix
(a trained model stops at its own threshold crossing).  ``--device cpu``
runs the kernel's plain version in place of the kernel, with every rate
labelled a CPU host rate.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import card, device_of, metric

R = 2


def train_pair(cfg, variables, n_steps: int, device):
    """Overfit the synthetic pair for ``n_steps`` steps: (the trained
    flax-layout variables, the last loss)."""
    import torch

    from wavernn_tpu_torch.models.tacotron import (
        from_jax_variables, to_jax_variables,
    )
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )
    from wavernn_tpu_torch.training.tacotron import make_tts_train_step

    rng = np.random.default_rng(11)
    B, L, T, r = 4, 40, 120, 2
    x = rng.integers(1, cfg.num_chars, (B, L)).astype(np.int32)
    # smooth synthetic mels: a spectral bump per utterance whose mel bin
    # tracks the text position (something for the attention to align to)
    t = np.arange(T)[None, :, None] / T
    m_bins = np.arange(cfg.n_mels)[None, None, :]
    center = (10 + 60 * t) + 5 * rng.standard_normal((B, 1, 1))
    m = 8 * np.exp(-0.5 * ((m_bins - center) / 6.0) ** 2) - 4
    m = m.astype(np.float32)

    model = from_jax_variables(variables, cfg, device)
    optimizer = make_optimizer(1e-3, 1.0)
    state = new_train_state(model, optimizer)
    step = make_tts_train_step(model, optimizer, r)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    loss = float("nan")
    for _ in range(n_steps):
        state, loss, _, _, _ = step(state, x, m, gen)
    return to_jax_variables(model), float(loss)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", type=int, default=0,
                    help="overfit steps before the comparison")
    ap.add_argument("--int8", action="store_true",
                    help="also decode with the kernel's int8_lstm variant")
    ap.add_argument("--steps", type=int, default=400,
                    help="frames a decode runs (the stop never fires "
                         "untrained)")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, init_variables,
    )
    from wavernn_tpu_torch.ops import cuda_tts

    cfg = TacotronConfig()
    rng = np.random.default_rng(3)
    rng.integers(1, cfg.num_chars, (1, 32))         # the JAX tool's init
    rng.uniform(-4, 4, (1, 8, cfg.n_mels))          # inputs
    variables = init_variables(cfg, 0)
    final_loss = None
    if args.train:
        variables, final_loss = train_pair(cfg, variables, args.train, dev)
    seq = [int(i) for i in rng.integers(1, cfg.num_chars, 60)]

    variants = [("plain", dict(backend="plain")),
                ("kernel", dict(backend="kernel"))]
    if args.int8:
        variants.append(("kernel_int8", dict(backend="kernel",
                                             int8_lstm=True)))
    out, rates, launches = {}, {}, {}
    for name, kw in variants:
        gen = TTSGenerator(cfg, variables, dev, steps=args.steps, **kw)
        n = cuda_tts.tts_decode.launches
        out[name] = gen(seq, r=R)                      # warm
        launches[name] = cuda_tts.tts_decode.launches - n
        best = float("inf")
        for _ in range(args.passes):
            t0 = time.perf_counter()
            out[name] = gen(seq, r=R)
            best = min(best, time.perf_counter() - t0)
        rates[name] = out[name][0].shape[1] / best

    mel_x, lin_x, attn_x = out["plain"]
    mel_p, lin_p, attn_p = out["kernel"]
    frames_plain, frames_kernel = int(mel_x.shape[1]), int(mel_p.shape[1])
    n = min(frames_plain, frames_kernel)
    na = min(attn_x.shape[0], attn_p.shape[0])
    rec = {
        "device": card(dev),
        "frames": n,
        "frames_plain": frames_plain,
        "frames_kernel": frames_kernel,
        "mel_mean_abs_diff": float(np.abs(mel_p[:, :n] - mel_x[:, :n]).mean()),
        "mel_max_abs_diff": float(np.abs(mel_p[:, :n] - mel_x[:, :n]).max()),
        "linear_mean_abs_diff": float(np.abs(lin_p[:, :n]
                                             - lin_x[:, :n]).mean()),
        "attn_max_abs_diff": float(np.abs(attn_p[:na] - attn_x[:na]).max()),
        metric("frames_per_s_plain", dev): rates["plain"],
        metric("frames_per_s_kernel", dev): rates["kernel"],
        "kernel_launches": launches["kernel"],
    }
    if args.int8:
        mel_q, _, attn_q = out["kernel_int8"]
        nq = min(mel_q.shape[1], frames_plain)
        naq = min(attn_q.shape[0], attn_x.shape[0])
        d = np.abs(mel_q[:, :nq] - mel_x[:, :nq])
        rec.update({
            "frames_kernel_int8": int(mel_q.shape[1]),
            "mel_mean_abs_diff_int8": float(d.mean()),
            "mel_max_abs_diff_int8": float(d.max()),
            "attn_max_abs_diff_int8": float(np.abs(attn_q[:naq]
                                                   - attn_x[:naq]).max()),
            metric("frames_per_s_kernel_int8", dev): rates["kernel_int8"],
            "kernel_launches_int8": launches["kernel_int8"],
        })
    if final_loss is not None:
        rec.update(train_steps=args.train, final_train_loss=final_loss)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
