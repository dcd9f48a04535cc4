"""Where the Tacotron decoder-step kernel's time goes: the span of each of
a step's ten phases in one launch, and the cost of one bare grid barrier.

    python -m wavernn_tpu_torch.tools.tts_phase_spans [--steps 750]
        [--L 64] [--int8_lstm] [--barriers 20000] [--device cuda|cpu]

On the card: ``TacotronConfig()`` with seeded weights
(``init_variables(cfg, 0)``), r = 2, a 60-symbol text from
``np.random.default_rng(0)`` padded to ``L`` symbols, packed with bf16
LSTM rows or, with ``--int8_lstm``, int8 ones, one launch of the
kernel's spans instantiation in the plan's placement (the global one past
the shared placement's longest text; ``cuda_tts.tts_decode_spans``: CTA 0
stamps
``%globaltimer`` at the end of each phase of every step, when the next
phase's input has come, and after the step's grid barrier).  A phase's
span runs from the previous stamp to its own, so it holds the phase's work
and the hand-over of its outputs; each is the mean over
steps 1 .. steps-1 (step 0 holds the launch's prologue); the launch's
mels and scores are held against the plain version.  Then the
bare-barrier loop (``tts_barrier_loop``: ``--barriers`` barriers with no
work between them, timed with CUDA events) for the counter barrier the
kernel uses and the generation barrier it replaced, at 64 CTAs and at one
CTA per SM.  ``--device cpu`` prints the kernel's shared-memory plan
only (``cuda_tts.tts_smem_plan``); nothing is timed.
Prints one line per measurement, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from wavernn_tpu_torch.tools import card, device_of

PHASES = ("prenet1", "prenet2", "attn_gru", "query", "energies",
          "scores_context", "rnn_input", "lstm1", "lstm2", "mel")
BARRIERS = {"generation": 0, "counter": 1}
R = 2
H100_SMS = 132


def kernel_inputs(L: int, dev: torch.device, int8_lstm: bool = False):
    """Packed full-width weights (int8 LSTM rows with ``int8_lstm``) and
    the encoder outputs of a seeded 60-symbol text padded to L symbols
    (``chip_smoke.py`` phase 6's and phase 42's inputs)."""
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, from_jax_variables, init_variables,
    )
    from wavernn_tpu_torch.ops.tts_decode import (
        extract_tts_decode_weights, pack_tts_weights,
    )

    cfg = TacotronConfig()
    model = from_jax_variables(init_variables(cfg, 0), cfg, dev)
    rng = np.random.default_rng(0)
    seq = rng.integers(1, cfg.num_chars, 60)
    x = torch.zeros(1, L, dtype=torch.long)
    n = min(L, len(seq))
    x[0, :n] = torch.from_numpy(seq[:n])
    with torch.no_grad():
        enc, encp = model.encode(x.to(dev))
    packed = pack_tts_weights(extract_tts_decode_weights(model), R,
                              cfg.n_mels, int8_lstm=int8_lstm)
    return cfg, packed, enc[0].contiguous(), encp[0].contiguous()


def phase_spans(cfg, packed, enc, encp, n_steps: int) -> dict:
    """Mean us of each phase (work and hand-over) over steps 1 .. n-1 of one
    spans launch, the us per step between the stamps, and the launch's max
    |d| to the plain version (mels and scores)."""
    from wavernn_tpu_torch.ops import cuda_tts
    from wavernn_tpu_torch.ops.tts_decode import (
        init_tts_decode_state, tts_decode_reference,
    )

    if n_steps < 2:
        raise ValueError("the spans need at least 2 steps")
    state = lambda: init_tts_decode_state(cfg.decoder_dims, cfg.lstm_dims,
                                          enc.shape[0], cfg.n_mels,
                                          enc.device)
    (mels, scores, _, _), stamps = cuda_tts.tts_decode_spans(
        packed, enc, encp, state(), n_steps)
    torch.cuda.synchronize(enc.device)
    want = tts_decode_reference(packed, enc, encp, state(), n_steps)
    err = max(float((mels - want[0]).abs().max()),
              float((scores - want[1]).abs().max()))
    t = stamps.cpu().numpy().astype(np.float64)          # ns
    flat = t.reshape(-1)
    if not (np.diff(flat) >= 0).all() or not (flat > 0).all():
        raise RuntimeError("the span stamps do not increase")
    B = len(PHASES)
    d = np.diff(flat)[B - 1:].reshape(n_steps - 1, B) / 1e3  # us, steps 1..
    return {"phase_us": {p: float(v) for p, v in zip(PHASES, d.mean(0))},
            "us_per_step": float(d.sum(1).mean()), "max_abs_err": err}


def barrier_cost(kind: str, ctas: int, n: int, dev: torch.device) -> float:
    """us per barrier of ``n`` bare barriers of ``kind`` on ``ctas``
    CTAs."""
    from wavernn_tpu_torch.ops.build import load_library

    lib = load_library()

    def run(count):
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tts_barrier_loop(BARRIERS[kind], ctas, count,
                                   ctypes.c_void_p(bar.data_ptr()),
                                   ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"tts_barrier_loop: "
                               f"{lib.wavernn_error_string(err).decode()}")

    run(100)                                              # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    run(n)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) * 1e3 / n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=750)
    ap.add_argument("--L", type=int, default=64)
    ap.add_argument("--int8_lstm", action="store_true",
                    help="int8 LSTM rows (the kernel's int8_lstm variant)")
    ap.add_argument("--barriers", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from wavernn_tpu_torch.models.tacotron import TacotronConfig
    from wavernn_tpu_torch.ops.cuda_tts import tts_smem_plan

    tag = card(dev)
    c = TacotronConfig()
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    plan = tts_smem_plan(c.decoder_dims, c.decoder_dims // 2, c.lstm_dims,
                         c.n_mels, R, args.L, sms, int8_lstm=args.int8_lstm)
    variant = "int8_lstm" if args.int8_lstm else "bf16"
    rec = {"device": tag, "L": args.L, "r": R, "grid": sms,
           "variant": variant, "placement": plan["placement"],
           "smem_bytes": plan["bytes"],
           "weight_bytes_max": max(plan["weight_bytes"])}
    print(f"[{tag}] plan at full width, {variant}, L={args.L}, {sms} CTAs, "
          f"{plan['placement']} placement: {plan['bytes']} bytes of shared "
          f"memory per CTA, weights {min(plan['weight_bytes'])}-"
          f"{max(plan['weight_bytes'])}", flush=True)
    if dev.type == "cuda":
        cfg, packed, enc, encp = kernel_inputs(args.L, dev, args.int8_lstm)
        spans = phase_spans(cfg, packed, enc, encp, args.steps)
        rec.update(steps=args.steps, **spans)
        print(f"[{tag}] spans ({variant}, {plan['placement']}), "
              f"{args.steps} steps: " + ", ".join(
            f"{p} {v:.2f}" for p, v in spans["phase_us"].items())
            + f" us; {spans['us_per_step']:.2f} us/step; max|d| to the "
            f"plain version {spans['max_abs_err']:.3g}", flush=True)
        rec["barrier_us"] = {}
        for kind in BARRIERS:
            for ctas in (64, sms):
                us = barrier_cost(kind, ctas, args.barriers, dev)
                rec["barrier_us"][f"{kind}_{ctas}"] = us
                print(f"[{tag}] bare barrier [{kind}] at {ctas} CTAs: "
                      f"{us:.3f} us", flush=True)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
