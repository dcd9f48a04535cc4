"""Where the Tacotron train step's time goes (ports
``tools/tts_train_probe.py``).

    python -m wavernn_tpu_torch.tools.tts_train_probe [B] [L] [T]
        [--passes 3] [--calls 4] [--device cuda|cpu]

``TacotronConfig()`` with seeded weights (``init_variables(cfg, 0)``),
r = 2, B utterances of L symbols and T frames (defaults 16, 100, 600),
inputs from ``np.random.default_rng(0)``, dropout and zoneout masks from a
generator seeded 2, Adam at 1e-4 without clipping.  The pieces:

* the full step (``make_tts_train_step``: forward, backward, Adam);
* the loss gradient only (forward and backward, no optimizer);
* the forward only: in train mode (dropout and zoneout), in train mode
  with neither (both prenets' dropout at 0 and no masks: the same batch
  statistics and fused BiGRUs), and in eval mode;
* the encoder and the postnet forward, in train mode;

and the shares derived from them: optimizer = full - loss-grad, backward
= loss-grad - forward, dropout/zoneout = train forward - train forward
without them, decoder = train forward - encoder - postnet (a residual
estimate).  The JAX tool takes the dropout/zoneout share as train forward
- eval forward; here that difference mixes in the CBHG BiGRUs, which eval
mode runs as step loops and train mode fuses into one call each
(``models/tacotron.py``), so the eval forward is reported but no share
is derived from it.

Each piece is timed as ``--calls`` (K, 4) calls made back to back, best
of ``--passes`` passes (a pass times every piece in turn): CUDA events
recorded around the host launching them, then a synchronize.  The
step is host-bound, so this wall time of the card's queue is what
counts.  On the card each piece's device kernel
count comes from one call under ``torch.profiler`` (its CUDA activity
only).  ``--device cpu`` times the same pieces with the host clock, each
labelled a CPU host time, and counts no kernels.

The JAX tool also times its scan's ``decoder_unroll`` sweep and a step
without decoder rematerialisation.  Neither knob exists here: the port's
decoder is a Python loop of cell steps, with no XLA scan to unroll or
rematerialise (``models/tacotron.py::TacotronConfig``), so both lines are
left out.  Prints a line per piece, then one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np

from wavernn_tpu_torch.tools import card, device_of, metric, sync_of

R = 2
K = 4  # calls made back to back in a timed pass
PIECES = ("full_step", "loss_grad", "forward_train", "forward_train_nodrop",
          "forward_eval", "encoder_train", "postnet_train")


def pass_ms(fn, dev, k: int = K) -> float:
    """ms per call of ``k`` calls of ``fn`` made back to back."""
    import torch

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(k):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / k
    t0 = time.perf_counter()
    for _ in range(k):
        fn()
    return (time.perf_counter() - t0) * 1e3 / k


def device_kernels(fn, dev) -> int:
    """The kernels the card runs for one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = sync_of(dev)
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", type=int, nargs="?", default=16)
    ap.add_argument("L", type=int, nargs="?", default=100)
    ap.add_argument("T", type=int, nargs="?", default=600)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--calls", type=int, default=K,
                    help="calls made back to back in a timed pass")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    import torch

    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, from_jax_variables, init_variables,
    )
    from wavernn_tpu_torch.training.state import Adam, new_train_state
    from wavernn_tpu_torch.training.tacotron import make_tts_train_step

    B, L, T = args.B, args.L, args.T
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, 60, (B, L))).to(dev)
    m = torch.from_numpy(rng.uniform(-4, 4, (B, T, 80)).astype(
        np.float32)).to(dev)
    mels = torch.from_numpy(rng.uniform(-4, 4, (B, T, 80)).astype(
        np.float32)).to(dev)

    cfg = TacotronConfig()
    model = from_jax_variables(init_variables(cfg, 0), cfg, dev)
    opt = Adam(1e-4)                  # optax.adam(1e-4): no clipping
    state = new_train_state(model, opt)
    step = make_tts_train_step(model, opt, R)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def loss_of(train: bool):
        m1, m2, _ = model(x, m, R, train, generator=gen)
        return (m1 - m).abs().mean() + (m2 - m).abs().mean()

    def loss_grad():
        model.train()
        loss_of(True).backward()
        model.zero_grad(set_to_none=True)

    @torch.no_grad()
    def forward(train: bool):
        model.train(train)
        return loss_of(train)

    @contextlib.contextmanager
    def dropout_off():
        prenets = (model.encoder.pre_net, model.decoder.prenet)
        saved = [p.dropout for p in prenets]
        for p in prenets:
            p.dropout = 0.0
        try:
            yield
        finally:
            for p, d in zip(prenets, saved):
                p.dropout = d

    @torch.no_grad()
    def forward_nodrop():
        model.train()
        with dropout_off():
            m1, m2, _ = model(x, m, R, True, masks=(None,) * 4)
        return (m1 - m).abs().mean() + (m2 - m).abs().mean()

    @torch.no_grad()
    def encoder():
        model.train()
        return model.encode(x, True, generator=gen)[0].sum()

    @torch.no_grad()
    def postnet():
        model.train()
        return model.postnet_forward(mels, True).sum()

    fns = {"full_step": lambda: step(state, x, m, gen),
           "loss_grad": loss_grad,
           "forward_train": lambda: forward(True),
           "forward_train_nodrop": forward_nodrop,
           "forward_eval": lambda: forward(False),
           "encoder_train": encoder,
           "postnet_train": postnet}
    tag = card(dev)
    key = metric("ms", dev)
    rec = {"device": tag, "B": B, "L": L, "T": T, "r": R, "K": args.calls,
           "passes": args.passes}
    for name in PIECES:
        fns[name]()                                   # warm
    # each pass times every piece in turn, so that the host's slow spells
    # fall on all of them alike
    passes = [{name: pass_ms(fns[name], dev, args.calls) for name in PIECES}
              for _ in range(args.passes)]
    ms = {name: min(p[name] for p in passes) for name in PIECES}
    for name in PIECES:
        rec[name] = {key: ms[name]}
        line = f"[{tag}] {name:16s} {ms[name]:10.2f} ms"
        if dev.type == "cuda":
            rec[name]["kernels"] = device_kernels(fns[name], dev)
            line += f"  {rec[name]['kernels']:7d} kernels"
        print(line, flush=True)
    shares = {
        "optimizer": ms["full_step"] - ms["loss_grad"],
        "backward": ms["loss_grad"] - ms["forward_train"],
        "dropout_zoneout": ms["forward_train"] - ms["forward_train_nodrop"],
        "decoder_residual": (ms["forward_train"] - ms["encoder_train"]
                             - ms["postnet_train"]),
    }
    for name, v in shares.items():
        print(f"[{tag}] -> {name + ' share':24s} {v:10.2f} ms")
    rec["shares"] = {k: {key: v} for k, v in shares.items()}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
