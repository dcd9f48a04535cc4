"""NB4a+b: the "alternative model" walkthrough (ports
``examples/nb4_alternative_model.py``; ref: notebooks/NB4a - Alternative
Model (Preprocessing).ipynb and NB4b - Alternative Model (Training).ipynb).

    python -m wavernn_tpu_torch.examples.nb4_alternative_model \\
        [--steps 150] [--batch_size 4] [--seq_hops 3] [--full_size] \\
        [--workspace DIR] [--num_workers N] [--device cuda]

The reference's NB4 pair prototypes its production model: the WaveRNN with
the MOL head, trained on preprocessed (mel, 16-bit label) pairs and
generated with batched folding.  On a synthetic corpus:

  part A - preprocess: 8 two-second harmonic tones (:func:`alt_corpus`) ->
           mel.npy + 16-bit quant.npy + dataset.pkl (MOL mode stores
           float-derived 16-bit labels, not mu-law);
  part B - train the MOL WaveRNN (``hparams.py``'s, 64-wide unless
           ``--full_size``, drawn from ``torch.manual_seed(0)``) through
           ``voc_train_loop``, then batched fold/crossfade generation of a
           held-out mel (target 2,750, overlap 550; on the card through the
           decode kernel), written as ``nb4_alternative_model.wav``.

The loss-drop check (at least 0.3 on the first batch) is held at the
default depth (``--steps`` 150 or more); a cut run prints both losses and
says that it skips it.  The device defaults to ``cuda`` and is never
swapped for another: without CUDA the command fails.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from wavernn_tpu_torch import set_float32_policy
from wavernn_tpu_torch.config import default_hparams_path, hp
from wavernn_tpu_torch.data.dataset import get_vocoder_datasets
from wavernn_tpu_torch.data.preprocess import preprocess_dataset
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.examples.nb3_fit_long_sample import (
    SMALL, first_batch_loss, loss_gate, seeded_model,
)
from wavernn_tpu_torch.models.wavernn import (
    WaveRNNConfig, num_params, to_jax_variables,
)
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.tools import device_of
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.wavernn import make_train_step, voc_train_loop
from wavernn_tpu_torch.utils.files import get_files

DEFAULT_STEPS, LOSS_DROP = 150, 0.3
TARGET, OVERLAP = 2750, 550


def alt_corpus(wav_dir: Path, sr: int) -> None:
    """Part A's corpus: 8 two-second tones at 150 + 20 i Hz with two
    harmonics."""
    wav_dir.mkdir(parents=True, exist_ok=True)
    for i in range(8):
        t = np.arange(int(sr * 2.0)) / sr
        f0 = 150.0 + 20.0 * i
        y = sum((0.5 ** k) * np.sin(2 * np.pi * (k + 1) * f0 * t)
                for k in range(3))
        wavio.save_wav((0.4 * y / np.abs(y).max()).astype(np.float32),
                       wav_dir / f"alt_{i:02d}.wav", sr=sr)


def main(argv=None) -> dict:
    """Returns ``{"dataset", "loss0", "loss1", "loss_gate", "wav",
    "path"}``."""
    parser = argparse.ArgumentParser(
        description="NB4: the MOL WaveRNN from preprocessing to generation")
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--seq_hops", type=int, default=3)
    parser.add_argument("--full_size", action="store_true")
    parser.add_argument("--workspace", default=None)
    parser.add_argument("--num_workers", type=int, default=None,
                        help="preprocess pool processes")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    dev = device_of(args.device)
    set_float32_policy()
    ws = Path(args.workspace or tempfile.mkdtemp(prefix="nb4_"))
    print(f"workspace: {ws}")

    hp.configure(
        default_hparams_path(), data_path=str(ws / "data"),
        voc_mode="MOL",  # the alternative model's head
        voc_batch_size=args.batch_size, voc_total_steps=args.steps,
        voc_seq_len=args.seq_hops * 275,
        voc_checkpoint_every=args.steps, voc_gen_at_checkpoint=0,
        voc_test_samples=2, **({} if args.full_size else SMALL),
    )

    # ---- part A: preprocessing (NB4a) ---------------------------------------
    sr = hp.sample_rate
    wav_dir = ws / "wavs"
    alt_corpus(wav_dir, sr)
    paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id, base=ws)
    dataset = preprocess_dataset(get_files(wav_dir, ".wav"), paths,
                                 n_workers=args.num_workers)
    assert len(dataset) == 8
    # MOL preprocessing stores 16-bit labels (ref preprocess.py:44-46)
    quant = np.load(paths.quant / f"{dataset[0][0]}.npy")
    assert quant.max() >= 2 ** 9, "expected 16-bit label range in MOL mode"
    print(f"part A OK: {len(dataset)} utterances preprocessed (16-bit labels)")

    # ---- part B: training + batched generation (NB4b) -----------------------
    cfg = WaveRNNConfig.from_hp(hp)
    assert cfg.mode == "MOL" and cfg.n_classes == 30
    model = seeded_model(cfg, dev)
    print("Trainable Parameters: %.3fM" % num_params(model))
    opt = make_optimizer(hp.voc_lr * 4, hp.voc_clip_grad_norm)
    state = new_train_state(model, opt)

    train_set, test_set = get_vocoder_datasets(paths.data, args.batch_size,
                                               train_gta=False)
    step_fn = make_train_step(opt, cfg.mode)
    batch0 = next(iter(train_set))
    loss0 = first_batch_loss(step_fn, state, batch0)

    state = voc_train_loop(paths, cfg, state, opt, train_set, test_set,
                           total_steps=args.steps, gen_at_checkpoint=False)
    loss1 = first_batch_loss(step_fn, state, batch0)
    print(f"MOL loss {loss0:.3f} -> {loss1:.3f}")
    gated = loss_gate(loss0, loss1, args.steps, DEFAULT_STEPS, LOSS_DROP,
                      "MOL loss")

    # batched fold/crossfade generation of a held-out mel (NB4b's finale)
    mel, _ = next(iter(test_set))
    gen = Generator(cfg, to_jax_variables(state.model), device=dev)
    wav = gen(np.asarray(mel), batched=True, target=TARGET, overlap=OVERLAP,
              mu_law=False)
    out = paths.voc_output / "nb4_alternative_model.wav"
    wavio.save_wav(np.asarray(wav, np.float32), out, sr=sr)
    assert np.isfinite(wav).all() and len(wav) > sr
    print(f"part B OK: wrote {out} ({len(wav) / sr:.1f}s)")
    return {"dataset": dataset, "loss0": loss0, "loss1": loss1,
            "loss_gate": gated, "wav": wav, "path": out}


if __name__ == "__main__":
    main()
