"""Bisection of a trained ``e2e_tts`` workspace on the CPU, package against
package (both imported: this is a test helper, not part of the port).

    PYTHONPATH=. python tests/e2e_bisect.py --workspace DIR
        [--steps decode,vocoder,train] [--train_steps 1000] [--seed 0]
        [--dropout P] [--device cpu|cuda]

``DIR`` holds ``hp_e2e.py``, ``checkpoints/<id>.tacotron/
latest_weights.msgpack`` and ``checkpoints/<id>.wavernn/
latest_weights.msgpack``, as ``python -m
wavernn_tpu_torch.examples.e2e_tts --keep`` leaves them (or a copy of
those files).

* ``decode``: the three ``EVAL_TEXTS`` through the trained Tacotron in
  two ways, the JAX package's ``TTSGenerator(backend="xla")`` and the
  port's plain decoder (``TTSGenerator(..., "cpu")``), at the r of the
  stored step; each scored with the port example's ``diagonality`` (and
  its frame count, and the two decodes' largest mel |d|).
* ``vocoder``: each eval text's ground-truth mel (its ``build_corpus``
  audio through the port's ``melspectrogram``) through the trained
  vocoder, batched as ``gen_tacotron`` (``--device cuda``: the decode
  kernel; the step imports no JAX, so it runs on the card), scored with
  the example's ``spectral_match``.
* ``train``: the e2e corpus preprocessed by the port under
  ``DIR/corpus``, then ``--train_steps`` r = 7 steps of both packages'
  train steps from the same initial weights on the same batches, each
  with its own mask draws; the loss and the teacher-forced attention's
  diagonality every 100 steps.
* ``same_masks``: as ``train``, but every step's masks drawn once with
  numpy and given to both packages: the first step's losses and gradient
  gap, then the loss and diagonality every 50 steps.

Prints one JSON line per step.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np


def _configure(ws: Path, with_jax: bool = True):
    from wavernn_tpu_torch.config import hp

    hp.reset()
    hp.configure(ws / "hp_e2e.py")
    if with_jax:
        from wavernn_tpu.config import hp as jax_hp

        jax_hp.reset()
        jax_hp.configure(str(ws / "hp_e2e.py"))
    return hp


def _weights(ws: Path, kind: str):
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    (path,) = (ws / "checkpoints").glob(f"*.{kind}/latest_weights.msgpack")
    blob = load_pytree(path)
    return ({"params": blob["params"], "batch_stats": blob["batch_stats"]},
            int(np.asarray(blob["step"])))


def decode(ws: Path) -> dict:
    """The eval texts through JAX's XLA decoder and the port's plain one."""
    from wavernn_tpu.infer.tacotron import TTSGenerator as JaxTTSGenerator
    from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
    from wavernn_tpu_torch.examples import e2e_tts
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import TacotronConfig
    from wavernn_tpu_torch.text.symbols import symbols
    from wavernn_tpu_torch.training.tacotron import r_for_step

    hp = _configure(ws)
    variables, step = _weights(ws, "tacotron")
    r = r_for_step(step, hp.tts_schedule)
    jax_gen = JaxTTSGenerator(JaxConfig.from_hp(hp, num_chars=len(symbols)),
                              variables, backend="xla")
    port_gen = TTSGenerator(TacotronConfig.from_hp(hp, len(symbols)),
                            variables, "cpu")
    out = {"step": step, "r": r, "utterances": []}
    for text in e2e_tts.EVAL_TEXTS:
        seq = e2e_tts._seq(text)
        rec = {"text": text}
        mels = {}
        for name, gen in (("jax_xla", jax_gen), ("port_plain", port_gen)):
            mel, _, attn = gen(seq, r=r)
            mels[name] = np.asarray(mel)
            mono, cov, sharp = e2e_tts.diagonality(np.asarray(attn), len(seq))
            rec[name] = {"frames": int(mel.shape[1]),
                         "attn_monotone": round(mono, 3),
                         "attn_coverage": round(cov, 3),
                         "attn_sharpness": round(sharp, 3)}
        n = min(m.shape[1] for m in mels.values())
        rec["mel_max_abs_diff_first_frames"] = float(np.abs(
            mels["jax_xla"][:, :n] - mels["port_plain"][:, :n]).max())
        out["utterances"].append(rec)
    return out


def vocoder(ws: Path, device: str = "cpu") -> dict:
    """Ground-truth mels of the eval texts through the trained vocoder on
    ``device`` (no JAX: it runs on the card too)."""
    from wavernn_tpu_torch.dsp import audio
    from wavernn_tpu_torch.examples import e2e_tts
    from wavernn_tpu_torch.infer.wavernn import make_generator
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig

    hp = _configure(ws, with_jax=False)
    variables, step = _weights(ws, "wavernn")
    gen = make_generator(WaveRNNConfig.from_hp(hp), variables, device)
    tones = e2e_tts._symbol_tones()
    out = {"step": step, "device": device, "utterances": []}
    with tempfile.TemporaryDirectory() as tmp:
        e2e_tts.build_corpus(Path(tmp), e2e_tts.EVAL_TEXTS)
        for i, text in enumerate(e2e_tts.EVAL_TEXTS):
            y = audio.load_wav(Path(tmp) / f"utt{i}.wav")
            mel = audio.melspectrogram(y)
            wav = gen(mel, batched=True, target=hp.voc_target,
                      overlap=hp.voc_overlap, mu_law=hp.mu_law)
            wav = np.asarray(wav)
            if wav.dtype == np.int16:
                wav = wav / 32768.0
            seq = e2e_tts._seq(text)
            out["utterances"].append({
                "text": text,
                "spectral_match_vocoded": round(e2e_tts.spectral_match(
                    wav, seq, tones), 3),
                "spectral_match_ground_truth": round(e2e_tts.spectral_match(
                    np.asarray(y, np.float64), seq, tones), 3)})
    return out


def _corpus(ws: Path, n_texts: int) -> Path:
    """The e2e corpus (its first ``n_texts`` texts) preprocessed by the
    port under ``ws/corpus``, with the example's hp file; returns the
    data path."""
    from wavernn_tpu_torch import preprocess
    from wavernn_tpu_torch.examples import e2e_tts

    root = ws / "corpus"
    root.mkdir(parents=True, exist_ok=True)
    e2e_tts.build_corpus(root / "wavs", e2e_tts.TRAIN_TEXTS[:n_texts])
    (root / "hp_e2e.py").write_text(e2e_tts.HP_TEMPLATE.format(
        repo=str(e2e_tts.REPO), voc_steps=1, tts_s1=2000, tts_s2=6000))
    e2e_tts.run_cli(preprocess.main, ["--path", "wavs", "--num_workers",
                                      "2", "--hp_file", "hp_e2e.py"],
                    root, "preprocess")
    return root


def train(ws: Path, steps: int = 1000, every: int = 100,
          n_texts: int = 1200, dropout: float = None,
          seed: int = 0) -> dict:
    """``steps`` r = 7 steps of both packages' train steps on the e2e
    corpus, from the same initial weights (``init_variables(cfg, 0)``, as
    ``train_tacotron`` starts) and the same batches (the port's loader),
    each drawing its own dropout and zoneout masks (JAX from
    ``PRNGKey(seed * 1_000_000 + step)``, the port from a generator
    seeded with ``seed``): every
    ``every`` steps the mean loss and the teacher-forced attention's
    diagonality on the batch, per package.  ``dropout`` replaces
    ``hp.tts_dropout`` in both models when given."""
    import jax
    import torch

    from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
    from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
    from wavernn_tpu.training.state import make_optimizer as jax_optimizer
    from wavernn_tpu.training.state import new_train_state as jax_state
    from wavernn_tpu.training.tacotron import make_tts_train_step as jax_step
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.data.dataset import get_tts_datasets
    from wavernn_tpu_torch.examples import e2e_tts
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, from_jax_variables, init_variables,
    )
    from wavernn_tpu_torch.text.symbols import symbols
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )
    from wavernn_tpu_torch.training.tacotron import make_tts_train_step

    import dataclasses

    root = (ws / "corpus" if (ws / "corpus" / "data" / "dataset.pkl").exists()
            else _corpus(ws, n_texts))
    hp.reset()
    hp.configure(root / "hp_e2e.py")
    r, lr, _, bs = hp.tts_schedule[0]
    cfg = TacotronConfig.from_hp(hp, len(symbols))
    jcfg = JaxConfig.from_hp(hp, len(symbols))
    if dropout is not None:
        cfg = dataclasses.replace(cfg, dropout=dropout)
        jcfg = dataclasses.replace(jcfg, dropout=dropout)
    v = init_variables(cfg, 0)
    model = from_jax_variables(v, cfg, "cpu")
    opt = make_optimizer(lr, hp.tts_clip_grad_norm)
    state = new_train_state(model, opt)
    step = make_tts_train_step(model, opt, r)
    jopt = jax_optimizer(lr, hp.tts_clip_grad_norm)
    jstate = jax_state(v["params"], v["batch_stats"], jopt)
    jstep = jax_step(JaxTacotron(jcfg), jopt, r)
    gen = torch.Generator().manual_seed(seed)
    data, _ = get_tts_datasets(root / "data", bs, r)
    hist = {"port": [], "jax": []}
    acc = {k: [] for k in hist}
    done = 0
    while done < steps:
        for x, m, ids, mel_lens in data:
            state, loss, _, attn, _ = step(state, x, m, gen)
            jstate, jloss, _, jattn, _ = jstep(
                jstate, x, m, jax.random.PRNGKey(seed * 1_000_000 + done))
            for name, a, lo in (("port", attn.numpy(), float(loss)),
                                ("jax", np.asarray(jattn), float(jloss))):
                diag = [e2e_tts.diagonality(a[i, :-(-n // r)],
                                            int((x[i] > 0).sum()))
                        for i, n in enumerate(mel_lens)]
                acc[name].append((lo,) + tuple(np.mean(diag, axis=0)))
            done += 1
            if done % every == 0:
                for name in hist:
                    mean = np.mean(acc[name], axis=0)
                    hist[name].append({
                        "step": done, "loss": round(float(mean[0]), 4),
                        "attn_monotone": round(float(mean[1]), 3),
                        "attn_coverage": round(float(mean[2]), 3),
                        "attn_sharpness": round(float(mean[3]), 3)})
                    acc[name] = []
                print(json.dumps({"step": done, **{k: v[-1] for k, v in
                                                   hist.items()}}),
                      flush=True)
            if done >= steps:
                break
    hp.reset()
    return {"r": r, "lr": lr, "batch_size": bs, "texts": n_texts,
            "history": hist}


def same_masks(ws: Path, steps: int = 400, every: int = 50,
               n_texts: int = 1200) -> dict:
    """``steps`` r = 7 steps of both packages from the same initial weights
    and batches as :func:`train`, each step's dropout and zoneout masks
    drawn once with numpy and given to both (JAX's two encoder-prenet
    ``nn.Dropout`` calls intercepted, its decoder run as
    ``Tacotron.__call__`` runs it, its update optax's): the first step's
    losses and the largest relative L2 gap of a gradient leaf, then the
    mean loss and attention diagonality every ``every`` steps."""
    import dataclasses

    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
    from wavernn_tpu.models.tacotron import TacotronConfig as JaxConfig
    from wavernn_tpu.models.tacotron import init_decoder_carry as jax_carry
    from wavernn_tpu.training.state import make_optimizer as jax_optimizer
    from wavernn_tpu.training.state import new_train_state as jax_state
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.data.dataset import get_tts_datasets
    from wavernn_tpu_torch.examples import e2e_tts
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, from_jax_variables, init_variables, to_jax_tree,
    )
    from wavernn_tpu_torch.text.symbols import symbols
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )

    root = (ws / "corpus" if (ws / "corpus" / "data" / "dataset.pkl").exists()
            else _corpus(ws, n_texts))
    hp.reset()
    hp.configure(root / "hp_e2e.py")
    r, lr, _, bs = hp.tts_schedule[0]
    cfg = TacotronConfig.from_hp(hp, len(symbols))
    jcfg = dataclasses.replace(JaxConfig.from_hp(hp, len(symbols)))
    keep, E = 1.0 - cfg.dropout, cfg.encoder_dims
    v = init_variables(cfg, 0)
    jmodel = JaxTacotron(jcfg)

    def jax_loss(params, stats, x, m, enc, dec):
        calls = []

        def given_masks(next_fun, args, kwargs, context):
            if (isinstance(context.module, nn.Dropout)
                    and context.method_name == "__call__"):
                calls.append(None)
                return jnp.where(enc[len(calls) - 1], args[0] / keep, 0.0)
            return next_fun(*args, **kwargs)

        def forward(module, x, m, masks):
            e, ep = module.encode(x, True)
            B, T = m.shape[0], m.shape[1]
            go = jnp.zeros((1, B, jcfg.n_mels), m.dtype)
            idx = jnp.arange(1, T // r) * r - 1
            pre = jnp.concatenate([go, jnp.swapaxes(m[:, idx], 0, 1)], 0)
            _, (mels, sc) = module.decoder(jax_carry(jcfg, B, x.shape[1],
                                                     m.dtype),
                                           e, ep, pre, masks, r, True)
            mel = jnp.transpose(mels, (1, 0, 3, 2)).reshape(B, T, -1)
            return (mel, module.postnet_forward(mel, True),
                    jnp.swapaxes(sc, 0, 1))

        with nn.intercept_methods(given_masks):
            (m1, m2, attn), mut = jmodel.apply(
                {"params": params, "batch_stats": stats}, x, m, dec,
                method=forward, mutable=["batch_stats"])
        loss = jnp.abs(m1 - m).mean() + jnp.abs(m2 - m).mean()
        return loss, (mut["batch_stats"], attn)

    jopt = jax_optimizer(lr, hp.tts_clip_grad_norm)

    @jax.jit
    def jstep(st, x, m, enc, dec):
        (loss, (stats, attn)), g = jax.value_and_grad(
            jax_loss, has_aux=True)(st.params, st.batch_stats, x, m, enc,
                                     dec)
        upd, opt_state = jopt.update(g, st.opt_state, st.params)
        return (st.replace(params=optax.apply_updates(st.params, upd),
                           batch_stats=stats, opt_state=opt_state,
                           step=st.step + 1), loss, attn, g)

    jstate = jax_state(v["params"], v["batch_stats"], jopt)
    model = from_jax_variables(v, cfg, "cpu")
    opt = make_optimizer(lr, hp.tts_clip_grad_norm)
    state = new_train_state(model, opt)
    data, _ = get_tts_datasets(root / "data", bs, r)
    rng = np.random.default_rng(0)
    out = {"r": r, "lr": lr, "batch_size": bs, "history": []}
    acc = {"port": [], "jax": []}
    done = 0
    while done < steps:
        for x, m, ids, mel_lens in data:
            B, L = x.shape
            T_dec = m.shape[1] // r
            draw = lambda shape, p: rng.random(shape) < p
            enc = (draw((B, L, 2 * E), keep), draw((B, L, E), keep))
            dec = (draw((T_dec, B, cfg.decoder_dims), keep),
                   draw((T_dec, B, cfg.decoder_dims // 2), keep),
                   draw((T_dec, B, cfg.lstm_dims), 0.1),
                   draw((T_dec, B, cfg.lstm_dims), 0.1))
            model.train()
            mt = torch.from_numpy(m)
            m1, m2, attn = model(torch.from_numpy(x).long(), mt, r, True,
                                 masks=tuple(map(torch.from_numpy, dec)),
                                 encoder_masks=tuple(map(torch.from_numpy,
                                                         enc)))
            loss = (m1 - mt).abs().mean() + (m2 - mt).abs().mean()
            loss.backward()
            if done == 0:
                grads = to_jax_tree({n: p.grad for n, p in
                                     model.named_parameters()}, model)
            opt.step(model, state.opt_state)
            jstate, jloss, jattn, jgrads = jstep(jstate, x, m, enc, dec)
            if done == 0:
                gaps = [float(np.linalg.norm(g - np.asarray(jg))
                              / max(np.linalg.norm(np.asarray(jg)), 1e-30))
                        for g, jg in zip(jax.tree_util.tree_leaves(grads),
                                         jax.tree_util.tree_leaves(jgrads))
                        if np.abs(np.asarray(jg)).max() > 0]
                out["first_step"] = {
                    "loss_port": float(loss.detach()),
                    "loss_jax": float(jloss),
                    "grad_max_rel_l2": max(gaps)}
                print(json.dumps(out["first_step"]), flush=True)
            for name, a, lo in (("port", attn.detach().numpy(),
                                 float(loss.detach())),
                                ("jax", np.asarray(jattn), float(jloss))):
                diag = [e2e_tts.diagonality(a[i, :-(-n // r)],
                                            int((x[i] > 0).sum()))
                        for i, n in enumerate(mel_lens)]
                acc[name].append((lo,) + tuple(np.mean(diag, axis=0)))
            done += 1
            if done % every == 0:
                rec = {"step": done}
                for name in acc:
                    mean = np.mean(acc[name], axis=0)
                    rec[name] = {
                        "loss": round(float(mean[0]), 4),
                        "attn_monotone": round(float(mean[1]), 3),
                        "attn_coverage": round(float(mean[2]), 3),
                        "attn_sharpness": round(float(mean[3]), 3)}
                    acc[name] = []
                out["history"].append(rec)
                print(json.dumps(rec), flush=True)
            if done >= steps:
                break
    hp.reset()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--steps", default="decode,vocoder",
                    help="comma-separated: decode, vocoder, train, "
                         "same_masks")
    ap.add_argument("--train_steps", type=int, default=1000)
    ap.add_argument("--dropout", type=float, default=None,
                    help="train: both models' dropout (default hp's)")
    ap.add_argument("--seed", type=int, default=0,
                    help="train: the mask streams' seed")
    ap.add_argument("--device", default="cpu",
                    help="vocoder: the decode's device (cuda: the kernel)")
    args = ap.parse_args(argv)
    ws = Path(args.workspace)
    for name in args.steps.split(","):
        fn = {"decode": decode,
              "same_masks": lambda w: same_masks(w, args.train_steps),
              "vocoder": lambda w: vocoder(w, args.device),
              "train": lambda w: train(w, args.train_steps,
                                       dropout=args.dropout,
                                       seed=args.seed)}[name]
        print(json.dumps({"bisect": name, **fn(ws)}), flush=True)


if __name__ == "__main__":
    main()
