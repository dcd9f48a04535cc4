"""Export msgpack weights as reference-layout PyTorch state dicts (``.pyt``),
the inverse of ``convert_torch_checkpoint`` (ports
``tools/export_torch_checkpoint.py``).

    python -m wavernn_tpu_torch.tools.export_torch_checkpoint wavernn \
        latest_weights.msgpack out.pyt [--hp_file hparams.py]
    python -m wavernn_tpu_torch.tools.export_torch_checkpoint tacotron \
        latest_weights.msgpack out.pyt [--hp_file hparams.py] [--r R]

A model trained in either package loads straight into the reference's
``WaveRNN.load`` / ``Tacotron.load`` (ref: models/fatchord_version.py:414-417,
models/tacotron.py:448-456) and its generation and fine-tuning scripts.

Weight-layout mapping (here -> torch), inverting the import converter:
  * Linear:   kernel (in,out)       -> weight (out,in)^T
  * Conv1d:   kernel (k,in,out)     -> weight (out,in,k)
  * GRU/LSTM cell: w_ih (in,G*H)    -> weight_ih[_l0] (G*H,in)^T
  * BatchNorm: scale/bias + batch_stats mean/var -> weight/bias +
    running_mean/running_var (num_batches_tracked written as 0: the
    reference never reads it, torch only requires the key to exist)
  * Upsample up{i}_kernel (k,)      -> up_layers.{2i+1}.weight (1,1,1,k)
Buffers: the step counter travels (ref models/fatchord_version.py:125);
Tacotron also carries decoder.r and stop_threshold (ref
models/tacotron.py:214,299-300).  r defaults to the curriculum's value for
the checkpoint's step (``training/tacotron.py::r_for_step``), so a resumed
reference run lands in the right session.  The layout functions are
numpy-only copies of the JAX tool's.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def t(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)


def conv1d(x):  # (k,in,out) -> (out,in,k)
    return np.ascontiguousarray(
        np.transpose(np.asarray(x, dtype=np.float32), (2, 1, 0)))


def f32(x):
    return np.asarray(x, dtype=np.float32)


def _bn(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = f32(params["scale"])
    sd[f"{prefix}.bias"] = f32(params["bias"])
    sd[f"{prefix}.running_mean"] = f32(stats["mean"])
    sd[f"{prefix}.running_var"] = f32(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), dtype=np.int64)


def _gru(sd, prefix, p, cell=False):
    suffix = "" if cell else "_l0"
    sd[f"{prefix}.weight_ih{suffix}"] = t(p["w_ih"])
    sd[f"{prefix}.weight_hh{suffix}"] = t(p["w_hh"])
    sd[f"{prefix}.bias_ih{suffix}"] = f32(p["b_ih"])
    sd[f"{prefix}.bias_hh{suffix}"] = f32(p["b_hh"])


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = t(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = f32(p["bias"])


def export_wavernn(params, batch_stats, step: int, upsample_factors):
    """(params, batch_stats, step) pytree → reference WaveRNN state dict
    (numpy values; inverse of convert_torch_checkpoint.convert_wavernn)."""
    sd = {}
    rp, rs = params["upsample"]["resnet"], batch_stats["upsample"]["resnet"]
    sd["upsample.resnet.conv_in.weight"] = conv1d(rp["conv_in"]["kernel"])
    _bn(sd, "upsample.resnet.batch_norm", rp["bn"], rs["bn"])
    n_blocks = len([k for k in rp if k.startswith("block")])
    for i in range(n_blocks):
        blk_p, blk_s = rp[f"block{i}"], rs[f"block{i}"]
        base = f"upsample.resnet.layers.{i}"
        sd[f"{base}.conv1.weight"] = conv1d(blk_p["conv1"]["kernel"])
        sd[f"{base}.conv2.weight"] = conv1d(blk_p["conv2"]["kernel"])
        _bn(sd, f"{base}.batch_norm1", blk_p["bn1"], blk_s["bn1"])
        _bn(sd, f"{base}.batch_norm2", blk_p["bn2"], blk_s["bn2"])
    sd["upsample.resnet.conv_out.weight"] = conv1d(rp["conv_out"]["kernel"])
    sd["upsample.resnet.conv_out.bias"] = f32(rp["conv_out"]["bias"])

    for i, _ in enumerate(upsample_factors):
        k = f32(params["upsample"][f"up{i}_kernel"]).reshape(1, 1, 1, -1)
        sd[f"upsample.up_layers.{2 * i + 1}.weight"] = k

    _linear(sd, "I", params["I"])
    _gru(sd, "rnn1", params["rnn1"]["cell"])
    _gru(sd, "rnn2", params["rnn2"]["cell"])
    for fc in ("fc1", "fc2", "fc3"):
        _linear(sd, fc, params[fc])

    sd["step"] = np.asarray([step], dtype=np.int64)
    return sd


def export_tacotron(params, batch_stats, step: int, r: int,
                    stop_threshold: float):
    """(params, batch_stats, step, r) pytree → reference Tacotron state
    dict (inverse of convert_torch_checkpoint.convert_tacotron)."""
    sd = {}

    def prenet(prefix, p):
        _linear(sd, f"{prefix}.fc1", p["fc1"])
        _linear(sd, f"{prefix}.fc2", p["fc2"])

    def cbhg(prefix, p, s):
        banks = sorted(int(k[4:]) for k in p if k.startswith("bank"))
        for k in banks:
            bp = p[f"bank{k}"]
            sd[f"{prefix}.conv1d_bank.{k - 1}.conv.weight"] = conv1d(
                bp["conv"]["kernel"])
            _bn(sd, f"{prefix}.conv1d_bank.{k - 1}.bnorm", bp["bnorm"],
                s[f"bank{k}"]["bnorm"])
        for proj in ("conv_project1", "conv_project2"):
            sd[f"{prefix}.{proj}.conv.weight"] = conv1d(
                p[proj]["conv"]["kernel"])
            _bn(sd, f"{prefix}.{proj}.bnorm", p[proj]["bnorm"],
                s[proj]["bnorm"])
        if "pre_highway" in p:
            _linear(sd, f"{prefix}.pre_highway", p["pre_highway"])
        nh = len([k for k in p if k.startswith("highway")])
        for i in range(nh):
            _linear(sd, f"{prefix}.highways.{i}.W1", p[f"highway{i}"]["W1"])
            _linear(sd, f"{prefix}.highways.{i}.W2", p[f"highway{i}"]["W2"])
        _gru(sd, f"{prefix}.rnn", p["rnn"]["fwd"]["cell"])
        bwd = p["rnn"]["bwd"]["cell"]
        sd[f"{prefix}.rnn.weight_ih_l0_reverse"] = t(bwd["w_ih"])
        sd[f"{prefix}.rnn.weight_hh_l0_reverse"] = t(bwd["w_hh"])
        sd[f"{prefix}.rnn.bias_ih_l0_reverse"] = f32(bwd["b_ih"])
        sd[f"{prefix}.rnn.bias_hh_l0_reverse"] = f32(bwd["b_hh"])

    enc = params["encoder"]
    sd["encoder.embedding.weight"] = f32(enc["embedding"]["embedding"])
    prenet("encoder.pre_net", enc["pre_net"])
    cbhg("encoder.cbhg", enc["cbhg"], batch_stats["encoder"]["cbhg"])
    _linear(sd, "encoder_proj", params["encoder_proj"])

    dec = params["decoder"]
    prenet("decoder.prenet", dec["prenet"])
    _gru(sd, "decoder.attn_rnn", dec["attn_rnn"], cell=True)
    sd["decoder.attn_net.conv.weight"] = conv1d(
        dec["attn_net"]["conv"]["kernel"])
    _linear(sd, "decoder.attn_net.L", dec["attn_net"]["L"])
    _linear(sd, "decoder.attn_net.W", dec["attn_net"]["W"])
    _linear(sd, "decoder.attn_net.v", dec["attn_net"]["v"])
    _linear(sd, "decoder.rnn_input", dec["rnn_input"])
    _gru(sd, "decoder.res_rnn1", dec["res_rnn1"], cell=True)
    _gru(sd, "decoder.res_rnn2", dec["res_rnn2"], cell=True)
    _linear(sd, "decoder.mel_proj", dec["mel_proj"])

    cbhg("postnet", params["postnet"], batch_stats["postnet"])
    _linear(sd, "post_proj", params["post_proj"])

    sd["decoder.r"] = np.asarray(r, dtype=np.int32)
    sd["step"] = np.asarray([step], dtype=np.int64)
    sd["stop_threshold"] = np.asarray(stop_threshold, dtype=np.float32)
    return sd


def main(argv=None):
    """Export; returns the written path."""
    import torch

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.training.tacotron import r_for_step
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    parser = argparse.ArgumentParser(
        description="export msgpack weights as a reference .pyt state dict")
    parser.add_argument("model", choices=["wavernn", "tacotron"])
    parser.add_argument("src", help="*_weights.msgpack of either package")
    parser.add_argument("dst", help="output .pyt torch state dict")
    parser.add_argument("--hp_file", default="hparams.py")
    parser.add_argument("--r", type=int, default=None,
                        help="Tacotron r buffer; default = the curriculum "
                             "value for the checkpoint's step")
    args = parser.parse_args(argv)

    hp.configure(args.hp_file)
    blob = load_pytree(args.src)
    params, stats = blob["params"], blob["batch_stats"]
    step = int(np.asarray(blob["step"]).reshape(-1)[0])

    if args.model == "wavernn":
        sd = export_wavernn(params, stats, step, hp.voc_upsample_factors)
    else:
        r = args.r if args.r is not None else r_for_step(step,
                                                         hp.tts_schedule)
        sd = export_tacotron(params, stats, step, r, hp.tts_stop_threshold)
        print(f"tacotron r buffer: {r}")

    # np.array(copy=True): contiguous, writable arrays for torch.from_numpy
    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    Path(args.dst).parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, args.dst)
    print(f"wrote {args.dst} ({len(out)} tensors, step={step})")
    return args.dst


if __name__ == "__main__":
    main()
