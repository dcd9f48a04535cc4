"""Convert reference PyTorch checkpoints (``.pyt`` state dicts) into the
msgpack weights that both packages read (ports
``tools/convert_torch_checkpoint.py``).

    python -m wavernn_tpu_torch.tools.convert_torch_checkpoint wavernn \
        latest_weights.pyt out.msgpack [--hp_file hparams.py]
    python -m wavernn_tpu_torch.tools.convert_torch_checkpoint tacotron \
        latest_weights.pyt out.msgpack [--hp_file hparams.py]

Weight-layout mapping (torch -> here):
  * Linear:   weight (out,in)        -> kernel (in,out)^T
  * Conv1d:   weight (out,in,k)      -> kernel (k,in,out)
  * GRU/LSTM: weight_ih_l0 (G*H,in)  -> cell w_ih (in,G*H)^T   (gate order kept)
  * BatchNorm: weight/bias -> scale/bias; running stats -> batch_stats
  * Upsample Conv2d (1,1,1,k)        -> up{i}_kernel (k,)
The step buffer travels; Tacotron's r buffer is printed.

The state dict is read with ``torch.load(weights_only=True)``: tensors and
plain containers only, no pickled code.  The file is written with
``utils/checkpoints.py::save_pytree``, byte for byte what the JAX tool
writes with flax for the same ``.pyt``; its ``step`` is a 0-d int64 array,
as the JAX tool's ``np.asarray(step)`` gives it, and every loader of the
port reads either integer width.  The layout functions are numpy-only
copies of the JAX tool's.
"""

from __future__ import annotations

import argparse

import numpy as np


def t(x):
    return np.ascontiguousarray(np.asarray(x).T)


def conv1d(x):  # (out,in,k) -> (k,in,out)
    return np.ascontiguousarray(np.transpose(np.asarray(x), (2, 1, 0)))


def _bn(sd, prefix):
    params = {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }
    stats = {
        "mean": np.asarray(sd[f"{prefix}.running_mean"]),
        "var": np.asarray(sd[f"{prefix}.running_var"]),
    }
    return params, stats


def _gru(sd, prefix, cell=False):
    suffix = "" if cell else "_l0"
    return {
        "w_ih": t(sd[f"{prefix}.weight_ih{suffix}"]),
        "w_hh": t(sd[f"{prefix}.weight_hh{suffix}"]),
        "b_ih": np.asarray(sd[f"{prefix}.bias_ih{suffix}"]),
        "b_hh": np.asarray(sd[f"{prefix}.bias_hh{suffix}"]),
    }


def _linear(sd, prefix, bias=True):
    out = {"kernel": t(sd[f"{prefix}.weight"])}
    if bias:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def convert_wavernn(sd, res_blocks: int, upsample_factors):
    """Reference WaveRNN state dict → (params, batch_stats, step)."""
    params, stats = {}, {}

    resnet_p, resnet_s = {}, {}
    resnet_p["conv_in"] = {"kernel": conv1d(sd["upsample.resnet.conv_in.weight"])}
    resnet_p["bn"], resnet_s["bn"] = _bn(sd, "upsample.resnet.batch_norm")
    for i in range(res_blocks):
        blk_p, blk_s = {}, {}
        base = f"upsample.resnet.layers.{i}"
        blk_p["conv1"] = {"kernel": conv1d(sd[f"{base}.conv1.weight"])}
        blk_p["conv2"] = {"kernel": conv1d(sd[f"{base}.conv2.weight"])}
        blk_p["bn1"], blk_s["bn1"] = _bn(sd, f"{base}.batch_norm1")
        blk_p["bn2"], blk_s["bn2"] = _bn(sd, f"{base}.batch_norm2")
        resnet_p[f"block{i}"], resnet_s[f"block{i}"] = blk_p, blk_s
    resnet_p["conv_out"] = {
        "kernel": conv1d(sd["upsample.resnet.conv_out.weight"]),
        "bias": np.asarray(sd["upsample.resnet.conv_out.bias"]),
    }

    upsample_p = {"resnet": resnet_p}
    for i, _ in enumerate(upsample_factors):
        w = np.asarray(sd[f"upsample.up_layers.{2 * i + 1}.weight"])  # (1,1,1,k)
        upsample_p[f"up{i}_kernel"] = w.reshape(-1)

    params["upsample"] = upsample_p
    stats["upsample"] = {"resnet": resnet_s}
    params["I"] = _linear(sd, "I")
    params["rnn1"] = {"cell": _gru(sd, "rnn1")}
    params["rnn2"] = {"cell": _gru(sd, "rnn2")}
    for fc in ("fc1", "fc2", "fc3"):
        params[fc] = _linear(sd, fc)

    step = int(np.asarray(sd.get("step", np.zeros(1))).reshape(-1)[0])
    return params, stats, step


def convert_tacotron(sd, encoder_K: int, postnet_K: int, num_highways: int):
    """Reference Tacotron state dict → (params, batch_stats, step, r)."""
    params, stats = {}, {}

    def prenet(prefix):
        return {"fc1": _linear(sd, f"{prefix}.fc1"),
                "fc2": _linear(sd, f"{prefix}.fc2")}

    def cbhg(prefix, K, nh):
        p, s = {}, {}
        for k in range(1, K + 1):
            name = f"bank{k}"
            p[name] = {"conv": {"kernel": conv1d(sd[f"{prefix}.conv1d_bank.{k - 1}.conv.weight"])}}
            bn_p, bn_s = _bn(sd, f"{prefix}.conv1d_bank.{k - 1}.bnorm")
            p[name]["bnorm"], s[name] = bn_p, {"bnorm": bn_s}
        for proj in ("conv_project1", "conv_project2"):
            p[proj] = {"conv": {"kernel": conv1d(sd[f"{prefix}.{proj}.conv.weight"])}}
            bn_p, bn_s = _bn(sd, f"{prefix}.{proj}.bnorm")
            p[proj]["bnorm"], s[proj] = bn_p, {"bnorm": bn_s}
        if f"{prefix}.pre_highway.weight" in sd:
            p["pre_highway"] = _linear(sd, f"{prefix}.pre_highway", bias=False)
        for i in range(nh):
            p[f"highway{i}"] = {
                "W1": _linear(sd, f"{prefix}.highways.{i}.W1"),
                "W2": _linear(sd, f"{prefix}.highways.{i}.W2"),
            }
        p["rnn"] = {
            "fwd": {"cell": _gru(sd, f"{prefix}.rnn")},
            "bwd": {"cell": {
                "w_ih": t(sd[f"{prefix}.rnn.weight_ih_l0_reverse"]),
                "w_hh": t(sd[f"{prefix}.rnn.weight_hh_l0_reverse"]),
                "b_ih": np.asarray(sd[f"{prefix}.rnn.bias_ih_l0_reverse"]),
                "b_hh": np.asarray(sd[f"{prefix}.rnn.bias_hh_l0_reverse"]),
            }},
        }
        return p, s

    enc_cbhg_p, enc_cbhg_s = cbhg("encoder.cbhg", encoder_K, num_highways)
    params["encoder"] = {
        "embedding": {"embedding": np.asarray(sd["encoder.embedding.weight"])},
        "pre_net": prenet("encoder.pre_net"),
        "cbhg": enc_cbhg_p,
    }
    stats["encoder"] = {"cbhg": enc_cbhg_s}

    params["encoder_proj"] = _linear(sd, "encoder_proj", bias=False)

    dec = {
        "prenet": prenet("decoder.prenet"),
        "attn_rnn": _gru(sd, "decoder.attn_rnn", cell=True),
        "attn_net": {
            "conv": {"kernel": conv1d(sd["decoder.attn_net.conv.weight"])},
            "L": _linear(sd, "decoder.attn_net.L"),
            "W": _linear(sd, "decoder.attn_net.W"),
            "v": _linear(sd, "decoder.attn_net.v", bias=False),
        },
        "rnn_input": _linear(sd, "decoder.rnn_input"),
        "res_rnn1": _gru(sd, "decoder.res_rnn1", cell=True),
        "res_rnn2": _gru(sd, "decoder.res_rnn2", cell=True),
        "mel_proj": _linear(sd, "decoder.mel_proj", bias=False),
    }
    params["decoder"] = dec

    post_p, post_s = cbhg("postnet", postnet_K, num_highways)
    params["postnet"] = post_p
    stats["postnet"] = post_s
    params["post_proj"] = _linear(sd, "post_proj", bias=False)

    step = int(np.asarray(sd.get("step", np.zeros(1))).reshape(-1)[0])
    r = int(np.asarray(sd.get("decoder.r", sd.get("r", np.ones(1)))).reshape(-1)[0])
    return params, stats, step, r


def main(argv=None):
    """Convert; returns the written path."""
    import torch

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.utils.checkpoints import save_pytree

    parser = argparse.ArgumentParser(
        description="convert a reference .pyt state dict to msgpack weights")
    parser.add_argument("model", choices=["wavernn", "tacotron"])
    parser.add_argument("src")
    parser.add_argument("dst")
    parser.add_argument("--hp_file", default="hparams.py")
    args = parser.parse_args(argv)

    hp.configure(args.hp_file)
    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}

    if args.model == "wavernn":
        params, stats, step = convert_wavernn(
            sd, hp.voc_res_blocks, hp.voc_upsample_factors
        )
    else:
        params, stats, step, r = convert_tacotron(
            sd, hp.tts_encoder_K, hp.tts_postnet_K, hp.tts_num_highways
        )
        print(f"tacotron r buffer: {r}")

    blob = {"params": params, "batch_stats": stats, "step": np.asarray(step)}
    save_pytree(blob, args.dst)
    print(f"wrote {args.dst} (step={step})")
    return args.dst


if __name__ == "__main__":
    main()
