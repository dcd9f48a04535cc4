"""The decode kernel's sampling law against the analytic one and against
its plain version (ports ``tools/kernel_sampling_stats.py``).

All network weights are zero except the fc3 bias, so every step's logits
are a known constant and the samples are i.i.d. draws from a known law:
RAW, a softmax over 512 classes with a 24-class support; MOL, a mixture of
10 logistics.  That isolates the kernel's random bits, the bits-to-uniform
mapping, the Gumbel-argmax pick and the logistic draw from the network's
numerics.

    python -m wavernn_tpu_torch.tools.kernel_sampling_stats \\
        [--rows 16] [--steps 4096] [--device cuda|cpu]

The kernel draws with one seed, the plain version (``decode_reference``,
on the same device) with another.  Reported: total-variation distances of
the kernel's draws to the analytic law and to the plain version's, beside
the sampling noise floor sqrt(K / (2 pi N)) for K classes and N draws (an
upper bound on the expected TV of N draws to their law); MOL mean and std
errors.  The MOL selection is read from each sample's nearest mixture
mean, and its analytic law is that of the same nearest-mean cells, which
the logistics overlap.  ``--device cpu`` runs the plain version in place of
the kernel.  Prints one JSON line; ``ok`` is false if a TV exceeds 4x its
noise floor.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from wavernn_tpu_torch.tools import card, device_of

FEAT, AUX_D = 80, 8
N_RAW, SUPPORT, NM = 512, 24, 10
TV_LIMIT = 4.0     # a TV above this many noise floors fails


def const_logit_weights(H: int, F: int, feat: int, aux_d: int, n_out: int,
                        fc3_bias):
    """The port's ``DecodeWeights``: zeros, except the fc3 bias."""
    from wavernn_tpu_torch.ops.decode import DecodeWeights

    z = lambda *s: torch.zeros(s)
    return DecodeWeights(
        I_w=z(feat + aux_d + 1, H), I_b=z(H),
        gru1_w_ih=z(H, 3 * H), gru1_w_hh=z(H, 3 * H),
        gru1_b_ih=z(3 * H), gru1_b_hh=z(3 * H),
        gru2_w_ih=z(H + aux_d, 3 * H), gru2_w_hh=z(H, 3 * H),
        gru2_b_ih=z(3 * H), gru2_b_hh=z(3 * H),
        fc1_w=z(H + aux_d, F), fc1_b=z(F),
        fc2_w=z(F + aux_d, F), fc2_b=z(F),
        fc3_w=z(F, n_out),
        fc3_b=torch.as_tensor(np.asarray(fc3_bias, np.float32)))


def raw_law(seed: int = 0):
    """(logits, probs): 512 classes at -20 but a 24-class support with
    logits uniform in [0, 3), as the JAX tool builds them."""
    rng = np.random.default_rng(seed)
    logits = np.full(N_RAW, -20.0, np.float32)
    support = rng.choice(N_RAW, SUPPORT, replace=False)
    logits[support] = rng.uniform(0.0, 3.0, SUPPORT).astype(np.float32)
    probs = np.exp(logits.astype(np.float64) - logits.max())
    return logits, probs / probs.sum()


def mol_law():
    """(bias, mixture weights, means, scale): the JAX tool's mixture."""
    pi = np.full(NM, -8.0, np.float32)
    pi[:4] = np.log(np.array([0.4, 0.3, 0.2, 0.1], np.float32))
    mu = np.linspace(-0.6, 0.6, NM).astype(np.float32)
    log_s = np.full(NM, np.log(0.03), np.float32)
    pw = np.exp(pi.astype(np.float64) - pi.max())
    return np.concatenate([pi, mu, log_s]), pw / pw.sum(), mu, 0.03


def mol_moments(pw, mu, s):
    """Mean and std of the mixture (logistic variance (pi s)^2 / 3)."""
    mean = float((pw * mu).sum())
    var = float((pw * ((np.pi * s) ** 2 / 3 + mu.astype(np.float64) ** 2))
                .sum() - mean ** 2)
    return mean, math.sqrt(var)


def mol_cell_law(pw, mu, s):
    """Probability that a draw lands nearest to each mixture mean."""
    mu = mu.astype(np.float64)
    edges = np.concatenate([[-np.inf], (mu[1:] + mu[:-1]) / 2, [np.inf]])
    cdf = lambda x: 1.0 / (1.0 + np.exp(-(x[:, None] - mu[None, :]) / s))
    mass = cdf(edges[1:]) - cdf(edges[:-1])          # (cell, component)
    return mass @ pw


def raw_hist(x: np.ndarray) -> np.ndarray:
    cls = np.rint((x + 1) * (N_RAW - 1) / 2).astype(int)
    return np.bincount(cls, minlength=N_RAW) / cls.size


def mol_cells(x: np.ndarray, mu: np.ndarray) -> np.ndarray:
    sel = np.argmin(np.abs(x[:, None] - mu[None, :]), axis=1)
    return np.bincount(sel, minlength=NM) / x.size


def tv_distance(p, q) -> float:
    return 0.5 * float(np.abs(np.asarray(p) - np.asarray(q)).sum())


def noise_floor(k: int, n: int) -> float:
    return math.sqrt(k / (2 * math.pi * n))


def draw(bias, mode: str, B: int, T: int, seed: int, dev, H: int, F: int,
         plain: bool) -> np.ndarray:
    """B * T samples of the sampling decode with const-logit weights over a
    zero conditioning: the kernel (``cuda_decode.decode``; its plain
    version for CPU tensors), or with ``plain`` the plain version."""
    from wavernn_tpu_torch.ops import cuda_decode

    n_out = len(bias)
    packed = cuda_decode.pack_weights(
        const_logit_weights(H, F, FEAT, AUX_D, n_out, bias), FEAT, AUX_D)
    packed = {k: (v.to(dev) if v is not None else None)
              for k, v in packed.items()}
    cond = torch.zeros(B, T, FEAT + 4 * AUX_D, dtype=torch.bfloat16,
                       device=dev)
    fn = cuda_decode.decode_reference if plain else cuda_decode.decode
    out = fn(packed, cond, T, seed, mode, n_out, False)
    return out.cpu().numpy().ravel().astype(np.float64)


def sampling_stats(B: int, T: int, dev, H: int = 128, F: int = 128) -> dict:
    N = B * T
    res = {}
    logits, probs = raw_law()
    hk = raw_hist(draw(logits, "RAW", B, T, 1, dev, H, F, plain=False))
    hp = raw_hist(draw(logits, "RAW", B, T, 2, dev, H, F, plain=True))
    res["raw_tv_kernel_vs_analytic"] = tv_distance(hk, probs)
    res["raw_tv_plain_vs_analytic"] = tv_distance(hp, probs)
    res["raw_tv_kernel_vs_plain"] = tv_distance(hk, hp)
    res["raw_tv_expected_noise"] = noise_floor(SUPPORT, N)

    bias, pw, mu, s = mol_law()
    mean, std = mol_moments(pw, mu, s)
    cells = mol_cell_law(pw, mu, s)
    xk = draw(bias, "MOL", B, T, 3, dev, H, F, plain=False)
    xp = draw(bias, "MOL", B, T, 4, dev, H, F, plain=True)
    res["mol_mean_err_kernel"] = abs(xk.mean() - mean)
    res["mol_mean_err_plain"] = abs(xp.mean() - mean)
    res["mol_mean_expected_noise"] = std / math.sqrt(N)
    res["mol_std_err_kernel"] = abs(xk.std() - std)
    res["mol_std_err_plain"] = abs(xp.std() - std)
    res["mol_sel_tv_kernel_vs_analytic"] = tv_distance(mol_cells(xk, mu), cells)
    res["mol_sel_tv_plain_vs_analytic"] = tv_distance(mol_cells(xp, mu), cells)
    res["mol_sel_tv_kernel_vs_plain"] = tv_distance(mol_cells(xk, mu),
                                                    mol_cells(xp, mu))
    res["mol_sel_tv_expected_noise"] = noise_floor(NM, N)
    res = {k: float(v) for k, v in res.items()}
    res["ok"] = all(
        v <= TV_LIMIT * res[k.split("_tv_")[0] + "_tv_expected_noise"]
        for k, v in res.items() if "_tv_" in k and "noise" not in k)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    with torch.no_grad():
        res = sampling_stats(args.rows, args.steps, dev)
    rec = {"device": card(dev),
           "sampler": "kernel" if dev.type == "cuda" else "plain",
           "draws": args.rows * args.steps, **res}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
