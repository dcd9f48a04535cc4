"""Tacotron (text -> mel) in PyTorch: the generation graph and the
teacher-forced training graph.

Ports ``wavernn_tpu/models/tacotron.py``: a CBHG encoder over character
embeddings, an autoregressive decoder step (prenet -> attention GRU ->
location-sensitive or additive attention -> two residual LSTMs -> r mel
frames) and a CBHG postnet with a linear projection.  Public functions keep
the JAX package's channel-last (B, T, C) layout; the convolutions run
channel-first inside.

Generation (``encode``, ``decode_step``, ``postnet_forward`` with their
defaults) runs in eval mode: BatchNorm with the running statistics, no
dropout, no zoneout, the CBHG BiGRUs as step loops.  The teacher-forced
pass (:meth:`Tacotron.forward`) with ``train=True`` is the JAX model's
train mode: BatchNorm with the batch statistics, updating the running ones
as flax does (``models.wavernn.FlaxBatchNorm``), prenet dropout with
explicit keep-masks scaled by ``1 / keep``, zoneout on both residual
LSTMs' hidden states, and the CBHG BiGRUs as one fused recurrent call.
The decoder's masks are drawn in one pass before the step loop
(:func:`draw_decoder_masks`), or given, which is how the tests feed the
JAX model's masks to the port.

The module tree mirrors the flax parameter tree name for name, and every
matrix stays in flax's math layout (in, out), so :func:`from_jax_variables`,
:func:`to_jax_variables` and :func:`load_jax_variables` map a checkpoint
leaf for leaf; only convolutions change layout, to PyTorch's (out, in, K).
:func:`init_variables` makes a seeded flax-layout tree with the shapes and
init laws of flax's ``model.init``, for full-width runs on machines
without JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavernn_tpu_torch.models.wavernn import FlaxBatchNorm
from wavernn_tpu_torch.ops.rnn import BiGRU, GRUWeights, gru_cell_step, lstm_cell_step
from wavernn_tpu_torch.parallel.tensor_parallel import (
    full_parameters, local_tensors, own_parameter_names,
)

MAX_R = 20  # mel_proj holds MAX_R frame slots; a step uses the first r
ZONEOUT_P = 0.1  # the residual LSTMs keep their previous h with this chance


@dataclass(frozen=True)
class TacotronConfig:
    """The model's shape.  The JAX config's XLA scan knobs
    (``decoder_remat``, ``decoder_unroll``) have no counterpart here."""

    embed_dims: int = 256
    num_chars: int = 148
    encoder_dims: int = 128
    decoder_dims: int = 256
    n_mels: int = 80
    fft_bins: int = 80
    postnet_dims: int = 128
    encoder_K: int = 16
    lstm_dims: int = 512
    postnet_K: int = 8
    num_highways: int = 4
    dropout: float = 0.5
    stop_threshold: float = -3.4
    attn_mode: str = "lsa"  # 'lsa' (location-sensitive) | 'additive'

    @classmethod
    def from_hp(cls, hp, num_chars: int) -> "TacotronConfig":
        return cls(
            embed_dims=hp.tts_embed_dims,
            num_chars=num_chars,
            encoder_dims=hp.tts_encoder_dims,
            decoder_dims=hp.tts_decoder_dims,
            attn_mode=hp.get("tts_attn_mode", "lsa"),
            n_mels=hp.num_mels,
            fft_bins=hp.num_mels,
            postnet_dims=hp.tts_postnet_dims,
            encoder_K=hp.tts_encoder_K,
            lstm_dims=hp.tts_lstm_dims,
            postnet_K=hp.tts_postnet_K,
            num_highways=hp.tts_num_highways,
            dropout=hp.tts_dropout,
            stop_threshold=hp.tts_stop_threshold,
        )


class Dense(nn.Module):
    """x @ kernel (+ bias), kernel in the math layout (in, out)."""

    def __init__(self, in_dims: int, out_dims: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dims, out_dims))
        self.bias = nn.Parameter(torch.zeros(out_dims)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class HighwayNetwork(nn.Module):
    """g * relu(W1 x) + (1 - g) * x with g = sigmoid(W2 x)."""

    def __init__(self, size: int):
        super().__init__()
        self.W1 = Dense(size, size)
        self.W2 = Dense(size, size)

    def forward(self, x):
        g = torch.sigmoid(self.W2(x))
        return g * F.relu(self.W1(x)) + (1.0 - g) * x


class BatchNormConv(nn.Module):
    """Conv1d without bias -> optional relu -> batch norm, on (B, T, C).
    Even kernels pad k//2 on both sides and crop the right overhang.  The
    norm is flax's (momentum 0.9): ``train`` normalizes with the batch
    statistics and updates the running ones."""

    def __init__(self, in_dims: int, out_dims: int, kernel: int,
                 relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = nn.Conv1d(in_dims, out_dims, kernel, padding=kernel // 2,
                              bias=False)
        self.bnorm = FlaxBatchNorm(out_dims)

    def forward(self, x, train: bool = False):
        T = x.shape[1]
        y = self.conv(x.transpose(1, 2))[:, :, :T]
        if self.relu:
            y = F.relu(y)
        return self.bnorm(y, train).transpose(1, 2)


def keep_mask(shape, keep: float, device, generator=None) -> torch.Tensor:
    """A bool mask, True with probability ``keep``, drawn from
    ``generator`` (torch's default generator of ``device`` when None)."""
    return torch.rand(shape, generator=generator, device=device) < keep


class PreNet(nn.Module):
    """Two relu FC layers, each followed by dropout in train mode: a value
    is kept with probability ``keep = 1 - dropout`` and scaled by
    ``1 / keep`` (flax's ``nn.Dropout``).  ``masks`` gives the two
    keep-masks; without them they are drawn from ``generator``."""

    def __init__(self, in_dims: int, fc1_dims: int, fc2_dims: int,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Dense(in_dims, fc1_dims)
        self.fc2 = Dense(fc1_dims, fc2_dims)

    def _drop(self, x, mask, generator):
        keep = 1.0 - self.dropout
        if mask is None:
            if self.dropout == 0.0:           # flax's Dropout(0) is the identity
                return x
            mask = keep_mask(x.shape, keep, x.device, generator)
        return torch.where(mask, x / keep, 0.0)

    def forward(self, x, train: bool = False, masks=None, generator=None):
        m1, m2 = masks if masks is not None else (None, None)
        x = F.relu(self.fc1(x))
        if train:
            x = self._drop(x, m1, generator)
        x = F.relu(self.fc2(x))
        if train:
            x = self._drop(x, m2, generator)
        return x


class CBHG(nn.Module):
    """Conv bank (kernels 1..K) -> max pool -> two projections + residual ->
    highways -> BiGRU, on (B, T, in_dims) -> (B, T, 2 * channels)."""

    def __init__(self, K: int, in_dims: int, channels: int,
                 proj_channels: Tuple[int, int], num_highways: int):
        super().__init__()
        self.K = K
        self.num_highways = num_highways
        for k in range(1, K + 1):
            self.add_module(f"bank{k}", BatchNormConv(in_dims, channels, k))
        self.conv_project1 = BatchNormConv(K * channels, proj_channels[0], 3)
        self.conv_project2 = BatchNormConv(proj_channels[0], proj_channels[1],
                                           3, relu=False)
        self.pre_highway = (Dense(proj_channels[1], channels, use_bias=False)
                            if proj_channels[-1] != channels else None)
        for i in range(num_highways):
            self.add_module(f"highway{i}", HighwayNetwork(channels))
        self.rnn = BiGRU(channels, channels)

    def forward(self, x, train: bool = False):
        """In train mode the norms take the batch statistics and the BiGRU
        runs fused."""
        residual = x
        T = x.shape[1]
        bank = torch.cat([getattr(self, f"bank{k}")(x, train)
                          for k in range(1, self.K + 1)], dim=-1)
        # max pool k=2 stride 1, padded with -inf on the left
        shifted = F.pad(bank, (0, 0, 1, 0), value=float("-inf"))[:, :T]
        y = self.conv_project1(torch.maximum(bank, shifted), train)
        y = self.conv_project2(y, train) + residual
        if self.pre_highway is not None:
            y = self.pre_highway(y)
        for i in range(self.num_highways):
            y = getattr(self, f"highway{i}")(y)
        return self.rnn(y, fused=train)


class Encoder(nn.Module):
    """Character embedding -> prenet -> CBHG."""

    def __init__(self, c: TacotronConfig):
        super().__init__()
        self.embedding = nn.Embedding(c.num_chars, c.embed_dims)
        self.pre_net = PreNet(c.embed_dims, 2 * c.encoder_dims, c.encoder_dims,
                              c.dropout)
        self.cbhg = CBHG(c.encoder_K, c.encoder_dims, c.encoder_dims,
                         (c.encoder_dims, c.encoder_dims), c.num_highways)

    def forward(self, x, train: bool = False, masks=None, generator=None):
        e = self.pre_net(self.embedding(x), train, masks, generator)
        return self.cbhg(e, train)


class LSA(nn.Module):
    """Location-sensitive attention with sigmoid-normalised ('smooth')
    scores.  Cumulative and previous attention come in with the carry."""

    def __init__(self, attn_dim: int, kernel_size: int = 31,
                 filters: int = 32):
        super().__init__()
        self.conv = nn.Conv1d(2, filters, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.L = Dense(filters, attn_dim)
        self.W = Dense(attn_dim, attn_dim)
        self.v = Dense(attn_dim, 1, use_bias=False)

    def forward(self, encoder_seq_proj, query, cumulative, attention_prev):
        loc = torch.stack([cumulative, attention_prev], dim=1)   # (B, 2, T)
        processed_loc = self.L(self.conv(loc).transpose(1, 2))   # (B, T, A)
        processed_query = self.W(query)[:, None]                 # (B, 1, A)
        u = self.v(torch.tanh(processed_query + encoder_seq_proj
                              + processed_loc))[..., 0]
        sig = torch.sigmoid(u)
        return sig / sig.sum(dim=1, keepdim=True)


class AdditiveAttention(nn.Module):
    """Bahdanau-style additive attention with softmax scores."""

    def __init__(self, attn_dim: int):
        super().__init__()
        self.W = Dense(attn_dim, attn_dim, use_bias=False)
        self.v = Dense(attn_dim, 1, use_bias=False)

    def forward(self, encoder_seq_proj, query, cumulative, attention_prev):
        processed_query = self.W(query)[:, None]
        u = self.v(torch.tanh(encoder_seq_proj + processed_query))[..., 0]
        return torch.softmax(u, dim=1)


class RawCell(nn.Module):
    """GRU (3 gates) or LSTM (4 gates) parameters in the math layout."""

    def __init__(self, in_dims: int, hidden: int, gates: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(in_dims, gates * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, gates * hidden))
        self.b_ih = nn.Parameter(torch.zeros(gates * hidden))
        self.b_hh = nn.Parameter(torch.zeros(gates * hidden))

    def weights(self):
        return self.w_ih, self.w_hh, self.b_ih, self.b_hh


class DecoderCell(nn.Module):
    """One decoder step: prenet -> attention GRU -> attention -> context ->
    rnn_input -> two residual LSTMs (zoneout in train mode) -> r mel
    frames."""

    def __init__(self, c: TacotronConfig):
        super().__init__()
        D, H = c.decoder_dims, c.lstm_dims
        self.n_mels = c.n_mels
        self.prenet = PreNet(c.n_mels, D, D // 2, c.dropout)
        self.attn_rnn = RawCell(D + D // 2, D, 3)
        self.attn_net = LSA(D) if c.attn_mode == "lsa" else AdditiveAttention(D)
        self.rnn_input = Dense(2 * D, H)
        self.res_rnn1 = RawCell(H, H, 4)
        self.res_rnn2 = RawCell(H, H, 4)
        self.mel_proj = Dense(H, c.n_mels * MAX_R, use_bias=False)

    def forward(self, carry, encoder_seq, encoder_seq_proj, prenet_in,
                r: int, masks=None, train: bool = False):
        """``masks``: this step's (prenet keep-mask x2, zoneout keep-prev
        mask x2), used in train mode only."""
        pm1, pm2, z1, z2 = masks if train else (None,) * 4
        p = self.prenet(prenet_in, train, (pm1, pm2))
        return self.after_prenet(carry, encoder_seq, encoder_seq_proj, p, r,
                                 (z1, z2) if train else None)

    def after_prenet(self, carry, encoder_seq, encoder_seq_proj, p, r: int,
                     zoneout=None):
        """The step from the prenet's output ``p`` on; ``zoneout`` (train
        mode) is the pair of keep-prev masks of the two residual LSTMs."""
        attn_h, r1_h, r1_c, r2_h, r2_c, context, cumulative, attn_prev = carry
        attn_h = gru_cell_step(torch.cat([context, p], dim=-1), attn_h,
                               *self.attn_rnn.weights())
        scores = self.attn_net(encoder_seq_proj, attn_h, cumulative, attn_prev)
        attn_prev = scores
        cumulative = cumulative + scores
        context = torch.einsum("bt,btc->bc", scores, encoder_seq)
        x = self.rnn_input(torch.cat([context, attn_h], dim=-1))
        r1_h_next, r1_c = lstm_cell_step(x, r1_h, r1_c,
                                         *self.res_rnn1.weights())
        r1_h = (r1_h_next if zoneout is None
                else torch.where(zoneout[0], r1_h, r1_h_next))
        x = x + r1_h
        r2_h_next, r2_c = lstm_cell_step(x, r2_h, r2_c,
                                         *self.res_rnn2.weights())
        r2_h = (r2_h_next if zoneout is None
                else torch.where(zoneout[1], r2_h, r2_h_next))
        x = x + r2_h
        # the first r of the MAX_R frame slots: (H, n_mels, r)
        w_r = self.mel_proj.kernel.view(x.shape[-1], self.n_mels, MAX_R)[:, :, :r]
        mels = torch.einsum("bl,lmr->bmr", x, w_r)
        carry = (attn_h, r1_h, r1_c, r2_h, r2_c, context, cumulative, attn_prev)
        return carry, (mels, scores)


class Tacotron(nn.Module):
    """The teacher-forced graph (:meth:`forward`) and the generation
    blocks :meth:`encode`, :meth:`decode_step` and :meth:`postnet_forward`
    that ``infer/tacotron.py`` composes."""

    def __init__(self, cfg: TacotronConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.encoder = Encoder(c)
        self.encoder_proj = Dense(2 * c.encoder_dims, c.decoder_dims,
                                  use_bias=False)
        self.decoder = DecoderCell(c)
        self.postnet = CBHG(c.postnet_K, c.n_mels, c.postnet_dims,
                            (256, c.n_mels), c.num_highways)
        self.post_proj = Dense(2 * c.postnet_dims, c.fft_bins, use_bias=False)

    def encode(self, x: torch.Tensor, train: bool = False, masks=None,
               generator=None):
        """(B, L) symbol ids -> (encoder_seq (B, L, 2*enc), its projection
        (B, L, decoder_dims)).  ``masks``: the prenet's two keep-masks in
        train mode, else drawn from ``generator``."""
        enc = self.encoder(x, train, masks, generator)
        return enc, self.encoder_proj(enc)

    def decode_step(self, carry, encoder_seq, encoder_seq_proj, prenet_in,
                    r: int):
        """One free-running step; prenet_in (B, n_mels).  Returns the new
        carry and (mels (B, n_mels, r), scores (B, L))."""
        return self.decoder(carry, encoder_seq, encoder_seq_proj, prenet_in, r)

    def postnet_forward(self, mel_outputs: torch.Tensor,
                        train: bool = False) -> torch.Tensor:
        """(B, T, n_mels) -> (B, T, fft_bins)."""
        return self.post_proj(self.postnet(mel_outputs, train))

    def forward(self, x: torch.Tensor, m: torch.Tensor, r: int,
                train: bool = True, generate_gta: bool = False, masks=None,
                generator: Optional[torch.Generator] = None,
                encoder_masks=None):
        """The teacher-forced pass (``wavernn_tpu/models/tacotron.py:
        434-478``).  x: (B, L) symbol ids; m: (B, T, n_mels) target mels,
        T a multiple of r.  Returns (mel_outputs (B, T, n_mels), linear
        (B, T, fft_bins), attn_scores (B, T/r, L)).

        The prenet's inputs are the GO frame, then the last frame of each
        r-group.  In train mode the decoder's four masks
        (:func:`draw_decoder_masks`, each (T/r, B, .)) are ``masks`` when
        given, else drawn from ``generator`` in one pass before the step
        loop; the encoder prenet's two keep-masks are ``encoder_masks``, or
        drawn from ``generator`` too.  ``masks`` of four Nones, with both
        prenets' ``dropout`` at 0, runs train mode with neither dropout nor
        zoneout.  ``generate_gta`` forces eval mode."""
        if generate_gta:
            train = False
        c = self.cfg
        B, steps = m.shape[0], m.shape[1]
        if steps % r:
            raise ValueError(f"mel length {steps} is not a multiple of r={r}")
        T_dec = steps // r

        encoder_seq, encoder_seq_proj = self.encode(x, train, encoder_masks,
                                                    generator)
        go = m.new_zeros(1, B, c.n_mels)
        prenet_seq = torch.cat([go, m[:, r - 1:steps - 1:r].transpose(0, 1)])
        if train and masks is None:
            masks = draw_decoder_masks(c, T_dec, B, m.device, generator)
        pm1, pm2, z1, z2 = masks if train else (None,) * 4
        # the teacher-forced prenet inputs are known up front: one prenet
        # pass over all T/r steps instead of one a step
        prenet_out = self.decoder.prenet(prenet_seq, train, (pm1, pm2))

        carry = init_decoder_carry(c, B, x.shape[1], m.device, m.dtype)
        mels, scores = [], []
        for t in range(T_dec):
            carry, (mel, score) = self.decoder.after_prenet(
                carry, encoder_seq, encoder_seq_proj, prenet_out[t], r,
                None if z1 is None else (z1[t], z2[t]))
            mels.append(mel)
            scores.append(score)
        # (T/r, B, n_mels, r) -> (B, T, n_mels)
        mel_outputs = torch.stack(mels).permute(1, 0, 3, 2).reshape(
            B, steps, c.n_mels)
        attn_scores = torch.stack(scores, dim=1)
        linear = self.postnet_forward(mel_outputs, train)
        return mel_outputs, linear, attn_scores


def draw_decoder_masks(cfg: TacotronConfig, T_dec: int, B: int, device,
                       generator: Optional[torch.Generator] = None):
    """The decoder's train-mode masks for T_dec steps, drawn in one pass
    as the JAX model draws them: the prenet's two keep-masks (T_dec, B,
    decoder_dims) and (T_dec, B, decoder_dims // 2), kept with probability
    ``1 - dropout``, and the two residual LSTMs' zoneout masks (T_dec, B,
    lstm_dims), True (keep the previous h) with probability
    :data:`ZONEOUT_P`."""
    keep = 1.0 - cfg.dropout
    D, H = cfg.decoder_dims, cfg.lstm_dims
    draw = lambda p, width: keep_mask((T_dec, B, width), p, device, generator)
    return (draw(keep, D), draw(keep, D // 2), draw(ZONEOUT_P, H),
            draw(ZONEOUT_P, H))


def draw_train_masks(cfg: TacotronConfig, B: int, L: int, T_dec: int,
                     device, generator: Optional[torch.Generator] = None):
    """Every train-mode mask of a :meth:`Tacotron.forward` over B
    utterances of L symbols and T_dec decoder steps, drawn from
    ``generator`` in the order the forward draws them: the encoder
    prenet's two keep-masks ((B, L, 2 * encoder_dims), (B, L,
    encoder_dims); none when dropout is 0, as flax's ``Dropout(0)`` draws
    none), then :func:`draw_decoder_masks`.  Returns ``(encoder_masks,
    masks)`` for the forward's ``encoder_masks`` and ``masks``: a forward
    given them equals one that draws them itself from the same generator.
    A data-parallel step draws the global batch's and takes its rows."""
    E = cfg.encoder_dims
    encoder_masks = None
    if cfg.dropout != 0.0:
        keep = 1.0 - cfg.dropout
        encoder_masks = tuple(keep_mask((B, L, w), keep, device, generator)
                              for w in (2 * E, E))
    return encoder_masks, draw_decoder_masks(cfg, T_dec, B, device,
                                             generator)


def init_decoder_carry(cfg: TacotronConfig, B: int, T_enc: int, device=None,
                       dtype=None):
    """The zero decoder carry: attention hidden, (h, c) of both LSTMs,
    context, cumulative and previous attention."""
    z = lambda *s: torch.zeros(*s, device=device, dtype=dtype)
    return (z(B, cfg.decoder_dims),
            z(B, cfg.lstm_dims), z(B, cfg.lstm_dims),
            z(B, cfg.lstm_dims), z(B, cfg.lstm_dims),
            z(B, cfg.decoder_dims),
            z(B, T_enc), z(B, T_enc))


# -- the flax tree ----------------------------------------------------------

def _conv_to_torch(a):
    # (K, in, out) <-> (out, in, K): the same transpose both ways
    return np.transpose(a, (2, 1, 0))


def _leaves(model: nn.Module) -> Iterator[tuple]:
    """(collection, flax path, plain key, module, flax-to-torch map) for
    every leaf of the flax tree of ``model``; each map is its own inverse.
    The key is the state-dict key of an unsharded model (a parameter
    sharded over the model axis keeps it: ``parallel.tensor_parallel``)."""
    same = lambda a: a
    for name, m in model.named_modules():
        if "parametrizations" in name.split("."):
            continue
        path = tuple(name.split(".")) if name else ()
        key = lambda p: f"{name}.{p}" if name else p
        if isinstance(m, nn.Conv1d):
            yield "params", path + ("kernel",), key("weight"), m, _conv_to_torch
        elif isinstance(m, nn.BatchNorm1d):
            yield "params", path + ("scale",), key("weight"), m, same
            yield "params", path + ("bias",), key("bias"), m, same
            yield "batch_stats", path + ("mean",), key("running_mean"), m, same
            yield "batch_stats", path + ("var",), key("running_var"), m, same
        elif isinstance(m, nn.Embedding):
            yield "params", path + ("embedding",), key("weight"), m, same
        else:
            for p in own_parameter_names(m):
                yield "params", path + (p,), key(p), m, same


def param_layout(model: nn.Module) -> List[Tuple[str, Tuple[str, ...], str]]:
    """Every parameter as (torch name, flax path under ``params``, move),
    as ``models.wavernn.param_layout`` gives the vocoder's: ``conv`` for
    conv kernels, ``copy`` for the rest (the math layout is flax's)."""
    return [(key, path, "conv" if move is _conv_to_torch else "copy")
            for coll, path, key, _, move in _leaves(model)
            if coll == "params"]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_jax_tree(tensors: Mapping[str, torch.Tensor], model: Tacotron) -> dict:
    """A dict of per-parameter tensors keyed by torch name (the parameters,
    or an optimizer moment of each) -> the flax ``params`` pytree of
    float32 numpy arrays."""
    tree: dict = {}
    for coll, path, key, _, move in _leaves(model):
        if coll == "params":
            a = tensors[key].detach().to("cpu", torch.float32).numpy()
            _set(tree, path, np.ascontiguousarray(move(a)))
    return tree


def from_jax_tree(tree, model: Tacotron) -> Dict[str, np.ndarray]:
    """The inverse of :func:`to_jax_tree`: torch name -> float32 array."""
    return {key: np.ascontiguousarray(move(np.asarray(_get(tree, path),
                                                      np.float32)))
            for coll, path, key, _, move in _leaves(model)
            if coll == "params"}


def to_jax_variables(model: Tacotron) -> dict:
    """The JAX-layout numpy pytree ``{"params", "batch_stats"}`` of a port
    model (the inverse of :func:`load_jax_variables`), for a checkpoint,
    a ``TTSGenerator`` or the JAX package."""
    sd = {**model.state_dict(), **full_parameters(model)}
    tree: dict = {"params": {}, "batch_stats": {}}
    for coll, path, key, _, move in _leaves(model):
        a = sd[key].detach().to("cpu", torch.float32).numpy()
        _set(tree[coll], path, np.ascontiguousarray(move(a)))
    return tree


def load_jax_variables(model: Tacotron, variables) -> None:
    """Copy the JAX package's numpy pytree ``{"params", "batch_stats"}``
    (as ``utils.checkpoints.load_pytree`` reads it) into ``model`` in
    place, on the model's device.  Every leaf keeps its layout except conv
    kernels, (K, in, out) -> (out, in, K); BatchNorm scale/bias and
    mean/var become weight/bias and the running statistics.  Raises on a
    missing or misshapen leaf."""
    sd = {}
    for coll, path, key, _, move in _leaves(model):
        sd[key] = torch.tensor(move(np.asarray(_get(variables[coll], path),
                                               np.float32)))
    for name, buf in model.named_buffers():
        if name.endswith("num_batches_tracked"):
            sd[name] = buf
    model.load_state_dict(local_tensors(sd, model), strict=True)


def from_jax_variables(variables, cfg: TacotronConfig, device) -> Tacotron:
    """Build a :class:`Tacotron` in eval mode on ``device`` from the JAX
    package's numpy pytree ``{"params", "batch_stats"}``
    (:func:`load_jax_variables`; flax's BatchNorm epsilon, 1e-5, is the
    port's)."""
    model = Tacotron(cfg)
    load_jax_variables(model, variables)
    return model.to(device).eval()


def init_variables(cfg: TacotronConfig, seed: int) -> dict:
    """A flax-layout numpy tree ``{"params", "batch_stats"}`` with the
    shapes and init laws of the JAX model's ``init``: xavier-uniform
    kernels (conv fans include the kernel width), zero biases, GRU/LSTM
    cell biases uniform in +-1/sqrt(hidden), the BiGRU cells' weights too,
    BatchNorm scale 1, bias 0, mean 0, var 1.  Values come from
    ``np.random.default_rng(seed)``; they are not flax's numbers."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}

    def xavier(shape, fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, shape)

    model = Tacotron(cfg)
    for coll, path, key, m, _ in _leaves(model):
        p = path[-1]
        if isinstance(m, nn.Conv1d):
            out_c, in_c, k = m.weight.shape
            v = xavier((k, in_c, out_c), k * in_c, k * out_c)
        elif isinstance(m, nn.BatchNorm1d):
            v = (np.ones if p in ("scale", "var") else np.zeros)(m.num_features)
        elif isinstance(m, nn.Embedding):
            v = xavier(tuple(m.weight.shape), *m.weight.shape)
        else:
            shape = tuple(dict(m.named_parameters(recurse=False))[p].shape)
            if isinstance(m, GRUWeights) or (isinstance(m, RawCell)
                                             and p.startswith("b")):
                bound = 1.0 / np.sqrt(m.w_hh.shape[0])
                v = rng.uniform(-bound, bound, shape)
            elif p == "bias":
                v = np.zeros(shape)
            else:
                v = xavier(shape, *shape)
        node = tree[coll]
        for k_ in path[:-1]:
            node = node.setdefault(k_, {})
        node[p] = np.asarray(v, np.float32)
    return tree
