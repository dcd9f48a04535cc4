"""The Tacotron decoder step loop at batch 1: weight packing, the carried
state, and the plain PyTorch version of the CUDA kernel
(``ops/csrc/tts_decode.cu``, wrapped by ``ops/cuda_tts.py``).

Ports the math of ``wavernn_tpu/ops/pallas_tts.py`` without its TPU layout:
no 128-lane padding of ``n_mels``, the prenet or the text axis, no
per-frame mel lane blocks, no ``n_steps % 8`` rule.  Every packed matrix is
stored (out, in), as ``nn.Linear`` stores it, so that the kernel reads each
output's weights contiguously.

One step, where ``@`` is a dot of ``dtype`` operands (activations rounded
to ``dtype``) whose exact products are summed in float64 and rounded once
to float32, and ``sg(v) = 0.5 * tanh(0.5 * v) + 0.5``:

    p1  = relu(prev_mel @ p1_w + p1_b);  p2 = relu(p1 @ p2_w + p2_b)
    gi  = [context | p2] @ [wih_c | wih_p] + b_attn;  gh = h_attn @ whh
    h_attn = gru(gi, gh)                   (b_attn_hn scaled by the reset gate)
    ploc[l] = M_loc @ [cum | prv](l-15 .. l+15)  (conv folded with L; zero
                                                  outside the text)
    u[l] = v @ tanh(((ploc[l] + encp[l]) + h_attn @ W_q) + b_q)
    scores = sg(u) / f32(f64 sum of sg(u));  cum += scores;  prv = scores
    context = scores @ enc
    x   = [context | h_attn] @ [ri_c | ri_h] + ri_b
    h1, c1 = lstm([x | h1] @ [l1_ih | l1_hh] + l1_b);  x = x + h1
    h2, c2 = lstm([x | h2] @ [l2_ih | l2_hh] + l2_b);  x = x + h2
    mels = x @ mel_w   (r frames of n_mels);  prev_mel = the last frame
    stop_max = max(mels)

With ``int8_lstm`` (the TPU kernel's variant of that name) the four LSTM
matrices are int8 with per-output scales ``*_s``, and each LSTM's operands
``x`` and ``h`` are quantized on the fly, each at its own scale: ``sa =
max(max|a|, 1e-8) * (1/127)``, ``qa = round(a / sa)`` (a true division,
half to even); the gates are ``(ldot(x, ih) + ldot(h, hh)) + b`` with
``ldot(a, w) = f32(exact int sum) * (sa * s_w)``.

A float64 sum of exact products hardly depends on the order of its terms,
so the kernel, which sums in another order, agrees with this version to
the bit nearly always; the sigmoid is written through tanh for the same
reason (``torch.tanh`` on the card and the kernel's ``tanhf`` are the same
function).  The gate arithmetic is float32, one rounding per operation.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

KTAPS = 31                 # the location conv's width
PAD = (KTAPS - 1) // 2


@dataclass
class TTSDecodeWeights:
    """The decoder's weights in the flax math layout (in, out), as float32
    tensors: what ``pallas_tts.extract_tts_decode_weights`` reads."""

    prenet_fc1_w: torch.Tensor   # (n_mels, D)
    prenet_fc1_b: torch.Tensor
    prenet_fc2_w: torch.Tensor   # (D, D//2)
    prenet_fc2_b: torch.Tensor
    attn_w_ih: torch.Tensor      # (D + D//2, 3D)
    attn_w_hh: torch.Tensor      # (D, 3D)
    attn_b_ih: torch.Tensor
    attn_b_hh: torch.Tensor
    conv_w: torch.Tensor         # (31, 2, F), flax layout
    L_w: torch.Tensor            # (F, D)
    L_b: torch.Tensor
    W_w: torch.Tensor            # (D, D)
    W_b: torch.Tensor
    v_w: torch.Tensor            # (D, 1)
    rnn_in_w: torch.Tensor       # (2D, H)
    rnn_in_b: torch.Tensor
    lstm1_w_ih: torch.Tensor     # (H, 4H)
    lstm1_w_hh: torch.Tensor
    lstm1_b_ih: torch.Tensor
    lstm1_b_hh: torch.Tensor
    lstm2_w_ih: torch.Tensor
    lstm2_w_hh: torch.Tensor
    lstm2_b_ih: torch.Tensor
    lstm2_b_hh: torch.Tensor
    mel_w: torch.Tensor          # (H, n_mels * MAX_R)


def extract_tts_decode_weights(model) -> TTSDecodeWeights:
    """The decoder weights of a port ``Tacotron`` (LSA attention)."""
    d = model.decoder
    a = d.attn_net
    t = lambda p: p.detach().float()
    return TTSDecodeWeights(
        prenet_fc1_w=t(d.prenet.fc1.kernel), prenet_fc1_b=t(d.prenet.fc1.bias),
        prenet_fc2_w=t(d.prenet.fc2.kernel), prenet_fc2_b=t(d.prenet.fc2.bias),
        attn_w_ih=t(d.attn_rnn.w_ih), attn_w_hh=t(d.attn_rnn.w_hh),
        attn_b_ih=t(d.attn_rnn.b_ih), attn_b_hh=t(d.attn_rnn.b_hh),
        conv_w=t(a.conv.weight).permute(2, 1, 0),
        L_w=t(a.L.kernel), L_b=t(a.L.bias),
        W_w=t(a.W.kernel), W_b=t(a.W.bias), v_w=t(a.v.kernel),
        rnn_in_w=t(d.rnn_input.kernel), rnn_in_b=t(d.rnn_input.bias),
        lstm1_w_ih=t(d.res_rnn1.w_ih), lstm1_w_hh=t(d.res_rnn1.w_hh),
        lstm1_b_ih=t(d.res_rnn1.b_ih), lstm1_b_hh=t(d.res_rnn1.b_hh),
        lstm2_w_ih=t(d.res_rnn2.w_ih), lstm2_w_hh=t(d.res_rnn2.w_hh),
        lstm2_b_ih=t(d.res_rnn2.b_ih), lstm2_b_hh=t(d.res_rnn2.b_hh),
        mel_w=t(d.mel_proj.kernel),
    )


# the matrices of the packed set, all (out, in) in the weight dtype (the
# LSTM ones int8 with int8_lstm)
MATRICES = ("p1_w", "p2_w", "wih_c", "wih_p", "whh", "M_loc", "W_q", "v",
            "ri_c", "ri_h", "l1_ih", "l1_hh", "l2_ih", "l2_hh", "mel_w")
LSTM_MATRICES = ("l1_ih", "l1_hh", "l2_ih", "l2_hh")
VECTORS = ("p1_b", "p2_b", "b_attn", "b_attn_hn", "b_q", "ri_b", "l1_b",
           "l2_b")
# int8_lstm: each LSTM matrix's per-output scales, float32 (4H,)
LSTM_SCALES = tuple(k + "_s" for k in LSTM_MATRICES)


def pack_tts_weights(w: TTSDecodeWeights, r: int, n_mels: int,
                     dtype=torch.bfloat16, int8_lstm: bool = False) -> dict:
    """The kernel's weight set: matrices (out, in) in ``dtype``, biases
    float32.  As ``pallas_tts.pack_tts_weights``: the attention GRU's
    biases packed as b_ih + b_hh for the reset and update gates and b_ih
    for n (``b_attn_hn`` = the hidden-side n bias); the location conv
    folded with L into one (D, 62) matrix, taps [cumulative | previous];
    ``b_q = L_b + W_b``; each LSTM's two biases summed; the mel kernel cut
    to its first r frame slots, rows ordered frame-major.

    ``int8_lstm`` stores the four LSTM matrices as int8 with per-output
    symmetric scales (``pallas_tts.pack_tts_weights``' q8 per column of
    the (in, out) matrix), the scales as ``l1_ih_s`` ... ``l2_hh_s``; the
    other matrices stay in ``dtype``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    f32 = lambda a: a.float().contiguous()
    mat = lambda a: a.float().T.to(dtype).contiguous()    # (in, out) -> (out, in)
    D = w.attn_w_hh.shape[0]
    H = w.lstm1_w_hh.shape[0]
    max_r = w.mel_w.shape[1] // n_mels
    if not 1 <= r <= max_r:
        raise ValueError(f"r={r} outside 1..{max_r}")

    conv = w.conv_w.float()                              # (31, 2, F)
    Lw = w.L_w.float()                                   # (F, D)
    M_loc = torch.cat([torch.einsum("tf,fd->dt", conv[:, 0], Lw),
                       torch.einsum("tf,fd->dt", conv[:, 1], Lw)], dim=1)
    mel = w.mel_w.float().reshape(H, n_mels, max_r)[:, :, :r]
    mel = mel.permute(0, 2, 1).reshape(H, r * n_mels)    # column j*n_mels + m

    def q8(a):
        """(in, out) -> int8 (out, in) and its (out,) scales."""
        a = a.float()
        m = a.abs().amax(dim=0)
        sc = torch.where(m > 0, m, torch.ones_like(m)) / 127.0
        return (torch.round(a / sc).to(torch.int8).T.contiguous(),
                sc.contiguous())

    lstm = dict(l1_ih=mat(w.lstm1_w_ih), l1_hh=mat(w.lstm1_w_hh),
                l2_ih=mat(w.lstm2_w_ih), l2_hh=mat(w.lstm2_w_hh))
    if int8_lstm:
        for name, a in (("l1_ih", w.lstm1_w_ih), ("l1_hh", w.lstm1_w_hh),
                        ("l2_ih", w.lstm2_w_ih), ("l2_hh", w.lstm2_w_hh)):
            lstm[name], lstm[name + "_s"] = q8(a)

    b_ih, b_hh = w.attn_b_ih.float(), w.attn_b_hh.float()
    return dict(
        p1_w=mat(w.prenet_fc1_w), p1_b=f32(w.prenet_fc1_b),
        p2_w=mat(w.prenet_fc2_w), p2_b=f32(w.prenet_fc2_b),
        wih_c=mat(w.attn_w_ih[:D]), wih_p=mat(w.attn_w_ih[D:]),
        whh=mat(w.attn_w_hh),
        b_attn=f32(torch.cat([b_ih[:2 * D] + b_hh[:2 * D], b_ih[2 * D:]])),
        b_attn_hn=f32(b_hh[2 * D:]),
        M_loc=M_loc.to(dtype).contiguous(),              # (D, 62)
        W_q=mat(w.W_w), b_q=f32(w.L_b + w.W_b),
        v=mat(w.v_w),                                    # (1, D)
        ri_c=mat(w.rnn_in_w[:D]), ri_h=mat(w.rnn_in_w[D:]),
        ri_b=f32(w.rnn_in_b),
        l1_b=f32(w.lstm1_b_ih + w.lstm1_b_hh),
        l2_b=f32(w.lstm2_b_ih + w.lstm2_b_hh),
        mel_w=mat(mel),                                  # (r * n_mels, H)
        **lstm,
    )


def is_int8_lstm(packed: dict) -> bool:
    """Whether a packed set is ``int8_lstm``'s (its marker: the LSTM
    scales)."""
    return packed.get("l1_ih_s") is not None


def packed_dims(packed: dict):
    """(D, Dh, H, n_mels, r) of a packed weight set."""
    D = packed["whh"].shape[1]
    Dh = packed["p2_w"].shape[0]
    H = packed["l1_hh"].shape[1]
    n_mels = packed["p1_w"].shape[1]
    r = packed["mel_w"].shape[0] // n_mels
    return D, Dh, H, n_mels, r


@dataclass
class TTSDecodeState:
    """The decoder state carried between launches, float32 vectors."""

    prev_mel: torch.Tensor   # (n_mels,)
    h_attn: torch.Tensor     # (D,)
    h1: torch.Tensor         # (H,)
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor
    context: torch.Tensor    # (D,)
    cum: torch.Tensor        # (L,)
    prv: torch.Tensor        # (L,)


STATE_FIELDS = tuple(f.name for f in fields(TTSDecodeState))


def init_tts_decode_state(D: int, H: int, L: int, n_mels: int,
                          device=None) -> TTSDecodeState:
    z = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    return TTSDecodeState(prev_mel=z(n_mels), h_attn=z(D), h1=z(H), c1=z(H),
                          h2=z(H), c2=z(H), context=z(D), cum=z(L), prv=z(L))


def sg(v: torch.Tensor) -> torch.Tensor:
    """The sigmoid as the kernel computes it."""
    return 0.5 * torch.tanh(0.5 * v) + 0.5


def location_windows(cum: torch.Tensor, prv: torch.Tensor) -> torch.Tensor:
    """(L, 62) conv windows: row l holds cum[l-15 .. l+15] then
    prv[l-15 .. l+15], zero outside [0, L)."""
    L = cum.shape[0]
    pc = torch.nn.functional.pad(cum, (PAD, PAD))
    pp = torch.nn.functional.pad(prv, (PAD, PAD))
    idx = torch.arange(L, device=cum.device)[:, None] + torch.arange(
        KTAPS, device=cum.device)[None, :]
    return torch.cat([pc[idx], pp[idx]], dim=1)


def check_inputs(packed: dict, enc: torch.Tensor, encp: torch.Tensor,
                 state: TTSDecodeState, n_steps: int):
    """Shapes of the packed set, the encoder outputs and the state."""
    D, Dh, H, n_mels, r = packed_dims(packed)
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if enc.dim() != 2 or enc.shape[1] != D or encp.shape != enc.shape:
        raise ValueError(f"enc and encp must both be (L, {D}), got "
                         f"{tuple(enc.shape)} and {tuple(encp.shape)}")
    L = enc.shape[0]
    want = dict(prev_mel=n_mels, h_attn=D, h1=H, c1=H, h2=H, c2=H,
                context=D, cum=L, prv=L)
    for name, n in want.items():
        t = getattr(state, name)
        if tuple(t.shape) != (n,) or t.dtype != torch.float32:
            raise ValueError(f"state.{name}: want float32 ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    return D, Dh, H, n_mels, r, L


def tts_decode_reference(packed: dict, enc: torch.Tensor, encp: torch.Tensor,
                         state: TTSDecodeState, n_steps: int):
    """Plain PyTorch version of the kernel: ``n_steps`` decoder steps from
    ``state`` over encoder outputs ``enc``/``encp`` (L, D) float32.

    Returns (mels (n_steps, r, n_mels), scores (n_steps, L), stop_max
    (n_steps,), new state).  The operand dtype is the packed matrices'
    dtype (float32 or bfloat16); an ``int8_lstm`` set quantizes the LSTM
    operands as the module's docstring says (float32 scales, exact integer
    sums: |sum| <= 127 * 127 * H < 2**24)."""
    D, Dh, H, n_mels, r, L = check_inputs(packed, enc, encp, state, n_steps)
    dtype = packed["whh"].dtype
    int8_lstm = is_int8_lstm(packed)
    rd = lambda a: a.to(dtype).double()                  # round, then widen
    w64 = {k: packed[k].double() for k in MATRICES}
    f = {k: packed[k].float() for k in VECTORS
         + (LSTM_SCALES if int8_lstm else ())}

    def mm(name, x):
        """f32(f64 dot of matrix ``name`` with the rounded operand x)."""
        return (w64[name] @ rd(x)).float()

    def mm2(n1, x1, n2, x2):
        """The same over two operand segments, one sum."""
        return (w64[n1] @ rd(x1) + w64[n2] @ rd(x2)).float()

    enc64 = rd(enc.float())                              # (L, D)
    encp = encp.float()
    s = TTSDecodeState(**{k: getattr(state, k).clone() for k in STATE_FIELDS})
    dev = enc.device
    mels_out = torch.empty(n_steps, r, n_mels, device=dev)
    scores_out = torch.empty(n_steps, L, device=dev)
    stop_out = torch.empty(n_steps, device=dev)
    for i in range(n_steps):
        p1 = torch.relu(mm("p1_w", s.prev_mel) + f["p1_b"])
        p2 = torch.relu(mm("p2_w", p1) + f["p2_b"])

        gi = mm2("wih_c", s.context, "wih_p", p2) + f["b_attn"]
        gh = mm("whh", s.h_attn)
        rg = sg(gi[:D] + gh[:D])
        zg = sg(gi[D:2 * D] + gh[D:2 * D])
        ng = torch.tanh(gi[2 * D:] + rg * (gh[2 * D:] + f["b_attn_hn"]))
        s.h_attn = (1.0 - zg) * ng + zg * s.h_attn

        win = rd(location_windows(s.cum, s.prv))         # (L, 62)
        ploc = (win @ w64["M_loc"].T).float()            # (L, D)
        pq = mm("W_q", s.h_attn)
        targ = torch.tanh(((ploc + encp) + pq) + f["b_q"])
        u = (rd(targ) @ w64["v"][0]).float()             # (L,)
        sig = sg(u)
        scores = sig / sig.double().sum().float()
        s.cum = s.cum + scores
        s.prv = scores
        s.context = (rd(scores) @ enc64).float()

        x = mm2("ri_c", s.context, "ri_h", s.h_attn) + f["ri_b"]

        def ldot(name, a):
            """int8_lstm: the operand quantized on the fly."""
            sa = torch.clamp(a.abs().amax(), min=1e-8) * (1.0 / 127.0)
            return ((w64[name] @ torch.round(a / sa).double()).float()
                    * (sa * f[name + "_s"]))

        def lstm(x, h, c, ih, hh, b):
            g = ((ldot(ih, x) + ldot(hh, h)) + f[b] if int8_lstm
                 else mm2(ih, x, hh, h) + f[b])
            ig, fg = sg(g[:H]), sg(g[H:2 * H])
            gg, og = torch.tanh(g[2 * H:3 * H]), sg(g[3 * H:])
            c = fg * c + ig * gg
            return og * torch.tanh(c), c

        s.h1, s.c1 = lstm(x, s.h1, s.c1, "l1_ih", "l1_hh", "l1_b")
        x = x + s.h1
        s.h2, s.c2 = lstm(x, s.h2, s.c2, "l2_ih", "l2_hh", "l2_b")
        x = x + s.h2

        mels = mm("mel_w", x).view(r, n_mels)
        s.prev_mel = mels[-1].clone()
        mels_out[i] = mels
        scores_out[i] = scores
        stop_out[i] = mels.max()
    return mels_out, scores_out, stop_out, s
