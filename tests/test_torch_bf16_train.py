"""Reduced-precision GRU matmuls (``compute_dtype="bfloat16"``) in the
port, against the JAX package on the CPU: the cells, the sequence GRU
and one train step with both of the trainer's JAX options on
(``seq_chunks`` and ``compute_dtype``).

JAX's ``_dot`` rounds both operands to bf16 and gives a float32 result;
a bf16 x bf16 product is exact in float32, so a cell's outputs differ
from JAX's only in the order of float32 sums (within 1e-6).  Its
transpose multiplies the float32 cotangent by the other, rounded,
operand in float32 and rounds that product to bf16, so both gradients
through the matmul are bf16 values; the port's (``ops.rnn.low_dot``) are
too, equal to JAX's but where the two float32 sums lie on either side of
a rounding boundary (one bf16 step).  Over a sequence a state element
whose float32 value differs in its last bit may round to the other bf16
neighbour at the next step's matmul, a change of one bf16 step in one
operand that the recurrence carries on: the sequences and the train step
are held in relative L2, with the bounds stated at each test.
"""

import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_seq_chunks import setup
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models import wavernn as jax_wavernn
from wavernn_tpu.ops import rnn as jax_rnn
from wavernn_tpu.training.state import new_train_state as jax_state
from wavernn_tpu.training.wavernn import make_train_step as jax_train_step
from wavernn_tpu_torch.models.wavernn import (
    GRUCell, gru_sequence, to_jax_tree,
)
from wavernn_tpu_torch.ops import rnn
from wavernn_tpu_torch.training.state import Adam, new_train_state
from wavernn_tpu_torch.training.wavernn import make_train_step

BF16 = "bfloat16"


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def is_bf16(a) -> bool:
    t = torch.tensor(np.asarray(a, np.float32))
    return torch.equal(t, t.bfloat16().float())


def bf16_steps(a, b) -> np.ndarray:
    """|a - b| in units of b's bf16 step (2^-7 of its binade)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    binade = 2.0 ** np.floor(np.log2(np.maximum(np.abs(b), 1e-30)))
    return np.abs(a - b) / (binade * 2.0 ** -7)


def cell_inputs(kind, B=5, I=24, H=32, seed=0):
    rng = np.random.default_rng(seed)
    G = 3 * H if kind == "gru" else 4 * H
    a = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(
        np.float32)
    state = (a(B, H, scale=0.5),) if kind == "gru" else (
        a(B, H, scale=0.5), a(B, H, scale=0.5))
    return ((a(B, I),) + state + (a(I, G, scale=0.2), a(H, G, scale=0.2),
                                  a(G, scale=0.1), a(G, scale=0.1)),
            rng.standard_normal((B, H)).astype(np.float32))


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_bf16_cell_steps_match_jax(kind):
    """Outputs within 1e-6.  The gradients that come only through a
    matmul (x, w_ih, w_hh; the LSTM's h) are bf16 values in both
    packages, at least 99% of their elements equal to JAX's and the rest
    one bf16 step away; the others (the biases, c, the GRU's h, which
    adds the float32 z * h path) within 1e-6."""
    args, cot = cell_inputs(kind)
    jfn = jax_rnn.gru_cell_step if kind == "gru" else jax_rnn.lstm_cell_step
    tfn = rnn.gru_cell_step if kind == "gru" else rnn.lstm_cell_step

    def jloss(*a):
        out = jfn(*a, compute_dtype=BF16)
        out = out if kind == "gru" else out[0] + 0.5 * out[1]
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))), has_aux=True)(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    tout = tfn(*ts, compute_dtype=BF16)
    tout = tout if kind == "gru" else tout[0] + 0.5 * tout[1]
    (tout * torch.from_numpy(cot)).sum().backward()
    assert np.abs(tout.detach().numpy() - np.asarray(jout)).max() <= 1e-6
    through_matmul = [0, 2, 3] if kind == "gru" else [0, 1, 3, 4]
    for i, (t, g) in enumerate(zip(ts, jgrads)):
        g, tg = np.asarray(g), t.grad.numpy()
        if i in through_matmul:
            assert is_bf16(g) and is_bf16(tg), i
            steps = bf16_steps(tg, g)
            assert steps.max() <= 1.0 + 1e-6, i
            assert np.mean(steps == 0) >= 0.99, i
        else:
            assert np.abs(tg - g).max() <= 1e-6, i


@pytest.mark.parametrize("where", ["ops.rnn.GRU", "gru_sequence"])
def test_bf16_gru_sequence_matches_jax(where):
    """The sequence GRU with ``compute_dtype="bfloat16"`` (the hoisted
    bf16 input projection, then the recurrence with a float32 state) over
    40 steps against JAX's ``GRU(compute_dtype="bfloat16")``: outputs
    within 1e-3 relative L2, the gradients of the input and every weight
    within 5e-3 (a rounding flip of the state, as above, measured 3e-5 on
    the outputs and 3e-4 on the gradients at one seed of three, 1e-6 at
    the other two); the gradients of x and w_ih bf16 values."""
    B, T, I, H = 3, 40, 24, 32
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((B, T, I)).astype(np.float32)
    cot = rng.standard_normal((B, T, H)).astype(np.float32)
    jmod = jax_rnn.GRU(H, compute_dtype=BF16)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs))["params"]

    def jloss(p, x):
        ys, _ = jmod.apply({"params": p}, x)
        return jnp.sum(ys * cot), ys

    (_, jys), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(xs))
    jc = {k: np.array(a) for k, a in params["cell"].items()}
    x = torch.from_numpy(xs).requires_grad_()
    if where == "ops.rnn.GRU":
        mod = rnn.GRU(I, H, compute_dtype=BF16)
        with torch.no_grad():
            for k, a in jc.items():
                getattr(mod.cell, k).copy_(torch.from_numpy(a))
        ys, h = mod(x)
        assert torch.equal(h, ys[:, -1])
        params_t = {k: getattr(mod.cell, k) for k in jc}
    else:
        cell = GRUCell(I, H)
        params_t = {"w_ih": cell.weight_ih, "w_hh": cell.weight_hh,
                    "b_ih": cell.bias_ih, "b_hh": cell.bias_hh}
        with torch.no_grad():
            for k, p in params_t.items():
                p.copy_(torch.from_numpy(jc[k]).T if p.ndim == 2
                        else torch.from_numpy(jc[k]))
        ys = gru_sequence(cell, x, BF16)
    (ys * torch.from_numpy(cot)).sum().backward()
    grads = {k: p.grad.T if where == "gru_sequence" and p.ndim == 2
             else p.grad for k, p in params_t.items()}
    assert rel_l2(ys.detach(), jys) <= 1e-3
    assert rel_l2(x.grad, jgx) <= 5e-3
    for k, g in grads.items():
        assert rel_l2(g, jg["cell"][k]) <= 5e-3, k
    # x and w_ih meet only in the hoisted projection: one bf16-operand
    # product, whose two gradients are bf16 values in both packages
    for g in (x.grad, grads["w_ih"], jgx, jg["cell"]["w_ih"]):
        assert is_bf16(g)


class KeepGrads(Adam):
    """The port's clipped Adam, keeping the gradients it was given."""

    def step(self, model, state):
        self.grads = {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()}
        return super().step(model, state)


def keep_grads(inner: optax.GradientTransformation):
    """``inner`` with the gradients it was given put beside its state."""

    def init(params):
        return (jax.tree_util.tree_map(jnp.zeros_like, params),
                inner.init(params))

    def update(grads, state, params=None):
        updates, s = inner.update(grads, state[1], params)
        return updates, (grads, s)

    return optax.GradientTransformation(init, update)


def pin_relus(monkeypatch, model, batch):
    """Record the ReLU masks of the port's train-mode forward of ``model``
    (a copy, so that its BatchNorm statistics stay) on ``batch``, then
    make every ReLU of both packages apply those masks in call order (the
    resnet's, channel-first in the port and channel-last in JAX, then
    fc1's and fc2's, time-major in JAX): both backward passes then take
    the same branches."""
    masks, relu = [], F.relu

    def record(x, inplace=False):
        masks.append(x > 0)
        return relu(x)

    monkeypatch.setattr(F, "relu", record)
    with torch.no_grad():
        copy.deepcopy(model)(torch.from_numpy(batch[0]),
                             torch.from_numpy(batch[2]))
    n = len(masks)
    port_masks = iter(masks)
    monkeypatch.setattr(F, "relu", lambda x, inplace=False:
                        x * next(port_masks).to(x))
    jax_masks = iter([np.swapaxes(m.numpy(), *((1, 2) if i < n - 2
                                               else (0, 1)))
                      .astype(np.float32) for i, m in enumerate(masks)])
    monkeypatch.setattr(flax_nn, "relu", lambda x: x * next(jax_masks))
    return n


def test_chunked_bf16_train_step_matches_jax(monkeypatch):
    """One train step with ``seq_chunks=4, chunk_warmup=10`` and
    ``compute_dtype="bfloat16"`` through each package's
    ``make_train_step`` (RAW, clipped Adam, the JAX step's gradients kept
    beside its optimizer state), with the ReLU masks pinned
    (:func:`pin_relus`): a ReLU input within ~1e-4 of zero, where a
    flipped bf16 rounding of the state moves it, switches a whole
    position's branch and moved every gradient by ~2% at one seed of
    three.  Pinned: the loss within 1e-5 relative, the grad norm within
    1e-4, every gradient within 1e-2 relative L2 and all together within
    2e-4 (measured at most 2.1e-3 and 9.8e-5 over three seeds; gradients
    left unrounded through the bf16 matmuls are 2.8e-4 to 3.1e-4 from
    JAX's all together, and JAX's own bf16 gradients 8e-3 to 3e-2 from
    its float32 ones)."""
    lr, clip = 1e-3, 4.0
    jcfg, v, model, batch = setup("RAW", seq_chunks=4, chunk_warmup=10,
                                  compute_dtype=BF16)
    assert model.cfg.chunks(batch[0].shape[1])
    assert pin_relus(monkeypatch, model, batch) == 4
    opt_j = optax.chain(optax.clip_by_global_norm(clip),
                        keep_grads(optax.adam(lr)))
    step_j = jax_train_step(jax_wavernn.WaveRNN(jcfg), opt_j, "RAW",
                            donate=False)
    state_j, loss_j, gn_j = step_j(
        jax_state(v["params"], v["batch_stats"], opt_j),
        *map(jnp.asarray, batch))
    grads_j = state_j.opt_state[1][0]
    opt_t = KeepGrads(lr, clip)
    _, loss_t, gn_t = make_train_step(opt_t, "RAW")(
        new_train_state(model, opt_t), *batch)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * float(loss_j)
    assert abs(float(gn_t) - float(gn_j)) <= 1e-4 * float(gn_j)
    lj = jax.tree_util.tree_leaves_with_path(grads_j)
    lt = jax.tree_util.tree_leaves_with_path(
        to_jax_tree(opt_t.grads, model.cfg))
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, gj), (_, gt) in zip(lj, lt):
        assert rel_l2(gt, gj) <= 1e-2, (path, rel_l2(gt, gj))
    flat = lambda leaves: np.concatenate(
        [np.ravel(np.asarray(a)) for _, a in leaves])
    assert rel_l2(flat(lt), flat(lj)) <= 2e-4
