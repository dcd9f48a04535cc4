"""The port's DeepMind dual-softmax WaveRNN and its NB1 example against the
JAX package's (``wavernn_tpu/models/deepmind_wavernn.py``,
``examples/nb1_sine_wave.py``), on the CPU at hidden 64.

The same numpy-seeded inputs and weights (a seeded port model, converted
to the flax tree) go through both packages, float32 on both sides, within
1e-5: the port's ``cell`` against JAX's ``cell``; the fused ``forward`` (one
GRU call) against the plain cell loop and against JAX's ``__call__``; the
logits the port's generator computes along its own sampled path against
JAX's teacher-forced forward on that path; one NB1 step (loss and Adam
update) against optax.  The generator draws by another random stream than
JAX's, so its draws are held by distribution: the first coarse classes of
4,096 rows against the softmax of JAX's logits, within 4x the TV noise
floor."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavernn_tpu.models.deepmind_wavernn import DeepMindWaveRNN as JaxModel
from wavernn_tpu.models.deepmind_wavernn import (
    DeepMindWaveRNNConfig as JaxConfig,
)
from wavernn_tpu.models.deepmind_wavernn import generate as jax_generate
from wavernn_tpu_torch.examples import nb1_sine_wave
from wavernn_tpu_torch.models import deepmind_wavernn as dm
from wavernn_tpu_torch.tools.kernel_sampling_stats import (
    noise_floor, tv_distance,
)
from wavernn_tpu_torch.training.state import Adam
from tests.torch_cpu import one_torch_thread  # noqa: F401

HS, B, T = 64, 2, 50
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    cfg = dm.DeepMindWaveRNNConfig(hidden_size=HS)
    model = dm.DeepMindWaveRNN(cfg, torch.Generator().manual_seed(0))
    return model, dm.to_jax_variables(model), JaxModel(JaxConfig(HS))


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, T, 2)).astype(np.float32),
            rng.uniform(-1, 1, (B, T, 1)).astype(np.float32))


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    d = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert d <= tol, d


def test_parameters_keep_the_jax_names_shapes_and_init(models):
    model, v, jm = models
    py, ct = inputs()
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(py), jnp.asarray(ct))
    want = {k: np.asarray(x) for k, x in jv["params"].items()}
    assert {k: x.shape for k, x in v["params"].items()} == {
        k: x.shape for k, x in want.items()}
    bound = 1.0 / HS ** 0.5
    for k, x in v["params"].items():
        assert x.dtype == np.float32 and np.abs(x).max() <= bound, k
        if x.size >= 1000:   # U(-b, b): std b / sqrt(3)
            assert abs(x.std() / (bound / 3 ** 0.5) - 1) < 0.1, k
    back = dm.from_jax_variables(v, model.cfg, "cpu")
    for k, x in dm.to_jax_variables(back)["params"].items():
        np.testing.assert_array_equal(x, v["params"][k])
    broken = {"params": {k: x for k, x in v["params"].items() if k != "R"}}
    with pytest.raises(KeyError, match="R"):
        dm.from_jax_variables(broken, model.cfg, "cpu")


def test_cell_matches_jax(models):
    model, v, jm = models
    py, ct = inputs()
    h = np.random.default_rng(1).uniform(-1, 1, (B, HS)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(py[:, 0]), jnp.asarray(ct[:, 0]),
                    jnp.asarray(h), method=JaxModel.cell)
    with torch.no_grad():
        got = model.cell(torch.from_numpy(py[:, 0]),
                         torch.from_numpy(ct[:, 0]), torch.from_numpy(h))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w)


def test_fused_forward_matches_cell_loop_and_jax(models):
    model, v, jm = models
    py, ct = inputs()
    want = jm.apply(v, jnp.asarray(py), jnp.asarray(ct))
    with torch.no_grad():
        fused = model(torch.from_numpy(py), torch.from_numpy(ct))
        plain = model.forward_reference(torch.from_numpy(py),
                                        torch.from_numpy(ct))
    for f, p, w in zip(fused, plain, want):
        assert f.shape == p.shape == w.shape == (B, T, 256)
        close(f, p)
        close(f, w)


def test_fused_forward_gradients_match_cell_loop(models):
    """The GRU weights are built from the parameters per call, so the
    gradients of the fused forward reach every parameter."""
    model, _, _ = models
    py, ct = (torch.from_numpy(a) for a in inputs(2))
    grads = []
    for fwd in (model.forward, model.forward_reference):
        model.zero_grad()
        oc, of = fwd(py, ct)
        (oc.square().mean() + of.sin().mean()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    model.zero_grad()
    for n, g in grads[0].items():
        close(g, grads[1][n])
        assert float(g.abs().max()) > 0, n


def test_generate_shape_and_range_as_jax(models):
    model, v, jm = models
    want = jax_generate(jm, v, seq_len=T, key=jax.random.PRNGKey(1))
    got = dm.generate(model, T, torch.Generator().manual_seed(1))
    assert got.shape == want.shape == (T,)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got).max() <= 1.0 and np.abs(want).max() <= 1.0
    assert np.all(got * 2 ** 15 == np.round(got * 2 ** 15))
    again = dm.generate(model, T, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got, again)


def test_logits_along_the_sampled_path_match_jax(models):
    model, v, jm = models
    kc, kf, oc, of = dm._draw(model, T, torch.Generator().manual_seed(3),
                              batch=B)
    assert kc.shape == kf.shape == (B, T) and oc.shape == (B, T, 256)
    prev = torch.stack([dm.scaled(kc), dm.scaled(kf)], dim=-1)
    prev_y = torch.cat([torch.zeros(B, 1, 2), prev[:, :-1]], dim=1)
    want = jm.apply(v, jnp.asarray(prev_y.numpy()),
                    jnp.asarray(dm.scaled(kc)[..., None].numpy()))
    close(oc, want[0])
    close(of, want[1])


def test_first_draws_follow_the_softmax_of_jax_logits(models):
    """4,096 rows from the zero state: the coarse classes' histogram
    against softmax of JAX's first coarse logits, made peaked by a
    seeded output bias so that the law is far from uniform."""
    model, v, jm = models
    rng = np.random.default_rng(4)
    sharp = {**v["params"], "b_O2": (rng.normal(0, 2.5, 256)).astype(
        np.float32)}
    model_s = dm.from_jax_variables({"params": sharp}, model.cfg, "cpu")
    n = 4096
    kc, _, oc, _ = dm._draw(model_s, 1, torch.Generator().manual_seed(5),
                            batch=n)
    want, _ = jm.apply({"params": sharp}, jnp.zeros((1, 1, 2)),
                       jnp.zeros((1, 1, 1)))
    close(oc[0, 0], want[0, 0])
    z = np.asarray(want[0, 0], np.float64)
    p = np.exp(z - z.max()) / np.exp(z - z.max()).sum()
    hist = np.bincount(kc[:, 0].numpy(), minlength=256) / n
    tv, floor = tv_distance(hist, p), noise_floor(256, n)
    assert tv <= 4 * floor, (tv, floor)
    # a uniform draw would fail the same bound
    assert tv_distance(np.full(256, 1 / 256), p) > 4 * floor


def test_nb1_step_matches_optax(models):
    model, v, jm = models
    py, ct, tc, tf = nb1_sine_wave.sine_batch(400)
    assert py.shape == (1, 399, 2) and tc.shape == (1, 399)

    def loss_fn(p):
        oc, of = jm.apply({"params": p}, jnp.asarray(py), jnp.asarray(ct))
        return (optax.softmax_cross_entropy_with_integer_labels(
                    oc, jnp.asarray(tc, jnp.int32)).mean()
                + optax.softmax_cross_entropy_with_integer_labels(
                    of, jnp.asarray(tf, jnp.int32)).mean())

    opt = optax.adam(1e-3)

    @jax.jit
    def step(params, state):   # the JAX example's step
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, loss

    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = opt.init(params)
    want_losses = []
    for _ in range(2):
        params, state, loss = step(params, state)
        want_losses.append(float(loss))

    port = dm.from_jax_variables(v, model.cfg, "cpu")
    adam = Adam(1e-3)
    adam_state = adam.init(port)
    batch = [torch.from_numpy(a) for a in (py, ct, tc, tf)]
    got_losses = [float(nb1_sine_wave.train_step(port, adam, adam_state,
                                                 batch)) for _ in range(2)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=TOL)
    got = dm.to_jax_variables(port)["params"]
    for k, w in params.items():
        close(got[k], w)


def test_nb1_main_runs_on_cpu(tmp_path, capsys):
    from wavernn_tpu_torch.dsp import wavio

    out = tmp_path / "nb1.wav"
    res = nb1_sine_wave.main(["--steps", "2", "--sample_rate", "400",
                              "--device", "cpu", "--out", str(out)])
    assert res["path"] == out and f"wrote {out}" in capsys.readouterr().out
    assert res["losses"].shape == (2,) and np.isfinite(res["losses"]).all()
    x, sr = wavio.read_wav_raw(out)
    assert sr == 400 and x.shape == (400,) and res["wav"].shape == (400,)


def test_nb1_fails_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        nb1_sine_wave.main(["--steps", "1", "--sample_rate", "400"])
