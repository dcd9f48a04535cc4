"""The port's Tacotron train step, checkpoints and NaN guard against the
JAX package's, float32 on the CPU at the tiny sizes (helpers from
``tests/test_torch_tts_training.py``).

* Three clipped Adam steps (clip 0.5, ``dropout=0``) against JAX's
  ``make_tts_train_step``: JAX draws its zoneout masks from the step's key
  at the model's root scope; the same draw through ``model.apply(...,
  method=draw)`` hands the port the same masks.  Losses and grad norms
  within 1e-5 relative, at least 99.5% of parameter elements within 1e-6
  and all within 6 * lr + 1e-6 (an Adam step moves a weight by about lr
  at most, whichever way a gradient of rounding size points).
* A non-finite step cannot clobber the latest pair.

(Checkpoint pairs across the packages: ``test_torch_tts_training_grads.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tts_training import batch, jax_cfg, port_cfg, variables
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
from wavernn_tpu.training.state import make_optimizer as jax_optimizer
from wavernn_tpu.training.state import new_train_state as jax_state
from wavernn_tpu.training.tacotron import make_tts_train_step as jax_step
from wavernn_tpu_torch.models.tacotron import (
    from_jax_variables, to_jax_variables,
)
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.tacotron import (
    make_tts_train_step, tts_train_loop,
)

# the norms of these steps are 0.47, 0.62 and 0.60: hparams' clip of 1.0
# would never engage at this size, 0.5 takes both branches
R, LR, CLIP = 3, 1e-3, 0.5


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, variables, the compiled JAX step, a mask
    drawer: key -> the zoneout masks JAX's step draws from it)."""
    jcfg = jax_cfg(dropout=0.0)
    cfg = port_cfg(jcfg)
    v = variables(cfg, 3)
    model = JaxTacotron(jcfg)
    step = jax_step(model, jax_optimizer(LR, CLIP), R, donate=False)

    def draw(module, B, T_dec):
        # Tacotron.__call__'s draw: the root scope's first dropout key
        k1, k2, k3, k4 = jax.random.split(module.make_rng("dropout"), 4)
        D, H = jcfg.decoder_dims, jcfg.lstm_dims
        return (jax.random.bernoulli(k1, 1.0, (T_dec, B, D)),
                jax.random.bernoulli(k2, 1.0, (T_dec, B, D // 2)),
                jax.random.bernoulli(k3, 0.1, (T_dec, B, H)),
                jax.random.bernoulli(k4, 0.1, (T_dec, B, H)))

    def masks_of(key, B, T_dec):
        out = model.apply(v, B, T_dec, method=draw, rngs={"dropout": key})
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    return jcfg, cfg, v, step, masks_of


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_three_adam_steps_match_jax(setup):
    jcfg, cfg, v, step_j, masks_of = setup
    state_j = jax_state(v["params"], v["batch_stats"], jax_optimizer(LR, CLIP))
    model = from_jax_variables(v, cfg, "cpu")
    opt = make_optimizer(LR, CLIP)
    state = new_train_state(model, opt)
    step_t = make_tts_train_step(model, opt, R)
    clipped = 0
    for i in range(3):
        x, m = batch(cfg, 10 + i)
        key = jax.random.PRNGKey(20 + i)
        state_j, loss_j, gn_j, attn_j, _ = step_j(
            state_j, jnp.asarray(x), jnp.asarray(m), key)
        masks = masks_of(key, x.shape[0], m.shape[1] // R)
        assert float(masks[2].float().mean()) > 0     # zoneout engaged
        state, loss, gn, attn, m2 = step_t(state, x, m, masks=masks)
        assert abs(float(loss) - float(loss_j)) <= 1e-5 * float(loss_j)
        assert abs(float(gn) - float(gn_j)) <= 1e-5 * float(gn_j)
        np.testing.assert_allclose(attn.numpy(), np.asarray(attn_j),
                                   atol=1e-4)
        assert m2.shape == m.shape
        clipped += float(gn_j) >= CLIP
    assert clipped == 2 and state.step == 3     # both branches of the clip
    params_t = to_jax_variables(model)["params"]
    for (path, pj), (_, pt) in zip(leaves(state_j.params), leaves(params_t)):
        d = np.abs(pt - np.asarray(pj))
        assert np.mean(d <= 1e-6) >= 0.995, path
        assert d.max() <= 6 * LR + 1e-6, path
    assert state.opt_state.count == int(state_j.opt_state[1].count) == 3
    stats_t = to_jax_variables(model)["batch_stats"]
    for (path, sj), (_, st) in zip(leaves(state_j.batch_stats),
                                   leaves(stats_t)):
        np.testing.assert_allclose(st, np.asarray(sj), atol=1e-5,
                                   err_msg=str(path))


@pytest.fixture()
def port_hp():
    from wavernn_tpu_torch.config import hp

    hp.reset()
    hp.configure_from_dict({"tts_checkpoint_every": 1000})
    yield hp
    hp.reset()


def test_tts_nan_step_cannot_clobber_latest_checkpoint(setup, tmp_path,
                                                      port_hp):
    """The port's mirror of ``tests/test_training.py::
    test_tts_nan_step_cannot_clobber_latest_checkpoint``."""
    _, cfg, v, _, _ = setup
    opt = make_optimizer(LR, CLIP)
    state = new_train_state(from_jax_variables(v, cfg, "cpu"), opt)
    paths = Paths(tmp_path / "data", "v", "t", base=tmp_path)
    x, m = batch(cfg, 50)
    good = (x, m, ["a", "b"], [m.shape[1]] * 2)
    state = tts_train_loop(paths, cfg, state, opt, [good], r=R, lr=LR,
                           train_steps=1, attn_example="zzz")
    good_weights = paths.tts_latest_weights.read_bytes()
    good_optim = paths.tts_latest_optim.read_bytes()

    poisoned = (x, np.full_like(m, np.nan), ["a", "b"], [m.shape[1]] * 2)
    state = tts_train_loop(paths, cfg, state, opt, [poisoned], r=R, lr=LR,
                           train_steps=1, attn_example="zzz")
    assert state.step == 2
    assert paths.tts_latest_weights.read_bytes() == good_weights
    assert paths.tts_latest_optim.read_bytes() == good_optim
