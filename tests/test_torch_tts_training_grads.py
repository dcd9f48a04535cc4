"""The port's teacher-forced Tacotron in train mode against the JAX model,
float32 on the CPU, at ``tests/test_tacotron.py``'s tiny sizes (helpers
from ``tests/test_torch_tts_training.py``).

With ``dropout=0`` flax's ``nn.Dropout(0)`` is the identity and the prenet
keep-masks are all ones, so only the zoneout masks are random: they come
from a numpy seed and reach JAX through ``model.apply(..., method=f)``,
``f`` composing ``encode``, the decoder scan and ``postnet_forward`` as
``Tacotron.__call__`` does (the JAX package is not changed for it).  The
loss within 1e-5 relative, the attention within 1e-5, every gradient leaf
within 1e-4 relative L2 (leaves JAX gives exactly zero, mel_proj's unused
frame slots, exactly zero), the updated ``batch_stats`` within 1e-5
absolute.

A ``"tts"`` checkpoint pair the port writes (after two train steps) restores
in the JAX package leaf for leaf, Adam moments included; the pair the JAX
package then writes restores in the port, which writes back its first
pair byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_tts_training import (
    T, batch, jax_cfg, port_cfg, rel_l2, variables, zoneout_masks,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
from wavernn_tpu.models.tacotron import init_decoder_carry as jax_carry
from wavernn_tpu.paths import Paths as JaxPaths
from wavernn_tpu.training.state import make_optimizer as jax_optimizer
from wavernn_tpu.training.state import new_train_state as jax_state
from wavernn_tpu.utils import checkpoints as jax_ckpt
from wavernn_tpu_torch.models.tacotron import (
    draw_decoder_masks, from_jax_variables, to_jax_tree, to_jax_variables,
)
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.tacotron import make_tts_train_step
from wavernn_tpu_torch.utils.checkpoints import (
    restore_checkpoint, save_checkpoint,
)


def jax_train_loss(jcfg, r):
    """JAX's train-mode L1 loss with the decoder's masks as inputs:
    ``Tacotron.__call__``'s body with the masks it would draw replaced."""
    model = JaxTacotron(jcfg)

    def f(module, x, m, masks):
        enc, encp = module.encode(x, True)
        Bm, steps = m.shape[0], m.shape[1]
        go = jnp.zeros((1, Bm, jcfg.n_mels), m.dtype)
        idx = jnp.arange(1, steps // r) * r - 1
        prenet_seq = jnp.concatenate([go, jnp.swapaxes(m[:, idx], 0, 1)], 0)
        carry0 = jax_carry(jcfg, Bm, x.shape[1], m.dtype)
        _, (mels, scores) = module.decoder(carry0, enc, encp, prenet_seq,
                                           masks, r, True)
        mel = jnp.transpose(mels, (1, 0, 3, 2)).reshape(Bm, steps, -1)
        return mel, module.postnet_forward(mel, True), \
            jnp.swapaxes(scores, 0, 1)

    def loss_fn(params, batch_stats, x, m, masks):
        (m1, m2, attn), mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, x, m, masks,
            method=f, mutable=["batch_stats"])
        loss = jnp.abs(m1 - m).mean() + jnp.abs(m2 - m).mean()
        return loss, (mutated["batch_stats"], attn)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_train_mode_loss_grads_and_stats_match_jax():
    r = 3
    jcfg = jax_cfg(dropout=0.0)
    cfg = port_cfg(jcfg)
    v = variables(cfg, 1)
    x, m = batch(cfg, 1)
    masks = zoneout_masks(cfg, T // r)
    (loss_j, (stats_j, attn_j)), grads_j = jax_train_loss(jcfg, r)(
        v["params"], v["batch_stats"], jnp.asarray(x), jnp.asarray(m),
        tuple(map(jnp.asarray, masks)))

    model = from_jax_variables(v, cfg, "cpu").train()
    mt = torch.from_numpy(m)
    m1, m2, attn = model(torch.from_numpy(x).long(), mt, r, True,
                         masks=tuple(map(torch.from_numpy, masks)))
    loss = (m1 - mt).abs().mean() + (m2 - mt).abs().mean()
    loss.backward()

    loss = float(loss.detach())
    assert abs(loss - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(attn_j),
                               atol=1e-5)
    grads_t = to_jax_tree({n: p.grad for n, p in model.named_parameters()},
                          model)
    lj = jax.tree_util.tree_leaves_with_path(grads_j)
    lt = jax.tree_util.tree_leaves_with_path(grads_t)
    assert [p for p, _ in lj] == [p for p, _ in lt]
    for (path, gj), (_, gt) in zip(lj, lt):
        assert gt.shape == gj.shape, path
        if np.abs(np.asarray(gj)).max() == 0:       # mel_proj's unused slots
            assert np.abs(gt).max() == 0, path
            continue
        assert rel_l2(gt, gj) <= 1e-4, (path, rel_l2(gt, gj))
    stats_t = to_jax_variables(model)["batch_stats"]
    moved = 0.0
    for (path, sj), (_, st), (_, s0) in zip(
            jax.tree_util.tree_leaves_with_path(stats_j),
            jax.tree_util.tree_leaves_with_path(stats_t),
            jax.tree_util.tree_leaves_with_path(v["batch_stats"])):
        np.testing.assert_allclose(st, np.asarray(sj), atol=1e-5,
                                   err_msg=str(path))
        moved = max(moved, float(np.abs(np.asarray(sj) - s0).max()))
    assert moved > 1e-2          # the batch term really moved them


def leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def both_paths(base):
    return (Paths(base / "data", "voc", "tts", base=base),
            JaxPaths(base / "data", "voc", "tts", base=base))


def test_tts_pairs_resume_in_either_package(tmp_path):
    lr, clip, r = 1e-3, 1.0, 3
    cfg = port_cfg(jax_cfg())
    v = variables(cfg, 3)
    model = from_jax_variables(v, cfg, "cpu")
    opt = make_optimizer(lr, clip)
    state = new_train_state(model, opt)
    step = make_tts_train_step(model, opt, r)
    g = torch.Generator().manual_seed(0)
    for i in range(2):
        x, m = batch(cfg, 30 + i)
        step(state, x, m, masks=draw_decoder_masks(cfg, T // r, 2, "cpu", g))
    paths, jpaths = both_paths(tmp_path / "a")
    save_checkpoint("tts", paths, state, name="taco_step0K", is_silent=True)

    template = jax_state(v["params"], v["batch_stats"],
                         jax_optimizer(lr, clip))
    want = to_jax_variables(model)
    for name in (None, "taco_step0K"):
        got = jax_ckpt.restore_checkpoint("tts", jpaths, template, name=name)
        assert int(got.step) == 2
        for coll in ("params", "batch_stats"):
            for (p, a), (_, b) in zip(leaves(getattr(got, coll)),
                                      leaves(want[coll])):
                np.testing.assert_array_equal(np.asarray(a), b,
                                              err_msg=str(p))
        inject = got.opt_state[1]
        assert int(inject.count) == 2
        assert float(inject.hyperparams["learning_rate"]) == \
            float(np.float32(lr))
        for moment in ("mu", "nu"):
            mine = jax.tree_util.tree_leaves(
                to_jax_tree(getattr(state.opt_state, moment), model))
            theirs = jax.tree_util.tree_leaves(
                getattr(inject.inner_state[0], moment))
            assert len(mine) == len(theirs)
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(np.asarray(b), a)

    # the JAX package writes the restored state; the port resumes it
    _, jpaths_b = both_paths(tmp_path / "b")
    jax_ckpt.save_checkpoint("tts", jpaths_b, got, is_silent=True)
    fresh = new_train_state(from_jax_variables(variables(cfg, 9), cfg, "cpu"),
                            make_optimizer(lr, clip))
    paths_b, _ = both_paths(tmp_path / "b")
    back = restore_checkpoint("tts", paths_b, fresh)
    assert back.step == 2 and back.opt_state.count == 2
    for (p, a), (_, b) in zip(leaves(to_jax_variables(back.model)),
                              leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    for moment in ("mu", "nu"):
        for k, t in getattr(state.opt_state, moment).items():
            assert torch.equal(getattr(back.opt_state, moment)[k], t), k
    # written again, it is the port's first pair byte for byte
    paths_c, _ = both_paths(tmp_path / "c")
    save_checkpoint("tts", paths_c, back, is_silent=True)
    for a, b in ((paths.tts_latest_weights, paths_c.tts_latest_weights),
                 (paths.tts_latest_optim, paths_c.tts_latest_optim)):
        assert a.read_bytes() == b.read_bytes(), a.name
