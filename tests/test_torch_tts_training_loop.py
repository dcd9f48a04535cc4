"""The port's Tacotron curriculum, GTA export and training plots, on the
CPU at the tiny sizes (helpers from ``tests/test_torch_tts_training.py``).

* ``r_for_step`` and ``run_schedule``'s session choice, ported from
  ``tests/test_tacotron.py::test_r_for_step_schedule_position`` and
  ``::test_curriculum_session_selection``.
* A resumed run trains in the session its step selects, with that
  session's learning rate injected into the restored Adam state and its
  moments kept: the resumed parameters equal, bit for bit, those of the
  uninterrupted state stepped on at the new rate.  The loop writes the
  attention and mel plots of its example.
* ``create_gta_features`` writes the files the JAX package writes on the
  same batches, within 1e-5.
* ``save_attention`` and ``save_spectrogram`` with matplotlib (PNGs) and
  without it (``.npy`` files).
"""

import copy

import numpy as np
import pytest
import torch

from tests.test_torch_tts_training import batch, jax_cfg, port_cfg, variables
from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.training.state import make_optimizer as jax_optimizer
from wavernn_tpu.training.state import new_train_state as jax_state
from wavernn_tpu.training.tacotron import create_gta_features as jax_gta
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.models.tacotron import from_jax_variables
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training.state import (
    make_optimizer, new_train_state, set_learning_rate,
)
from wavernn_tpu_torch.training.tacotron import (
    create_gta_features, make_tts_train_step, r_for_step, run_schedule,
)
from wavernn_tpu_torch.utils import display
from wavernn_tpu_torch.utils.checkpoints import restore_checkpoint


@pytest.fixture()
def port_hp():
    hp.reset()
    hp.configure_from_dict({"tts_checkpoint_every": 1000})
    yield hp
    hp.reset()


def test_r_for_step_schedule_position():
    sched = [(7, 1e-3, 10_000, 32), (5, 1e-4, 100_000, 32),
             (2, 1e-4, 180_000, 16)]
    assert r_for_step(0, sched) == 7
    assert r_for_step(9_999, sched) == 7
    assert r_for_step(10_000, sched) == 5
    assert r_for_step(150_000, sched) == 2
    assert r_for_step(999_999, sched) == 2  # past the schedule: final r


def test_curriculum_session_selection(port_hp, tmp_path):
    """Resume lands in the session the restored step dictates (ref:
    train_tacotron.py:68-90); past the last session only --force_train
    trains on."""
    port_hp.tts_schedule = [(7, 1e-3, 5, 2), (5, 1e-4, 10, 2),
                            (2, 1e-4, 15, 2)]
    cfg = port_cfg(jax_cfg())
    opt = make_optimizer(1e-3, 1.0)
    state = new_train_state(from_jax_variables(variables(cfg), cfg, "cpu"),
                            opt)
    state.step = 7                                   # inside session 2
    seen = []

    def fake_loop(paths, cfg_, st, optimizer, train_set, r, lr, steps, attn):
        seen.append((r, lr, steps))
        st.step += steps
        return st

    paths = Paths(tmp_path / "d", "v", "t", base=tmp_path)
    run_schedule(paths, cfg, state, opt, lambda bs, r: ([], "utt0"),
                 train_loop=fake_loop)
    assert seen == [(5, 1e-4, 3), (2, 1e-4, 5)]
    assert state.step == 15
    seen.clear()
    run_schedule(paths, cfg, state, opt, lambda bs, r: ([], "utt0"),
                 train_loop=fake_loop)
    assert seen == []
    run_schedule(paths, cfg, state, opt, lambda bs, r: ([], "utt0"),
                 force_train=True, train_loop=fake_loop)
    assert seen == [(2, 1e-4, 999_999_999)]


def test_resume_injects_the_session_lr_and_keeps_the_moments(port_hp,
                                                            tmp_path):
    r, lr1, lr2 = 3, 1e-3, 2.5e-4
    port_hp.tts_schedule = [(r, lr1, 1, 2), (r, lr2, 2, 2)]
    cfg = port_cfg(jax_cfg())
    opt = make_optimizer(lr1, 1.0)
    x, m = batch(cfg, 60)
    train_set = [(x, m, ["a", "b"], [m.shape[1]] * 2)]
    paths = Paths(tmp_path / "data", "v", "t", base=tmp_path)
    state = new_train_state(from_jax_variables(variables(cfg), cfg, "cpu"),
                            opt)
    state = run_schedule(paths, cfg, state, opt, lambda bs, r_: (train_set,
                                                                 "b"))
    assert state.step == 2
    for kind in ("attention", "mel_plot"):       # the example's plots
        assert any(getattr(paths, f"tts_{kind}").iterdir()), kind

    # the same from step 1: one run of session 1, saved, then resumed
    port_hp.tts_schedule = [(r, lr1, 1, 2)]
    paths1 = Paths(tmp_path / "data", "v", "t1", base=tmp_path)
    first = new_train_state(from_jax_variables(variables(cfg), cfg, "cpu"),
                            opt)
    first = run_schedule(paths1, cfg, first, opt, lambda bs, r_: (train_set,
                                                                  "zz"))
    uninterrupted = copy.deepcopy(first)
    port_hp.tts_schedule = [(r, lr1, 1, 2), (r, lr2, 2, 2)]
    resumed = restore_checkpoint(
        "tts", paths1, new_train_state(from_jax_variables(
            variables(cfg, 5), cfg, "cpu"), make_optimizer(lr1, 1.0)))
    assert resumed.step == 1 and resumed.opt_state.count == 1
    resumed = run_schedule(paths1, cfg, resumed, opt,
                           lambda bs, r_: (train_set, "zz"))
    assert resumed.step == 2
    assert resumed.opt_state.learning_rate == float(np.float32(lr2))
    assert resumed.opt_state.count == 2
    # the uninterrupted state stepped on at lr2, with the loop's masks
    set_learning_rate(uninterrupted.opt_state, lr2)
    step = make_tts_train_step(uninterrupted.model, opt, r)
    step(uninterrupted, x, m, torch.Generator().manual_seed(0 + 1))
    for (n, a), (_, b) in zip(resumed.model.named_parameters(),
                              uninterrupted.model.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(state.model.decoder.mel_proj.kernel,
                       resumed.model.decoder.mel_proj.kernel)


def test_gta_export_matches_jax(port_hp, tmp_path):
    r = 3
    cfg = port_cfg(jax_cfg())
    v = variables(cfg, 7)
    rng = np.random.default_rng(8)
    batches = []
    for i in range(0, 4, 2):
        x, m = batch(cfg, 70 + i)
        batches.append((x, m, [f"utt{i}", f"utt{i + 1}"],
                        [int(rng.integers(5, T_ + 1)) for T_ in
                         (m.shape[1],) * 2]))
    jstate = jax_state(v["params"], v["batch_stats"], jax_optimizer(1e-3, 1.0))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_gta(jax_cfg(), jstate, batches, tmp_path / "jax", r)
    state = new_train_state(from_jax_variables(v, cfg, "cpu").train(),
                            make_optimizer(1e-3, 1.0))
    create_gta_features(cfg, state, batches, tmp_path / "port", r)
    for _, _, ids, lens in batches:
        for item, n in zip(ids, lens):
            got = np.load(tmp_path / "port" / f"{item}.npy")
            want = np.load(tmp_path / "jax" / f"{item}.npy")
            assert got.shape == want.shape == (cfg.n_mels, n)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mpl", [True, False], ids=["matplotlib", "npy"])
def test_save_attention_and_spectrogram(tmp_path, monkeypatch, mpl):
    if not mpl:
        monkeypatch.setattr(display, "_pyplot", lambda: None)
    elif display._pyplot() is None:
        pytest.skip("matplotlib is not installed")
    rng = np.random.default_rng(0)
    attn = rng.uniform(size=(20, 11)).astype(np.float32)
    mel = rng.uniform(size=(8, 30)).astype(np.float32)
    display.save_attention(attn, tmp_path / "100")
    display.save_spectrogram(mel, tmp_path / "s100", 25)
    display.save_attention(attn, tmp_path / "utt.wav", save_raw=True)
    names = sorted(p.name for p in tmp_path.iterdir())
    if mpl:
        assert names == ["100.png", "s100.png", "utt.png",
                         "utt_attention.npy"]
        for name in names[:3]:
            assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"
    else:
        assert names == ["100_attention.npy", "s100_spectrogram.npy",
                         "utt_attention.npy"]
        np.testing.assert_array_equal(
            np.load(tmp_path / "100_attention.npy"), attn)
        np.testing.assert_array_equal(
            np.load(tmp_path / "s100_spectrogram.npy"), mel[::-1, :25])
    np.testing.assert_array_equal(np.load(tmp_path / "utt_attention.npy"),
                                  attn)
