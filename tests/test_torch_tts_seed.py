"""The Tacotron trainer's mask seed (``train_tacotron --seed``,
``e2e_tts --seed``), on the CPU at a tiny width, without JAX.

``run_schedule(seed=)`` reaches ``tts_train_loop(seed=)``, whose mask
generator starts each session at ``seed + step``.  Seed 0, the default, is
the stream the trainer drew before it took a seed (the JAX CLI's
``PRNGKey(0 + step)`` rule): the same batches and masks, and the same
parameters as a train step given a generator seeded 0.  Seed 1 draws other
masks on the same batches (the batch order is the loader's, not the
seed's).  Both CLIs hand ``--seed`` down.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu_torch import train_tacotron
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.examples import e2e_tts
from wavernn_tpu_torch.models import tacotron as taco_model
from wavernn_tpu_torch.models.tacotron import (
    TacotronConfig, from_jax_variables, init_variables,
)
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.training import tacotron as taco_training
from wavernn_tpu_torch.training.state import make_optimizer, new_train_state
from wavernn_tpu_torch.training.tacotron import (
    make_tts_train_step, run_schedule,
)

REPO_HP = str(Path(__file__).parent.parent / "hparams.py")
CFG = TacotronConfig(embed_dims=16, encoder_dims=16, decoder_dims=32,
                     postnet_dims=16, encoder_K=4, lstm_dims=32, postnet_K=3,
                     num_highways=2)
R, LR = 3, 1e-3


@pytest.fixture()
def port_hp():
    hp.reset()
    hp.configure_from_dict({"tts_checkpoint_every": 1000,
                            "tts_schedule": [(R, LR, 2, 2)]})
    yield hp
    hp.reset()


def train_set():
    rng = np.random.default_rng(0)
    out = []
    for i in range(2):
        x = rng.integers(1, CFG.num_chars, (2, 12)).astype(np.int32)
        m = rng.uniform(-4, 4, (2, 12, CFG.n_mels)).astype(np.float32)
        out.append((x, m, [f"u{2 * i}", f"u{2 * i + 1}"], [12, 12]))
    return out


def fresh_state():
    model = from_jax_variables(init_variables(CFG, 0), CFG, "cpu")
    return new_train_state(model, make_optimizer(LR, 1.0))


def run(tmp_path, monkeypatch, **kw):
    """Two steps of the schedule; the batches and every drawn mask."""
    batches, masks = [], []
    to, keep = taco_training.tts_batch_to, taco_model.keep_mask

    def record_batch(device, x, m):
        batches.append((x.copy(), m.copy()))
        return to(device, x, m)

    def record_mask(*a, **k):
        masks.append(keep(*a, **k))
        return masks[-1]

    monkeypatch.setattr(taco_training, "tts_batch_to", record_batch)
    monkeypatch.setattr(taco_model, "keep_mask", record_mask)
    data = train_set()
    state = fresh_state()
    paths = Paths(tmp_path / "d", "v", f"t_{kw.get('seed')}", base=tmp_path)
    state = run_schedule(paths, CFG, state, make_optimizer(LR, 1.0),
                         lambda bs, r: (data, "zz"), **kw)
    monkeypatch.undo()
    assert state.step == 2 and len(batches) == 2 and masks
    return batches, masks, state


def test_seed_zero_is_the_default_stream_and_seed_one_moves_it(
        port_hp, tmp_path, monkeypatch):
    default = run(tmp_path, monkeypatch)
    zero = run(tmp_path, monkeypatch, seed=0)
    one = run(tmp_path, monkeypatch, seed=1)
    for a, b in ((default, zero), (default, one)):
        for (xa, ma), (xb, mb) in zip(a[0], b[0]):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ma, mb)
    assert len(default[1]) == len(zero[1]) == len(one[1])
    assert all(torch.equal(a, b) for a, b in zip(default[1], zero[1]))
    assert not all(torch.equal(a, b) for a, b in zip(default[1], one[1]))
    for (n, a), (_, b) in zip(default[2].model.named_parameters(),
                              zero[2].model.named_parameters()):
        assert torch.equal(a, b), n
    assert not all(torch.equal(a, b) for a, b in zip(
        default[2].model.parameters(), one[2].model.parameters()))

    # the stream of a generator seeded 0 + step, one session from step 0
    for seed, got in ((0, zero), (1, one)):
        state = fresh_state()
        opt = make_optimizer(LR, 1.0)
        step = make_tts_train_step(state.model, opt, R)
        gen = torch.Generator().manual_seed(seed + 0)
        for x, m, _, _ in train_set():
            step(state, x, m, gen)
        for (n, a), (_, b) in zip(state.model.named_parameters(),
                                  got[2].model.named_parameters()):
            assert torch.equal(a, b), (seed, n)


def test_both_clis_hand_the_seed_down(tmp_path, monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake_schedule(*a, **kw):
        seen["train_tacotron"] = kw.get("seed")
        raise Stop

    hp_file = tmp_path / "hp.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path({REPO_HP!r})"
        ".items() if not k.startswith('__')})\n"
        "tts_embed_dims = 16; tts_encoder_dims = 16; tts_decoder_dims = 32\n"
        "tts_postnet_dims = 16; tts_encoder_K = 4; tts_lstm_dims = 32\n"
        "tts_postnet_K = 3; tts_num_highways = 2\n"
        f"data_path = {str(tmp_path / 'data')!r}; voc_model_id = 'v'\n"
        "tts_model_id = 't'; tts_schedule = [(3, 1e-3, 2, 2)]\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_tacotron, "run_schedule", fake_schedule)
    for argv, want in (([], 0), (["--seed", "3"], 3)):
        hp.reset()
        with pytest.raises(Stop):
            train_tacotron.main(["--hp_file", str(hp_file), "--device",
                                 "cpu"] + argv)
        assert seen.pop("train_tacotron") == want
    hp.reset()

    calls = []
    monkeypatch.setattr(e2e_tts, "run_cli",
                        lambda main, argv, cwd, tag: calls.append(argv))
    e2e_tts.run_pipeline(tmp_path / "ws", 2, 2, "cpu",
                         e2e_tts.TRAIN_TEXTS[:2], seed=5)
    assert calls[1][-2:] == ["--seed", "5"]
    monkeypatch.setattr(e2e_tts, "run_pipeline",
                        lambda *a, **kw: seen.update(e2e=kw["seed"]))
    monkeypatch.setattr(e2e_tts, "evaluate_gates", lambda ws, args: {})
    e2e_tts.main(["--workspace", str(tmp_path / "ws"), "--device", "cpu",
                  "--seed", "2"])
    assert seen["e2e"] == 2
