"""``python -m wavernn_tpu_torch.train_wavernn`` with the JAX CLI's two
training options in its hp file, ``voc_seq_chunks = 5`` (with
``voc_chunk_warmup = 128``: five chunks of 275 + 128 samples of each
1,375-sample window) and ``voc_compute_dtype = "bfloat16"``, on the CPU:
two steps of a tiny RAW model from a fresh checkpoint, run in process
through ``main(argv)``; the pair it writes must restore in the JAX
package (``wavernn_tpu.utils.checkpoints.restore_checkpoint``) to the
port's weights, step and optimizer count."""

import jax
import numpy as np
import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.paths import Paths as JaxPaths
from wavernn_tpu.training.state import make_optimizer as jax_optimizer
from wavernn_tpu.training.state import new_train_state as jax_state
from wavernn_tpu.utils import checkpoints as jax_ckpt
from wavernn_tpu_torch import preprocess, train_wavernn
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
from wavernn_tpu_torch.utils.checkpoints import load_pytree
from tests.test_torch_train_cli import HP, N_SAMPLES

OPTIONS = ('voc_seq_chunks = 5\nvoc_chunk_warmup = 128\n'
           'voc_compute_dtype = "bfloat16"\n')


@pytest.fixture()
def fresh_hp():
    hp.reset()
    yield
    hp.reset()


def test_train_wavernn_with_both_options(tmp_path, monkeypatch, capsys,
                                         fresh_hp):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "wavs").mkdir()
    lines = []
    for i in range(6):
        t = np.arange(N_SAMPLES) / 22050
        y = 0.4 * np.sin(2 * np.pi * 220 * (i + 1) * t)
        wavio.save_wav(y.astype(np.float32), tmp_path / "wavs" / f"utt{i}.wav",
                       22050)
        lines.append(f"utt{i}|text {i}|text {i}")
    (tmp_path / "wavs" / "metadata.csv").write_text("\n".join(lines))
    (tmp_path / "hp.py").write_text(HP.replace("TOTAL", "2") + OPTIONS)
    preprocess.main(["--path", "wavs", "--hp_file", "hp.py",
                     "--num_workers", "1"])
    hp.reset()
    state = train_wavernn.main(["--hp_file", "hp.py", "--device", "cpu"])
    out = capsys.readouterr().out
    cfg = WaveRNNConfig.from_hp(hp)
    assert (cfg.seq_chunks, cfg.chunk_warmup, cfg.compute_dtype) == (
        5, 128, "bfloat16")
    assert cfg.chunks(hp.voc_seq_len) and state.model.cfg == cfg
    assert state.step == 2 and "Training Complete" in out
    losses = [float(s.split("|")[0]) for s in out.split("Loss: ")[1:]]
    assert losses and np.isfinite(losses).all()

    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in (
        "rnn_dims", "fc_dims", "bits", "pad", "upsample_factors",
        "feat_dims", "compute_dims", "res_out_dims", "res_blocks",
        "hop_length", "sample_rate", "mode", "compute_dtype", "seq_chunks",
        "chunk_warmup")})
    x = np.zeros((1, hp.voc_seq_len), np.float32)
    mels = np.zeros((1, hp.voc_seq_len // hp.hop_length + 2 * hp.voc_pad,
                     hp.num_mels), np.float32)
    v = jax.jit(JaxWaveRNN(jcfg).init, static_argnums=3)(
        jax.random.PRNGKey(1), x, mels, False)
    opt = jax_optimizer(hp.voc_lr, hp.voc_clip_grad_norm)
    template = jax_state(v["params"], v["batch_stats"], opt)
    jpaths = JaxPaths(hp.data_path, hp.voc_model_id, hp.tts_model_id,
                      base=tmp_path)
    got = jax_ckpt.restore_checkpoint("voc", jpaths, template)
    assert int(got.step) == 2 and int(got.opt_state[1].count) == 2
    blob = load_pytree(jpaths.voc_latest_weights)
    for tree in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(blob[tree])
        have = jax.tree_util.tree_leaves_with_path(getattr(got, tree))
        assert [p for p, _ in want] == [p for p, _ in have]
        for (p, a), (_, b) in zip(want, have):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(p))
