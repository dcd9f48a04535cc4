"""The port's data layer against the JAX package's.

A synthetic sine corpus is preprocessed by both packages with one worker
(with more, ``dataset.pkl`` lists utterances in the order the pool finishes
them): the mel and quant files and the manifest must be equal.  The split,
``collate_vocoder`` (RAW and MOL, the global ``np.random`` seeded alike),
the loaders' batch order over two epochs, ``collate_tts`` and the
``BinnedLengthSampler`` must give exactly JAX's arrays.  The port's pool
of two workers must write what one worker writes.  Loaders run with
no prefetch threads here: threads interleave their draws from the global
``np.random``."""

import pickle
from pathlib import Path

import numpy as np
import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu.config import hp as jax_hp
from wavernn_tpu.data import dataset as jds
from wavernn_tpu.data import loader as jloader
from wavernn_tpu.data.preprocess import preprocess_dataset as jax_preprocess
from wavernn_tpu.paths import Paths as JaxPaths
from wavernn_tpu.text.recipes import ljspeech as jax_ljspeech
from wavernn_tpu_torch.config import hp
from wavernn_tpu_torch.data import dataset as tds
from wavernn_tpu_torch.data import loader as tloader
from wavernn_tpu_torch.data.preprocess import preprocess_dataset
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.paths import Paths
from wavernn_tpu_torch.text.recipes import ljspeech
from wavernn_tpu_torch.utils.files import get_files

REPO = Path(__file__).parent.parent


@pytest.fixture(params=["RAW", "MOL"])
def corpus(request, tmp_path):
    """Both packages' ``hp`` on hparams.py in one mode; the corpus
    preprocessed by each into its own data directory."""
    for h in (jax_hp, hp):
        h.reset()
        h.configure(REPO / "hparams.py", voc_mode=request.param,
                    voc_test_samples=2)
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(8):
        n = 22050 + int(rng.integers(0, 11025))
        t = np.arange(n) / 22050
        y = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) \
            + 0.02 * rng.standard_normal(n)
        wavio.save_wav(y.astype(np.float32), wav_dir / f"utt{i}.wav",
                       sr=22050)
        lines.append(f"utt{i}|Text {i}, Dr. Smith.|Text {i}, Dr. Smith.")
    (wav_dir / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    out = {}
    for tag, P, pre, recipe in (
            ("jax", JaxPaths, jax_preprocess, jax_ljspeech),
            ("port", Paths, preprocess_dataset, ljspeech)):
        paths = P(tmp_path / tag / "data", "voc", "tts", base=tmp_path / tag)
        with open(paths.data / "text_dict.pkl", "wb") as f:
            pickle.dump(recipe(wav_dir), f)
        manifest = pre(get_files(wav_dir, ".wav"), paths, n_workers=1)
        out[tag] = (paths, manifest)
    yield request.param, out
    for h in (jax_hp, hp):
        h.reset()


def test_preprocess_matches_jax(corpus):
    _, out = corpus
    (jp, jm), (tp, tm) = out["jax"], out["port"]
    assert tm == jm and len(tm) == 8
    assert (tp.data / "dataset.pkl").read_bytes() == \
        (jp.data / "dataset.pkl").read_bytes()
    assert (tp.data / "text_dict.pkl").read_bytes() == \
        (jp.data / "text_dict.pkl").read_bytes()
    for item_id, _ in tm:
        for sub in ("mel", "quant"):
            a = np.load(getattr(tp, sub) / f"{item_id}.npy")
            b = np.load(getattr(jp, sub) / f"{item_id}.npy")
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_preprocess_pool_matches_one_worker(tmp_path):
    """Two spawned workers, each given ``hp`` by the pool's initializer,
    write the same mel and quant files and the same manifest, in the order
    they finish, as one worker."""
    hp.reset()
    hp.configure(REPO / "hparams.py", voc_mode="RAW")
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        y = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400)
                         * np.arange(11025) / 22050)
        wavio.save_wav(y.astype(np.float32), wav_dir / f"u{i}.wav",
                       sr=22050)
    try:
        got = {}
        for n in (1, 2):
            paths = Paths(tmp_path / f"w{n}" / "data", "voc", "tts",
                          base=tmp_path / f"w{n}")
            got[n] = (paths, preprocess_dataset(get_files(wav_dir, ".wav"),
                                                paths, n_workers=n))
    finally:
        hp.reset()
    (p1, m1), (p2, m2) = got[1], got[2]
    assert sorted(m2) == sorted(m1) and len(m1) == 3
    with open(p2.data / "dataset.pkl", "rb") as f:
        assert pickle.load(f) == m2
    for item_id, _ in m1:
        for sub in ("mel", "quant"):
            a = np.load(getattr(p1, sub) / f"{item_id}.npy")
            b = np.load(getattr(p2, sub) / f"{item_id}.npy")
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_split_and_collate_vocoder_match_jax(corpus):
    mode, out = corpus
    (jp, _), (tp, _) = out["jax"], out["port"]
    assert tds._split_ids(tp.data) == jds._split_ids(jp.data)
    train_ids, test_ids = tds._split_ids(tp.data)
    assert len(test_ids) == 2 and len(train_ids) == 6
    items = [tds.VocoderDataset(tp.data, train_ids)[i] for i in range(4)]
    np.random.seed(3)
    got = tds.collate_vocoder(items)
    np.random.seed(3)
    want = jds.collate_vocoder(items)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    x, y, mels = got
    assert x.shape == (4, hp.voc_seq_len) and x.dtype == np.float32
    assert y.dtype == (np.float32 if mode == "MOL" else np.int64)
    assert mels.shape == (4, hp.voc_seq_len // hp.hop_length
                          + 2 * hp.voc_pad, hp.num_mels)


def test_vocoder_loaders_match_jax_over_two_epochs(corpus):
    _, out = corpus
    (jp, _), (tp, _) = out["jax"], out["port"]
    loaders = []
    for ds, paths in ((tds, tp), (jds, jp)):
        train, test = ds.get_vocoder_datasets(paths.data, 2, False)
        train.num_workers = test.num_workers = 0
        loaders.append((train, test))
    (t_train, t_test), (j_train, j_test) = loaders
    assert len(t_train) == len(j_train) == 3
    np.random.seed(9)
    got = [b for _ in range(2) for b in t_train] + list(t_test)
    np.random.seed(9)
    want = [b for _ in range(2) for b in j_train] + list(j_test)
    assert len(got) == len(want) == 8
    for bg, bw in zip(got, want):
        for a, b in zip(bg, bw):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_order_matches_jax(workers):
    class Items(tloader.Dataset):
        def __getitem__(self, i):
            return i

        def __len__(self):
            return 11

    kw = dict(batch_size=3, shuffle=True, num_workers=workers, seed=5,
              drop_last=True)
    t = tloader.DataLoader(Items(), **kw)
    j = jloader.DataLoader(Items(), **kw)
    got = [b for _ in range(2) for b in t]
    assert got == [b for _ in range(2) for b in j]
    assert len(got) == 6 and got[:3] != got[3:]


def test_tts_batches_and_binned_sampler_match_jax(corpus):
    _, out = corpus
    (jp, _), (tp, _) = out["jax"], out["port"]
    t_set, t_attn = tds.get_tts_datasets(tp.data, 2, r=3)
    j_set, j_attn = jds.get_tts_datasets(jp.data, 2, r=3)
    assert t_attn == j_attn
    assert isinstance(t_set.sampler, tds.BinnedLengthSampler)
    t_set.num_workers = j_set.num_workers = 0
    for _ in range(2):
        batches = list(zip(t_set, j_set))
        assert len(batches) == 4
        for (tc, tm, tids, tl), (jc, jm, jids, jl) in batches:
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tm, jm)
            assert tids == jids and tl == jl
            assert tm.shape[1] % 3 == 0 and tc.dtype == np.int32
    lengths = [5, 3, 9, 1, 7, 2, 8, 4, 6, 10, 11]
    t = tds.BinnedLengthSampler(lengths, 2, 4, seed=7)
    j = jds.BinnedLengthSampler(lengths, 2, 4, seed=7)
    assert [list(t) for _ in range(3)] == [list(j) for _ in range(3)]
