"""The port's training recipe through its CLIs, each step in a subprocess
on the CPU (``--device cpu``): preprocess a tiny sine corpus, train 4
steps with a checkpoint and an audition, re-run to resume at the stored
step, vocode with ``gen_wavernn``.  Without ``--device`` the trainer asks
for CUDA and, on a machine without it, exits non-zero; a local device
plan raises where a world plan is needed.  Two CPU ranks under torchrun's variables resume the
same workspace data-parallel.

The model is tiny (RAW, 32-wide) and the auditions short, so the plain
decode stands in for the kernel on the CPU in about a second."""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.torch_cpu import one_torch_thread  # noqa: F401
from wavernn_tpu_torch.dsp import wavio
from wavernn_tpu_torch.parallel.mesh import make_mesh, shard_batch_fn
from wavernn_tpu_torch.tools.multihost_smoke import free_port
from wavernn_tpu_torch.training.wavernn import (
    make_train_step, voc_train_loop,
)
from wavernn_tpu_torch.utils.checkpoints import load_pytree

REPO = Path(__file__).parent.parent
HP = f"""import runpy
globals().update({{k: v for k, v in runpy.run_path({str(REPO / "hparams.py")!r}).items()
                  if not k.startswith("__")}})
wav_path = "wavs"; data_path = "data"
voc_mode = "RAW"; voc_rnn_dims = 32; voc_fc_dims = 32
voc_compute_dims = 16; voc_res_out_dims = 16; voc_res_blocks = 2
voc_total_steps = TOTAL; voc_batch_size = 2; voc_test_samples = 2
voc_checkpoint_every = 4; voc_gen_at_checkpoint = 1
voc_target = 550; voc_overlap = 110
"""
N_SAMPLES = 5500          # 20 hops: 21 mel frames


def run(ws: Path, *args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], cwd=ws, env=env,
                          capture_output=True, text=True, timeout=timeout)


def is_pcm16(path: Path) -> bool:
    """The WAV's fmt chunk (the first chunk) says 16-bit integer PCM."""
    data = path.read_bytes()
    fmt, _, _, _, _, bits = struct.unpack_from("<HHIIHH", data, 20)
    return data[12:16] == b"fmt " and fmt == 1 and bits == 16


def write_hp(ws: Path, total: int) -> None:
    (ws / "hp.py").write_text(HP.replace("TOTAL", str(total)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The workspace after preprocessing and a first run of 4 steps."""
    ws = tmp_path_factory.mktemp("train_cli")
    (ws / "wavs").mkdir()
    lines = []
    for i in range(6):
        t = np.arange(N_SAMPLES) / 22050
        y = 0.4 * np.sin(2 * np.pi * 220 * (i + 1) * t)
        wavio.save_wav(y.astype(np.float32), ws / "wavs" / f"utt{i}.wav",
                       22050)
        lines.append(f"utt{i}|text {i}|text {i}")
    (ws / "wavs" / "metadata.csv").write_text("\n".join(lines))
    write_hp(ws, 4)
    pre = run(ws, "wavernn_tpu_torch.preprocess", "--path", "wavs",
              "--hp_file", "hp.py", "--num_workers", "1")
    assert pre.returncode == 0, pre.stderr[-3000:]
    train = run(ws, "wavernn_tpu_torch.train_wavernn", "--hp_file", "hp.py",
                "--device", "cpu")
    assert train.returncode == 0, train.stderr[-3000:]
    return ws, pre, train


def test_preprocess_and_first_run(trained):
    ws, pre, train = trained
    assert "6 wav files found" in pre.stdout
    assert len(list((ws / "data" / "mel").glob("*.npy"))) == 6
    ckpt = ws / "checkpoints" / "ljspeech_mol.wavernn"
    for name in ("latest", "wave_step0K"):
        w = load_pytree(ckpt / f"{name}_weights.msgpack")
        assert int(w["step"]) == 4
        assert (ckpt / f"{name}_optim.msgpack").exists()
    assert "Creating latest checkpoint" in train.stdout
    assert "Gen Rate" in train.stdout and "Training Complete" in train.stdout
    out = ws / "model_outputs" / "ljspeech_mol.wavernn"
    gen = out / "0k_steps_1_gen_batched_target550_overlap110.wav"
    pcm, sr = wavio.read_wav_raw(gen)
    assert sr == 22050 and is_pcm16(gen)
    assert pcm.shape == (N_SAMPLES,) and pcm.std() > 0
    assert (out / "0k_steps_1_target.wav").exists()


def test_rerun_resumes_at_the_stored_step(trained):
    ws, _, _ = trained
    write_hp(ws, 6)
    proc = run(ws, "wavernn_tpu_torch.train_wavernn", "--hp_file", "hp.py",
               "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Restoring from latest checkpoint" in proc.stdout
    assert "Start Step" in proc.stdout and "|     4      |" in proc.stdout
    latest = ws / "checkpoints" / "ljspeech_mol.wavernn" / \
        "latest_weights.msgpack"
    assert int(load_pytree(latest)["step"]) == 6


def test_gen_wavernn_reads_the_trained_weights(trained):
    ws, _, _ = trained
    mel = sorted((ws / "data" / "mel").glob("*.npy"))[0]
    proc = run(ws, "wavernn_tpu_torch.gen_wavernn", "--hp_file", "hp.py",
               "--device", "cpu", "--file", str(mel), "--target", "550",
               "--overlap", "110", "--output_dir", "gen")
    assert proc.returncode == 0, proc.stderr[-3000:]
    wavs = list((ws / "gen").glob("*.wav"))
    assert len(wavs) == 1
    pcm, sr = wavio.read_wav_raw(wavs[0])
    assert sr == 22050 and pcm.shape == (N_SAMPLES,)


def test_train_without_device_needs_cuda(trained):
    ws, _, _ = trained
    proc = run(ws, "wavernn_tpu_torch.train_wavernn", "--hp_file", "hp.py")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_options_not_ported_raise():
    """Data parallelism takes a world plan (one process per device), so a
    local plan's ``shard_batch`` or train step is a wrong plan and
    raises.  (The JAX CLI's ``voc_seq_chunks`` and ``voc_compute_dtype``
    train: ``tests/test_torch_train_options_cli.py``.)"""
    local = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="world plan"):
        voc_train_loop(None, None, None, None, [], [], 1,
                       shard_batch=shard_batch_fn(local))
    with pytest.raises(ValueError, match="world plan"):
        make_train_step(None, "RAW", local)


def test_two_ranks_train_on_from_the_stored_step(trained):
    """``train_wavernn`` under torchrun's contract, two CPU ranks over
    gloo: both restore the stored pair, each steps on its half of every
    batch of 2, and rank 0 alone writes the pair two steps on."""
    ws, _, _ = trained
    latest = ws / "checkpoints" / "ljspeech_mol.wavernn" / \
        "latest_weights.msgpack"
    start = int(load_pytree(latest)["step"])
    write_hp(ws, start + 2)
    outs = run_two_ranks(ws)
    assert "Data-parallel: data=2 model=1 (world, rank 0 on cpu)" \
        in outs[0][0]
    assert "Restoring from latest checkpoint" in outs[1][0]
    assert int(load_pytree(latest)["step"]) == start + 2


def test_two_ranks_on_a_model_axis_train_on(trained):
    """``hp.mesh_shape = {"data": 1, "model": 2}``, as the JAX CLI takes
    it: both ranks train on the whole batch of 2 with the parameters
    replicated, and rank 0 writes the pair two steps on."""
    ws, _, _ = trained
    latest = ws / "checkpoints" / "ljspeech_mol.wavernn" / \
        "latest_weights.msgpack"
    start = int(load_pytree(latest)["step"])
    write_hp(ws, start + 2)
    with open(ws / "hp.py", "a") as f:
        f.write("mesh_shape = {'data': 1, 'model': 2}\n")
    outs = run_two_ranks(ws)
    assert "Data-parallel: data=1 model=2 (world, rank 0 on cpu)" \
        in outs[0][0]
    assert int(load_pytree(latest)["step"]) == start + 2


def run_two_ranks(ws):
    """``train_wavernn`` on two CPU ranks under torchrun's variables;
    returns each rank's (stdout, stderr) after both exited 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "wavernn_tpu_torch.train_wavernn",
         "--hp_file", "hp.py", "--device", "cpu"], cwd=ws,
        env=dict(env, RANK=str(k), LOCAL_RANK=str(k)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs
