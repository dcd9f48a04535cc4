#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``wavernn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. CUDA must be available.  Prints the card's name and power limit and the
   toolchain (torch, CUDA, nvcc).
2. Builds the decode kernel from ``wavernn_tpu_torch/ops/csrc`` with nvcc.
3. Holds the CUDA kernel against its plain PyTorch version on the card, on
   real conditioning: the full-size golden MOL model (16 fold rows x 1024
   steps of the golden eval mel) and the committed tiny RAW golden.
   Deterministic decode, int8 recurrent matrices on and off: the first 64
   steps within 1e-3 and at least 99% of all samples within 2e-2.  Sampling
   with the shared counter-based bits: the first 64 steps within 1e-2 (the
   rest is printed).  Then both versions are timed at the main path's shape
   (48 folds x 12,100 steps, sampling, int8 recurrent matrices).
4. Drives the main path: ``Generator`` on the golden MOL model, f16 mel in,
   int16 PCM out, folds of 11,000 + 2 x 550 samples, serving three requests
   through prestage/submit/prefetch/collect (the 1200-frame golden eval mel
   and two 1920-frame mels from ``np.random.default_rng(0)``).  Every
   result must be int16 of length (T_mel - 1) * 275 and not silence, the
   kernel's launch counter must have risen once per request, and a short
   deterministic request must agree with the same Generator run on the CPU
   (at least 95% of samples within 655 LSB).  Prints kHz per request
   (samples / wall-clock s).
5. Runs the vocoder CLI in a subprocess and parses the WAV it writes.

Float32 matmuls and convolutions run in full float32 (TF32 off).  The last
two lines are the card's ``nvidia-smi`` name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "bench_assets" / "wavernn_mol_golden.msgpack"
TINY_RAW = REPO / "tests" / "golden" / "tiny_wavernn_raw.msgpack"
TARGET, OVERLAP = 11_000, 550
SMOKE_DIR = REPO / "build" / "chip_smoke"


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    from wavernn_tpu_torch.ops.build import nvcc_path

    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def main():
    import torch

    # -- 1. the card and the toolchain ----------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    from wavernn_tpu_torch import set_float32_policy
    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops import build, cuda_decode
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    set_float32_policy()
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"card: {card}")
    print(f"toolchain: python {sys.version.split()[0]} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"{nvcc_version()} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} conv "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    cuda_decode.decode.launches = 0

    def variables_of(path):
        blob = load_pytree(path)
        return {"params": blob["params"], "batch_stats": blob["batch_stats"]}

    golden_cfg = WaveRNNConfig()
    golden = variables_of(GOLDEN)
    raw_cfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                            res_out_dims=16, res_blocks=2, mode="RAW")
    tiny_raw = variables_of(TINY_RAW)

    # -- 3. kernel against plain ----------------------------------------
    errs = []

    def compare(tag, packed, cond, T, cfg, det, seed=0):
        out_k = cuda_decode.decode(packed, cond, T, seed, cfg.mode,
                                   cfg.n_classes, det)
        torch.cuda.synchronize()
        out_p = cuda_decode.decode_reference(packed, cond, T, seed, cfg.mode,
                                             cfg.n_classes, det)
        d = (out_k - out_p).abs()
        first = float(d[:, :64].max())
        agree = float((d <= 2e-2).float().mean())
        ok = (first <= 1e-3 and agree >= 0.99) if det else first <= 1e-2
        print(f"kernel vs plain [{tag}] rows {cond.shape[0]} steps {T}: "
              f"first-64 max|d| {first:.3g}, within 2e-2 {agree:.5f}, "
              f"max|d| {float(d.max()):.3g} -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not torch.isfinite(out_k).all() or not ok:
            fail(f"kernel disagrees with its plain version [{tag}]")
        errs.append(first)

    def real_cond(gen, mel, rows, steps, target, overlap):
        staged = gen.prestage(mel, batched=True, target=target,
                              overlap=overlap)
        cond, _ = gen.fold_conditioning(staged)
        if cond.shape[0] < rows or cond.shape[1] < steps:
            fail(f"conditioning {tuple(cond.shape)} too small")
        return cond[:rows, :steps].contiguous()

    eval_mel = np.load(REPO / "bench_assets" / "golden_eval_mel.npy")
    raw_mel = np.load(REPO / "tests" / "golden" / "tiny_wavernn_raw_mel.npy")
    for tag, cfg, v, mel, geom in (
            ("golden MOL", golden_cfg, golden, eval_mel, (TARGET, OVERLAP)),
            ("tiny RAW", raw_cfg, tiny_raw, raw_mel, (1000, 12))):
        for int8_hh in (True, False):
            gen = Generator(cfg, v, device=dev, fold_bucket=16,
                            int8_hh=int8_hh)
            cond = real_cond(gen, mel, 16, 1024, *geom)
            q = "int8_hh" if int8_hh else "bf16"
            compare(f"{tag} {q} deterministic", gen.packed, cond, 1024, cfg,
                    True)
            if int8_hh:
                compare(f"{tag} {q} sampling", gen.packed, cond, 1024, cfg,
                        False, seed=1234)

    # timing at the main path's shape: a 1920-frame mel, 48 folds
    rng = np.random.default_rng(0)
    long_mels = [rng.uniform(0, 1, (80, 1920)).astype(np.float32)
                 for _ in range(2)]
    gen = Generator(golden_cfg, golden, device=dev, fold_bucket=16,
                    input_dtype="float16", output_dtype="int16")
    staged = gen.prestage(long_mels[0], batched=True, target=TARGET,
                          overlap=OVERLAP)
    cond, T = gen.fold_conditioning(staged)
    print(f"main-path kernel shape: cond {tuple(cond.shape)} "
          f"{cond.dtype}, {T} steps")

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    run_k = lambda: cuda_decode.decode(gen.packed, cond, T, 7, "MOL", 30,
                                       False)
    run_p = lambda: cuda_decode.decode_reference(gen.packed, cond, T, 7,
                                                 "MOL", 30, False)
    run_k()  # warm
    plain_ms, kernel_ms = [], []
    for fn, acc in ((run_p, plain_ms), (run_k, kernel_ms),
                    (run_k, kernel_ms), (run_p, plain_ms)):
        out, ms = timed(fn)
        acc.append(ms)
        if fn is run_k:
            out_k = out
        else:
            out_p = out
    d = (out_k - out_p).abs()
    main_err = float(d[:, :64].max())
    print(f"kernel vs plain [main path, sampling int8_hh] rows "
          f"{cond.shape[0]} steps {T}: first-64 max|d| {main_err:.3g}, "
          f"within 2e-2 {float((d <= 2e-2).float().mean()):.5f}")
    if main_err > 1e-2 or not torch.isfinite(out_k).all():
        fail("kernel disagrees with its plain version at the main shape")
    errs.append(main_err)
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    print(f"decode time at {cond.shape[0]} x {T}: kernel "
          f"{[round(x, 3) for x in kernel_ms]} ms "
          f"({k_ms * 1e3 / T:.2f} us/step), plain "
          f"{[round(x, 1) for x in plain_ms]} ms "
          f"({p_ms * 1e3 / T:.2f} us/step) | {card}", flush=True)

    # -- 4. the main path -----------------------------------------------
    requests = [eval_mel] + long_mels
    gen(requests[0], batched=True, target=TARGET, overlap=OVERLAP,
        mu_law=False)                                   # warm
    torch.cuda.synchronize()
    cuda_decode.decode.launches = 0
    rates = []
    for i, m in enumerate(requests):
        t0 = time.perf_counter()
        staged = gen.prestage(m, batched=True, target=TARGET,
                              overlap=OVERLAP)
        handle = gen.submit(staged, batched=True, target=TARGET,
                            overlap=OVERLAP, mu_law=False, seed=i)
        gen.prefetch(handle)
        wav = gen.collect(handle)
        secs = time.perf_counter() - t0
        n = (m.shape[1] - 1) * golden_cfg.hop_length
        if wav.dtype != np.int16 or wav.shape != (n,):
            fail(f"request {i}: got {wav.dtype} {wav.shape}, want int16 "
                 f"({n},)")
        std = float(np.std(wav.astype(np.float64)))
        if not std > 0.01 * 32767:
            fail(f"request {i}: silence (std {std:.1f} LSB)")
        rates.append(n / secs / 1e3)
        print(f"request {i}: {m.shape[1]} frames -> {n} int16 samples in "
              f"{secs:.3f} s = {rates[-1]:.1f} kHz (std {std:.0f} LSB)",
              flush=True)
    launches = cuda_decode.decode.launches
    print(f"main path: median {float(np.median(rates)):.1f} kHz over "
          f"{len(rates)} requests, decode kernel launches {launches} | "
          f"{card}")
    if launches < len(requests):
        fail(f"decode kernel launched {launches} times for "
             f"{len(requests)} requests")

    # a short deterministic request against the same Generator on the CPU
    kw = dict(fold_bucket=16, frame_bucket=16, deterministic=True,
              input_dtype="float16", output_dtype="int16")
    short = eval_mel[:, 300:312]
    outs = [Generator(golden_cfg, golden, device=d, **kw)(
        short, batched=True, target=200, overlap=28, mu_law=False)
        for d in (dev, "cpu")]
    lsb = np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32))
    agree = float(np.mean(lsb <= 655))
    print(f"cuda vs cpu Generator, deterministic, {len(outs[0])} samples: "
          f"{agree:.4f} within 655 LSB, max {int(lsb.max())} LSB")
    if outs[0].shape != outs[1].shape or agree < 0.95:
        fail("the CUDA Generator disagrees with the CPU reference")

    # -- 5. the CLI -----------------------------------------------------
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    mel_path = SMOKE_DIR / "eval_mel.npy"
    np.save(mel_path, eval_mel)
    out_dir = SMOKE_DIR / "cli_out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "wavernn_tpu_torch.gen_wavernn",
         "--file", str(mel_path), "--voc_weights", str(GOLDEN),
         "--output_dir", str(out_dir), "--hp_file",
         str(REPO / "hparams.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    print("cli: " + " | ".join(proc.stdout.strip().splitlines()[-2:]))
    if proc.returncode != 0:
        fail(f"CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    wavs = sorted(out_dir.glob("__eval_mel__*.wav"))
    if len(wavs) != 1:
        fail(f"CLI wrote {wavs}")
    x, sr = wavio.read_wav_raw(wavs[0])
    if sr != 22050 or x.shape != ((eval_mel.shape[1] - 1) * 275,):
        fail(f"CLI WAV: sr {sr}, shape {x.shape}")
    print(f"cli: {wavs[0].name} parses: {x.shape[0]} samples at {sr} Hz")

    # -- 6. the record --------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "wavernn_decode",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/decode.cu",
        "replaces": "wavernn_tpu/ops/pallas_decode.py:103",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
