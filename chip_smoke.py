#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``wavernn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It drives the three paths of the port, each through its hand-written
kernels: copy-synthesis (mel -> wav, the WaveRNN decode kernel), text -> wav
(the Tacotron decoder-step kernel, then the WaveRNN kernel) and the
kernel-measurement path (the matmul floor and the decode kernel's
variants).  Phases, in order; any failure exits non-zero and prints no
result line:

1. CUDA must be available.  Prints the card's name and power limit and the
   toolchain (torch, CUDA, nvcc).
2. Builds the kernels from ``wavernn_tpu_torch/ops/csrc`` with nvcc, one
   process per source, and prints ptxas' registers, shared memory and
   spills for each kernel.
3. Holds the WaveRNN decode kernel against its plain PyTorch version on
   the card, on real conditioning: the full-size golden MOL model (16 fold
   rows x 1024 steps of the golden eval mel) and the committed tiny RAW
   golden: every production configuration (RAW and MOL, int8 recurrent
   matrices on and off, deterministic and sampling, one and two rows per
   CTA).  Deterministic: the first 64 steps within 1e-3 and at least 99%
   of all samples within 2e-2.  Sampling with the shared counter-based
   bits: the first 64 steps within 1e-2.  Each prints its max |d| over all
   steps.  Then both versions are timed at the main path's shape (48 folds
   x 12,100 steps, sampling, int8 recurrent matrices).
4. Drives the copy-synthesis path: ``Generator`` on the golden MOL model,
   f16 mel in, int16 PCM out, folds of 11,000 + 2 x 550 samples, serving
   three requests through prestage/submit/prefetch/collect (the 1200-frame
   golden eval mel and two 1920-frame mels from ``np.random.default_rng(0)``).
   Every result must be int16 of length (T_mel - 1) * 275 and not silence,
   the kernel's launch counter must have risen once per request, and a
   short deterministic request must agree with the same Generator run on
   the CPU (at least 95% of samples within 655 LSB).  Prints kHz per
   request (samples / wall-clock s).
5. Runs the vocoder CLI in a subprocess and parses the WAV it writes.
6. Holds the Tacotron decoder-step kernel against its plain PyTorch
   version on the card, bf16 packing: (a) the committed trained tiny
   Tacotron golden on its eval text, 64 steps; (b) full width,
   ``init_variables(TacotronConfig(), 0)``, a 60-symbol text from
   ``np.random.default_rng(0)`` (L=64), r=2, 750 steps; (c) the same model
   on a 256-symbol text (L=256, more text positions than CTAs), 96 steps.
   The first 64 steps within 1e-3 on mels and scores, at least 99% of mel
   values within 2e-2.  Then both versions are timed at (b), and
   ``tools.tts_phase_spans`` prints the kernel's span per phase at (b) and
   the cost of one bare grid barrier.
7. The TTS gate on the card: the tiny golden through
   ``TTSGenerator(backend="kernel", steps=400, stop_patience=6)`` must pass
   the bench's criteria (monotone >= 0.85, coverage >= 0.7, tempo in
   (0.6, 1.5), mel L1 to ground truth < 1.5 x pinned + 0.1); the port's
   float32 plain decoder on the card must give the pinned 116 frames.
8. Drives the text -> wav path: ``TTSPipeline.stream_synthesize`` with the
   tiny golden Tacotron and the golden MOL WaveRNN, int16 out, three texts.
   Each wav must be int16 of length (frames - 1) * 275 and not silence; the
   launch counters of both kernels are set to 0 just before and read just
   after, and must show the TTS kernel once per 48-step chunk of every
   utterance and the vocoder kernel once per utterance.  Prints kHz per
   request, then the TTS rate at B=1 and full width (bench.py's
   ``tts_frames_per_s_b1``: K=5 submits of a 60-symbol text, 1500 frames
   each, median of 5 reps).
9. Runs the text -> wav CLI in a subprocess and parses the WAV it writes.
10. Holds the matmul floor kernel against its plain version at full width
   (B=64, H=512, 64 steps from a seeded nonzero state): the state within
   1e-5, the discarded columns' sum within 1e-9 of their absolute sum.
11. Holds each ablated decode kernel (sample, gates, sample+gates,
   cond_read, out_write) against the ablated plain version on 8 golden
   rows x 64 steps, deterministic (within 1e-3) and sampling (within
   1e-2); out_write is checked for shape and launch only.
12. Drives the kernel-measurement path: ``tools.kernel_breakdown`` in
   process at full width and reduced depth (B=64, T=2,048, K=2), with the
   launch counters set to 0 just before and read just after; then times
   the floor's plain version at the same shape.
13. The sampling law of the kernel (``tools.kernel_sampling_stats``, 16 x
   4,096 draws): fails if a TV exceeds 4x its noise floor.
14. The fold-geometry probe (targets 16,500 / 11,000 / 8,250 / 5,500, one
   1920-frame request each) and the TTS step probe (full width, 1500
   frames, one pass of one submit per backend).

Float32 matmuls and convolutions run in full float32 (TF32 off).  The last
two lines are the card's ``nvidia-smi`` name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record, where ``bound_ms`` is the least time the card could take for
the timed call (the larger of its operations over the H100's dense peak
for their type and its bytes, each input read once and each output written
once, over 3.35 TB/s) and ``library_ms`` is null: no single PyTorch call
computes any of these T-step recurrences.
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
TACO_DIR = REPO / "tests" / "golden"
TTS_CHUNK = 48   # TTSGenerator's kernel steps per launch
TARGET, OVERLAP = 11_000, 550
SMOKE_DIR = REPO / "build" / "chip_smoke"
# H100 SXM dense peaks at 700 W: bf16 and int8 tensor-core rates, HBM rate
PEAK_BF16, PEAK_INT8, HBM_RATE = 989e12, 1979e12, 3.35e12
BREAKDOWN_B, BREAKDOWN_T, BREAKDOWN_REPS = 64, 2048, 2


def bound(ops, nbytes: int):
    """(bound_ms, bound_by) of a call that does ``ops`` [(operations,
    peak rate)] and must move ``nbytes``."""
    ops_ms = sum(n / rate for n, rate in ops) * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def decode_bound(packed: dict, B: int, T: int, C: int):
    """The decode kernel's bound for B rows x T steps: per row and step the
    bf16 dots (the fused aux matrix counted by its nonzero blocks) and,
    with int8_hh, the two int8 recurrent dots; bytes are the conditioning
    read, the weights and the output."""
    import torch

    H, F = packed["b_hh1_n"].shape[0], packed["b_fc1"].shape[0]
    d, K0 = packed["w_aux"].shape[0] // 3, packed["w_Im"].shape[0]
    n_out = packed["b_fc3"].shape[0]
    hh = 2 * H * 3 * H
    bf16 = (K0 * 4 * H + H * 3 * H + d * (3 * H + 2 * F) + H * F + F * F
            + F * n_out)
    i8 = packed["w_hh1"].dtype == torch.int8
    ops = [(2 * (bf16 + (0 if i8 else hh)) * B * T, PEAK_BF16),
           (2 * (hh if i8 else 0) * B * T, PEAK_INT8)]
    return bound(ops, nbytes(*packed.values()) + B * T * C * 2 + B * T * 4)


def in_turns(run_plain, run_kernel):
    """Run the plain version and the kernel in turns (plain, kernel, kernel,
    plain), each timed with CUDA events.  Returns (plain output, kernel
    output, plain ms, kernel ms), the ms as lists."""
    import torch

    outs, times = {}, {run_plain: [], run_kernel: []}
    for fn in (run_plain, run_kernel, run_kernel, run_plain):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        outs[fn] = fn()
        end.record()
        torch.cuda.synchronize()
        times[fn].append(start.elapsed_time(end))
    return outs[run_plain], outs[run_kernel], times[run_plain], times[run_kernel]


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
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("==")):
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

    def compare(tag, packed, cond, T, cfg, det, seed, rows_per_cta):
        out_k = cuda_decode.decode(packed, cond, T, seed, cfg.mode,
                                   cfg.n_classes, det,
                                   rows_per_cta=rows_per_cta)
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
            for rows in (1, 2):
                for det in (True, False):
                    kind = "deterministic" if det else "sampling"
                    compare(f"{tag} {q} R={rows} {kind}", gen.packed, cond,
                            1024, cfg, det, 0 if det else 1234, rows)

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

    run_k = lambda: cuda_decode.decode(gen.packed, cond, T, 7, "MOL", 30,
                                       False)
    run_p = lambda: cuda_decode.decode_reference(gen.packed, cond, T, 7,
                                                 "MOL", 30, False)
    run_k()  # warm
    out_p, out_k, plain_ms, kernel_ms = in_turns(run_p, run_k)
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

    voc_bound = decode_bound(gen.packed, cond.shape[0], T, cond.shape[2])

    tts = tts_phases(dev, card, wavio, GOLDEN)
    floor = measurement_phases(dev, card, golden_cfg, gen, eval_mel,
                               long_mels[0], errs)

    # -- 15. the record -------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "wavernn_decode",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/decode.cu",
        "replaces": "wavernn_tpu/ops/pallas_decode.py:103",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": voc_bound[0],
        "bound_by": voc_bound[1],
        "library_ms": None,
    }, {
        "name": "tacotron_decode",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/tts_decode.cu",
        "replaces": "wavernn_tpu/ops/pallas_tts.py:237",
        "launches": tts["launches"],
        "max_abs_err": tts["max_abs_err"],
        "ms": tts["ms"],
        "plain_ms": tts["plain_ms"],
        "bound_ms": tts["bound_ms"],
        "bound_by": tts["bound_by"],
        "library_ms": None,
    }, {
        "name": "matmul_floor",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/matmul_floor.cu",
        "replaces": "tools/kernel_breakdown.py:27",
        **floor,
    }]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def tts_phases(dev, card, wavio, voc_weights) -> dict:
    """Phases 6-9: the Tacotron kernel against its plain version, the TTS
    gate, the text -> wav path and its CLI.  Returns the kernel's record."""
    import torch

    from wavernn_tpu_torch.infer.gates import gates_pass, tts_gates
    from wavernn_tpu_torch.infer.pipeline import TTSPipeline
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, from_jax_variables, init_variables,
    )
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops import cuda_decode, cuda_tts
    from wavernn_tpu_torch.ops.tts_decode import (
        MATRICES, extract_tts_decode_weights, init_tts_decode_state,
        pack_tts_weights, packed_dims, tts_decode_reference,
    )
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.tools import tts_phase_spans
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    meta = json.loads((TACO_DIR / "tiny_tacotron_meta.json").read_text())
    pinned = meta["pinned_gates_cpu_xla"]
    blob = load_pytree(TACO_DIR / "tiny_tacotron.msgpack")
    taco = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    taco_cfg = TacotronConfig(**meta["dims"])
    cleaners = ["english_cleaners"]
    eval_seq = text_to_sequence(meta["eval_text"], cleaners)

    # -- 6. the Tacotron kernel against its plain version ----------------
    def kernel_inputs(cfg, variables, seq, L, r):
        model = from_jax_variables(variables, cfg, dev)
        x = torch.zeros(1, L, dtype=torch.long)
        x[0, :len(seq)] = torch.tensor(seq)
        with torch.no_grad():
            enc, encp = model.encode(x.to(dev))
        packed = pack_tts_weights(extract_tts_decode_weights(model), r,
                                  cfg.n_mels)
        return packed, enc[0].contiguous(), encp[0].contiguous()

    def fresh_state(packed, L):
        D, _, H, n_mels, _ = packed_dims(packed)
        return init_tts_decode_state(D, H, L, n_mels, dev)

    errs = []

    def compare(tag, packed, enc, encp, n):
        L = enc.shape[0]
        mk, sk, _, _ = cuda_tts.tts_decode(packed, enc, encp,
                                           fresh_state(packed, L), n)
        torch.cuda.synchronize()
        mp, sp, _, _ = tts_decode_reference(packed, enc, encp,
                                            fresh_state(packed, L), n)
        dm, ds = (mk - mp).abs(), (sk - sp).abs()
        first = max(float(dm[:64].max()), float(ds[:64].max()))
        agree = float((dm <= 2e-2).float().mean())
        ok = first <= 1e-3 and agree >= 0.99
        print(f"tts kernel vs plain [{tag}] L {L} steps {n}: first-64 "
              f"max|d| mel {float(dm[:64].max()):.3g} score "
              f"{float(ds[:64].max()):.3g}, mel within 2e-2 {agree:.5f}, "
              f"max|d| mel {float(dm.max()):.3g} score {float(ds.max()):.3g}"
              f" -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok or not torch.isfinite(mk).all():
            fail(f"the TTS kernel disagrees with its plain version [{tag}]")
        errs.append(first)

    packed, enc, encp = kernel_inputs(taco_cfg, taco, eval_seq, 32,
                                      meta["r"])
    compare("tiny golden, eval text", packed, enc, encp, 64)
    full = TacotronConfig()
    full_vars = init_variables(full, 0)
    rng = np.random.default_rng(0)
    seq60 = [int(i) for i in rng.integers(1, full.num_chars, 60)]
    seq256 = [int(i) for i in rng.integers(1, full.num_chars, 256)]
    packed, enc, encp = kernel_inputs(full, full_vars, seq256, 256, 2)
    compare("full width, r=2, 256 symbols", packed, enc, encp, 96)
    packed, enc, encp = kernel_inputs(full, full_vars, seq60, 64, 2)
    compare("full width, r=2", packed, enc, encp, 750)

    def timed(fn):
        state = fresh_state(packed, enc.shape[0])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(packed, enc, encp, state, 750)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    timed(cuda_tts.tts_decode)  # warm
    plain_ms, kernel_ms = [], []
    for fn, acc in ((tts_decode_reference, plain_ms),
                    (cuda_tts.tts_decode, kernel_ms),
                    (cuda_tts.tts_decode, kernel_ms),
                    (tts_decode_reference, plain_ms)):
        acc.append(timed(fn))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    # its bound: per step every matrix once, the folded location conv, the
    # energies' v and the context at each of the L text positions
    L, D = enc.shape[0], packed["W_q"].shape[0]
    macs = (sum(packed[k].numel() for k in MATRICES if k not in ("M_loc", "v"))
            + L * (packed["M_loc"].numel() + 2 * D))
    r, n_mels = 2, full.n_mels
    tts_bound = bound([(2 * macs * 750, PEAK_BF16)],
                      nbytes(*packed.values(), enc, encp)
                      + 750 * (r * n_mels + L + 1) * 4)
    print(f"tts decode time at L {enc.shape[0]}, r=2, 750 steps: kernel "
          f"{[round(x, 3) for x in kernel_ms]} ms ({k_ms * 1e3 / 750:.2f} "
          f"us/step), plain {[round(x, 1) for x in plain_ms]} ms "
          f"({p_ms * 1e3 / 750:.2f} us/step) | {card}", flush=True)
    spans = tts_phase_spans.main(["--steps", "750", "--L", "64"])
    if spans["max_abs_err"] > 1e-3:
        fail("the spans launch disagrees with the plain version")

    # -- 7. the TTS gate through the kernel ------------------------------
    gt = np.load(TACO_DIR / "tiny_tacotron_gt_mel.npy") * 8.0 - 4.0
    frames = {}
    for backend in ("kernel", "plain"):
        gen = TTSGenerator(taco_cfg, taco, dev, steps=400, stop_patience=6,
                           backend=backend)
        mel, _, attn = gen(eval_seq, r=meta["r"])
        gates = tts_gates(mel, attn, len(eval_seq), gt)
        frames[backend] = mel.shape[1]
        print(f"tts gate [{backend}{', bf16' if backend == 'kernel' else ', f32'}]"
              f": {gates} -> {'pass' if gates_pass(gates, pinned['mel_gt_l1']) else 'FAIL'}",
              flush=True)
        if not gates_pass(gates, pinned["mel_gt_l1"]):
            fail(f"the TTS gate fails through the {backend} decoder")
    print(f"tts frames: kernel {frames['kernel']}, f32 plain "
          f"{frames['plain']} (pinned {pinned['frames']}), delta "
          f"{frames['kernel'] - frames['plain']}")
    if frames["plain"] != pinned["frames"]:
        fail(f"the f32 plain decoder gave {frames['plain']} frames, pinned "
             f"{pinned['frames']}")

    # -- 8. the text -> wav path -----------------------------------------
    voc_blob = load_pytree(voc_weights)
    voc_vars = {"params": voc_blob["params"],
                "batch_stats": voc_blob["batch_stats"]}
    voc_cfg = WaveRNNConfig()
    pipe = TTSPipeline(taco_cfg, taco, voc_cfg, voc_vars, cleaners,
                       r=meta["r"], device=dev, tts_steps=400,
                       output_dtype="int16", input_dtype="float16")
    texts = ["abcdeabcde", "edcba abcde", "abcde"]
    want_frames, want_tts = [], 0
    for t in texts:                      # the kernel decode is deterministic
        m = pipe.tts(text_to_sequence(t, cleaners), r=meta["r"])[0]
        want_frames.append(m.shape[1])
        want_tts += -(-(m.shape[1] // meta["r"]) // TTS_CHUNK)
    list(pipe.stream_synthesize(texts[:1], mu_law=False))          # warm
    torch.cuda.synchronize()
    cuda_tts.tts_decode.launches = 0
    cuda_decode.decode.launches = 0
    wavs, secs = [], []
    for i, t in enumerate(texts):        # one request after the other
        t1 = time.perf_counter()
        wavs += list(pipe.stream_synthesize([t], mu_law=False, seed=i))
        secs.append(time.perf_counter() - t1)
    tts_launches = cuda_tts.tts_decode.launches
    voc_launches = cuda_decode.decode.launches
    total = sum(secs)
    for i, (wav, f) in enumerate(zip(wavs, want_frames)):
        n = (f - 1) * voc_cfg.hop_length
        if wav.dtype != np.int16 or wav.shape != (n,):
            fail(f"text {i}: got {wav.dtype} {wav.shape}, want int16 ({n},)")
        std = float(np.std(wav.astype(np.float64)))
        if not std > 0.01 * 32767:
            fail(f"text {i}: silence (std {std:.1f} LSB)")
        print(f"text->wav request {i} {texts[i]!r}: {f} frames -> {n} int16 "
              f"samples in {secs[i]:.3f} s = {n / secs[i] / 1e3:.2f} kHz "
              f"(std {std:.0f} LSB)", flush=True)
    n_all = sum(len(w) for w in wavs)
    print(f"text->wav path: {len(wavs)} requests, {n_all} samples in "
          f"{total:.3f} s = {n_all / total / 1e3:.2f} kHz; launches: tts "
          f"{tts_launches} (want {want_tts}), vocoder {voc_launches} "
          f"(want {len(texts)}) | {card}")
    if tts_launches != want_tts or voc_launches != len(texts):
        fail("the text->wav path did not run through both kernels")

    # TTS rate at B=1, full width (bench.py's tts_frames_per_s_b1)
    gen = TTSGenerator(full, full_vars, dev, steps=1500)
    gen(seq60, r=2)                       # warm (untrained: runs to the cap)
    rates = []
    for _ in range(5):
        t1 = time.perf_counter()
        outs = [gen.collect(gen.submit(seq60, r=2)) for _ in range(5)]
        dt = time.perf_counter() - t1
        rates.append(sum(o[0].shape[1] for o in outs) / dt)
    print(f"tts B=1 full width, 1500 frames, K=5 submits: "
          f"{[round(x, 1) for x in rates]} frames/s, median "
          f"{float(np.median(rates)):.1f} | {card}", flush=True)

    # -- 9. the text -> wav CLI ------------------------------------------
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    d = meta["dims"]
    hp_file = SMOKE_DIR / "hp_tts.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"tts_{k} = {d[k]!r}\n" for k in (
            "embed_dims", "encoder_dims", "decoder_dims", "postnet_dims",
            "encoder_K", "lstm_dims", "postnet_K", "num_highways"))
        + "tts_schedule = [(2, 1e-4, 10_000, 8)]\n")
    out_dir = SMOKE_DIR / "tts_cli_out"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "wavernn_tpu_torch.gen_tacotron",
         "--input_text", meta["eval_text"], "--tts_weights",
         str(TACO_DIR / "tiny_tacotron.msgpack"), "--hp_file", str(hp_file),
         "--output_dir", str(out_dir), "wavernn", "--voc_weights",
         str(voc_weights)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    print("tts cli: " + " | ".join(proc.stdout.strip().splitlines()[-3:]))
    if proc.returncode != 0:
        fail(f"TTS CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    wavs = sorted(out_dir.glob("__input_*.wav"))
    if len(wavs) != 1:
        fail(f"TTS CLI wrote {wavs}")
    x, sr = wavio.read_wav_raw(wavs[0])
    if sr != 22050 or x.size == 0 or x.size % voc_cfg.hop_length:
        fail(f"TTS CLI WAV: sr {sr}, shape {x.shape}")
    print(f"tts cli: {wavs[0].name} parses: {x.shape[0]} samples at {sr} Hz")
    return {"launches": tts_launches, "max_abs_err": max(errs),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": tts_bound[0],
            "bound_by": tts_bound[1]}


def measurement_phases(dev, card, cfg, gen, eval_mel, long_mel,
                       decode_errs: list) -> dict:
    """Phases 10-14: the floor and the ablated decode kernels against their
    plain versions, the kernel-measurement path, the sampling law, the
    fold and TTS probes.  Returns the floor's record; the ablated decode
    comparisons' errors go to ``decode_errs``."""
    import torch

    from wavernn_tpu_torch.ops import cuda_decode, cuda_tts
    from wavernn_tpu_torch.ops import matmul_floor as mf
    from wavernn_tpu_torch.tools import fold_geometry_probe, tts_step_probe
    from wavernn_tpu_torch.tools.kernel_breakdown import run_breakdown
    from wavernn_tpu_torch.tools.kernel_sampling_stats import sampling_stats

    # -- 10. the matmul floor against its plain version ------------------
    B, H = BREAKDOWN_B, mf.H_FLOOR
    fw = mf.make_floor_weights(0, device=dev)
    h0 = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (B, H)).astype(np.float32)).to(dev)
    floor_errs = []

    def floor_check(tag, got, want):
        (h, sink, sabs), (hr, sr, sar) = got, want
        dh = float((h - hr).abs().max())
        ds = float(((sink - sr).abs() / sar).max())
        dsa = float(((sabs - sar).abs() / sar).max())
        ok = dh <= 1e-5 and ds <= 1e-9 and dsa <= 1e-9
        print(f"floor kernel vs plain [{tag}]: max|d| h {dh:.3g} (|h| max "
              f"{float(hr.abs().max()):.3f}), sink |d|/sum|.| {ds:.3g}, "
              f"sink_abs {dsa:.3g} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok or not torch.isfinite(h).all():
            fail(f"the floor kernel disagrees with its plain version [{tag}]")
        floor_errs.append(dh)

    got = mf.matmul_floor(fw, B, 64, h0)
    torch.cuda.synchronize()
    floor_check(f"B {B} H {H} 64 steps, nonzero h0", got,
                mf.matmul_floor_reference(fw, B, 64, h0))

    # -- 11. the ablated decode kernels against their plain versions -----
    staged = gen.prestage(eval_mel, batched=True, target=TARGET,
                          overlap=OVERLAP)
    cond = gen.fold_conditioning(staged)[0][:8, :64].contiguous()
    for ablate in cuda_decode.KERNEL_ABLATIONS[1:]:
        name = "+".join(sorted(ablate))
        for det in (True, False):
            n = cuda_decode.decode.launches
            out_k = cuda_decode.decode(gen.packed, cond, 64, 11, cfg.mode,
                                       cfg.n_classes, det, ablate=ablate)
            torch.cuda.synchronize()
            tag = f"ablate {name}, {'deterministic' if det else 'sampling'}"
            if (cuda_decode.decode.launches != n + 1
                    or out_k.shape != (8, 64)):
                fail(f"ablated kernel [{tag}]: shape {tuple(out_k.shape)}")
            if "out_write" in ablate:
                print(f"decode kernel [{tag}]: launched, shape "
                      f"{tuple(out_k.shape)} (output unspecified)")
                continue
            out_p = cuda_decode.decode_reference(
                gen.packed, cond, 64, 11, cfg.mode, cfg.n_classes, det,
                ablate=ablate)
            d = float((out_k - out_p).abs().max())
            ok = d <= (1e-3 if det else 1e-2)
            print(f"decode kernel vs plain [{tag}] rows 8 steps 64: max|d| "
                  f"{d:.3g} -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok or not torch.isfinite(out_k).all():
                fail(f"ablated kernel disagrees with its plain version "
                     f"[{tag}]")
            decode_errs.append(d)

    # -- 12. the kernel-measurement path ----------------------------------
    torch.cuda.synchronize()
    mf.matmul_floor.launches = 0
    cuda_decode.decode.launches = 0
    cuda_tts.tts_decode.launches = 0
    rec = run_breakdown(B, BREAKDOWN_T, dev, BREAKDOWN_REPS)
    torch.cuda.synchronize()
    floor_launches = mf.matmul_floor.launches
    decode_launches = cuda_decode.decode.launches
    per_variant = 1 + 2 * BREAKDOWN_REPS
    print(f"kernel-measurement path: launches floor {floor_launches}, "
          f"decode {decode_launches} (want {per_variant} and "
          f"{per_variant * len(rec['variants'])}) | {card}")
    if (floor_launches != per_variant
            or decode_launches != per_variant * len(rec["variants"])):
        fail("the kernel-measurement path did not run through its kernels")

    T = BREAKDOWN_T
    out_p, out_k, plain_ms, kernel_ms = in_turns(
        lambda: mf.matmul_floor_reference(fw, B, T, h0),
        lambda: mf.matmul_floor(fw, B, T, h0))
    floor_check(f"B {B} H {H} {T} steps, nonzero h0", out_k, out_p)
    k_ms, p_ms = rec["floor"]["ms_per_launch"], float(np.mean(plain_ms))
    floor_bound = bound([(2 * mf.floor_macs(B, T), PEAK_BF16)],
                        nbytes(*fw.values(), h0, *out_k))
    print(f"floor time at B {B} x {T} steps: kernel {k_ms:.3f} ms "
          f"(breakdown, best of 2 x {BREAKDOWN_REPS}; in turns "
          f"{[round(x, 3) for x in kernel_ms]}), plain "
          f"{[round(x, 1) for x in plain_ms]} ms; bound {floor_bound[0]:.4f} "
          f"ms ({floor_bound[1]}) | {card}", flush=True)

    # -- 13. the sampling law ---------------------------------------------
    stats = sampling_stats(16, 4096, dev)
    print("sampling law (kernel, 16 x 4096 draws): " + json.dumps(
        {k: (round(v, 5) if isinstance(v, float) else v)
         for k, v in stats.items()}), flush=True)
    if not stats["ok"]:
        fail("a sampling-law TV exceeds 4x its noise floor")

    # -- 14. the fold-geometry and TTS step probes ------------------------
    curve = fold_geometry_probe.probe(
        gen, long_mel, [16500, 11000, 8250, 5500], OVERLAP, reps=1, utts=1)
    print(f"fold curve (1920 frames, overlap {OVERLAP}): "
          f"{json.dumps(curve)} | {card}", flush=True)
    if not all(np.isfinite(c["khz"]) and c["khz"] > 0 for c in curve):
        fail("the fold probe gave no rate")
    tts_step_probe.main(["1500", "1", "--passes", "1", "--device",
                         str(dev)])
    return {"launches": floor_launches, "max_abs_err": max(floor_errs),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": floor_bound[0],
            "bound_by": floor_bound[1], "library_ms": None}


if __name__ == "__main__":
    main()
