#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``wavernn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It drives the paths of the port, each through its hand-written kernels:
copy-synthesis (mel -> wav, the WaveRNN decode kernel), text -> wav (the
Tacotron decoder-step kernel, then the WaveRNN kernel), the
kernel-measurement path (the matmul floor and the decode kernel's
variants) and the vocoder's serving paths (the MCD gate, the wire
formats, co-batching, streaming and the multi-session StreamServer, all
through the WaveRNN kernel, whose int8 feed-forward variant ``int8_ff``
the width policy turns on), vocoder training and Tacotron training (whose
trained model generates through both kernels), data parallelism
(every serving path over a device mesh, one decode per shard, and
multi-process training), and the modules through which weights enter and
leave the port (the DeepMind WaveRNN and its NB1 example, the reference
checkpoint converters both ways, and ``quick_start`` through both
kernels), the two kernels' opt-in int8 variants (``int8_gates`` through
the ``gen_int8`` path, ``int8_lstm``), and the quality and golden tools
(``wavernn_tpu_torch/tools/``: ``check_mel_parity``, ``kernel_quality``,
``tts_kernel_parity``, ``tts_train_probe``, ``train_golden``), and the
examples (``wavernn_tpu_torch/examples/``: NB2, NB3, NB4, the pruning
example, the serving demo and the end-to-end TTS example), and the
vocoder trainer's two JAX training options (sequence-chunked BPTT and
bf16 GRU matmuls).  Phases, in order; any failure exits non-zero and
prints no result line:

1. CUDA must be available.  Prints the card's name and power limit and the
   toolchain (torch, CUDA, nvcc).
2. Builds the kernels from ``wavernn_tpu_torch/ops/csrc`` with nvcc, one
   process per source, and prints ptxas' registers, shared memory and
   spills for each kernel.
3. Holds the WaveRNN decode kernel against its plain PyTorch version on
   the card, on real conditioning: the full-size golden MOL model (16 fold
   rows x 1024 steps of the golden eval mel) and the committed tiny RAW
   golden: every production configuration (RAW and MOL, int8 recurrent
   matrices on and off, deterministic and sampling) on both designs (the
   cluster design, ``csrc/decode_cluster.cu``, and the row design,
   ``csrc/decode.cu``, at one and two rows per CTA; the plain version runs
   once for the three).
   Deterministic: the first 64 steps within 1e-3 and at least 99%
   of all samples within 2e-2.  Sampling with the shared counter-based
   bits: the first 64 steps within 1e-2.  Each prints its max |d| over all
   steps.  Then the main path's Generator calibrates its int8_ff bounds on
   the first 1920-frame request (``ff_ranges``, its wall time printed), and
   both variants (bf16 and int8 feed-forward matrices) on both designs and
   their plain versions are timed at the main path's shape (48 folds x
   12,100 steps, sampling, int8 recurrent matrices) in turns: plain,
   cluster, row, int8_ff cluster, int8_ff row, int8_ff row, int8_ff
   cluster, row, cluster, int8_ff plain.  Then the cluster design's
   ``decode_cluster_spans`` instantiation prints the median span of each
   part of a step at 48 rows x 2,048 (int8_ff).
4. Drives the copy-synthesis path: ``Generator`` on the golden MOL model,
   f16 mel in, int16 PCM out, folds of 11,000 + 2 x 550 samples, serving
   three requests through prestage/submit/prefetch/collect (the 1200-frame
   golden eval mel and two 1920-frame mels from ``np.random.default_rng(0)``).
   Every result must be int16 of length (T_mel - 1) * 275 and not silence,
   the kernel's launch counter must have risen once per request, and a
   short deterministic request must agree with the same Generator run on
   the CPU (at least 95% of samples within 655 LSB).  Prints kHz per
   request (samples / wall-clock s).
5. Runs the vocoder CLI in process and parses the WAV it writes.
6. Holds the Tacotron decoder-step kernel against its plain PyTorch
   version on the card, bf16 packing: (a) the committed trained tiny
   Tacotron golden on its eval text, 64 steps; (b) full width,
   ``init_variables(TacotronConfig(), 0)``, a 60-symbol text from
   ``np.random.default_rng(0)`` (L=64), r=2, 750 steps; (c) the same model
   on a 256-symbol text (L=256, more text positions than CTAs), 96 steps.
   The first 64 steps within 1e-3 on mels and scores, at least 99% of mel
   values within 2e-2.  Then both versions are timed at (b), and
   ``tools.tts_phase_spans`` prints the kernel's span per phase at (b) and
   the cost of one bare grid barrier.  The kernel pinned to each
   placement of the L-sized state (shared memory, the global workspace)
   at L = 64 (b's inputs, 750 steps) and at the shared placement's
   longest text (``cuda_tts.shared_text_limit``: 2,918 symbols at full
   width on 132 CTAs; 96 steps): the same bits, each timed in turns.
   Then texts past the shared placement's limit (the global placement:
   the L-sized state in a workspace in global memory): (c)'s model and
   criteria one symbol past the limit (2,919), at 4,096 and 16,384 (bf16)
   and one past int8_lstm's limit (3,829, every value equal), r=2, 96
   steps, each max |d| printed and each L timed; the spans launch at
   16,384 and at int8_lstm's 3,829, printed beside (b)'s; and a
   3,000-symbol text through
   ``TTSGenerator(backend="kernel", steps=480)``, whose global launches
   (set to 0 just before) must be one per 48-step chunk, against the same
   generator with the kernel's plain version in its place (the criteria
   above on the first 128 frames) and the float32 plain backend (a mean
   mel |d| under 0.05 over the first 128 frames, JAX's bound for its bf16
   kernel against the float32 rollout).
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
9. Runs the text -> wav CLI in process and parses the WAV it writes.
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

Phases 15-19 run the golden MOL at full width, f16 in, int16 out,
``fold_bucket=16``, target 11,000 / overlap 550, unless they say otherwise:

15. The MCD gate: ``infer.eval.copy_synthesis_mcd`` on the golden eval mel
   (1200 frames), float64 out, sampling, seeds 0-2; the mean must be below
   ``mcd_scan_mean + max(4 * mcd_scan_spread, 3)`` of
   ``bench_assets/golden_meta.json`` (892.40), with bf16 feed-forward
   matrices (phase 30 runs it with the int8 ones).  Prints the
   deterministic MCD beside it.
16. The wire formats, deterministic: uint8 in must be bit-equal to float32
   in of the requantized mel; mulaw8 out within 1 label of
   ``dsp.audio.encode_mu_law`` of the float path.  Prints the MCD of
   bfloat16 in and of mulaw8 out (sampling).
17. Co-batching on five ``uniform(0, 1, (80, 1920))`` mels from
   ``np.random.default_rng(0)``: the kernel against its plain version on
   the co-batched conditioning (240 rows, first 64 steps, both modes),
   the 240-row launch timed on the cluster design and the row design at
   one and two rows per CTA (in turns, CUDA events), then three interleaved passes of one-shot ``generate_batch``,
   the pipelined prestage/submit/prefetch/collect and the co-batched
   steady state (three serves, each submitted before the one before it is
   collected), each pass's kHz printed; each co-batched serve must be one
   decode launch, and under int8_ff "auto" each launch must take the pack
   the policy gives its width.  Deterministic co-batched utterances against their solo
   submits: at least 99% of samples within 655 LSB.
18. Streaming, a 1920-frame mel: ``stream`` with group 32 / first group 4
   and with group 48, five runs each (``stream_khz`` and ``ttfc_ms``,
   medians); each run's launches must equal its fold spans; a
   deterministic stream must be byte-equal to ``stream_oneshot``.
19. The StreamServer: four deterministic sessions of 1920 / 1200 / 600 /
   300 frames at group 16, capacity 4, width 64 and 132; each session must
   be byte-equal to its solo ``stream`` and the launches below the solo
   streams' sum; under int8_ff "auto" every launch takes the pack the
   policy gives it.  Prints the aggregate kHz.

Phases 20-23 serve text over both kernels and run the Griffin-Lim
vocoder:

20. The two-stage server: ``TTSStreamServer`` on the tiny golden Tacotron
   and the golden MOL, deterministic, f16 in, int16 out, three texts,
   group 16.  Each session must be byte-equal to its solo two-stage stream
   (text -> mel -> ``Generator.stream``), the vocoder launches below the
   solo streams' sum and the TTS launches equal to the 48-step chunks of
   all sessions.  Prints the aggregate kHz and each session's time to its
   first chunk.
21. The HTTP daemon at full width, in process on a loopback port:
   ``SynthesisService`` over ``init_variables(TacotronConfig(), 0)``
   (untrained, so it runs to its cap: ``tts_steps=800``, r=2, 400 decoder
   steps, ~10 s of audio a request) and the golden MOL, f16 in, int16 out,
   sampling, 4 sessions.  ``/health``, one warm-up of each endpoint, then
   four concurrent ``/synthesize`` and four concurrent ``/stream`` of
   distinct seeded texts; each WAV must parse and hold int16 of the length
   of its text's mel, not silence; both kernels' counters are set to 0
   just before the requests and must have risen (the TTS kernel once per
   48-step chunk of every request).  Prints the aggregate kHz of each
   batch of four (samples / wall s), the latency of each request, the
   TTFB of each stream and ``/health``'s ``launches``; then a second
   batch of four streams under ``torch.profiler`` gives the card's busy
   share (the union of its kernels' spans over the batch's wall time) and
   its longest idle gap.
22. The serve CLI in a subprocess: ``python -m wavernn_tpu_torch.serve``
   with the tiny golden Tacotron, the golden MOL and ``--deterministic``
   on a free port.  ``/health`` is polled; ``/synthesize`` and ``/stream``
   of one text must give byte-equal PCM; after SIGTERM the process must
   exit 0.
23. Griffin-Lim on the card: ``dsp.torch_audio.reconstruct_waveform`` of
   the golden eval mel, 32 iterations, timed; the same NNLS and
   Griffin-Lim on the card and on the CPU from one initial phase must
   agree within 1e-3 relative RMS; a 440 Hz tone must come back with its
   spectral centroid within 50 Hz of 440 and over 80% of its energy in
   200-900 Hz; ``gen_tacotron ... griffinlim`` in process must write a
   WAV that parses.

Phases 24-26 train the full-width MOL WaveRNN (``hparams.py``: 512-wide
GRUs and FCs, batch 32, 1,375-sample windows, Adam at 1e-4, clip 4):

24. One train step on the card against the same step on the CPU: the
   seeded model, B=4, two steps on batches from
   ``np.random.default_rng(0)``, TF32 off.  Step 1: the loss within 1e-5
   relative, the BatchNorm running statistics within 1e-5; step 2: the
   loss within 1e-4 relative.  Step 1's gradients in float64 on both:
   each within 1e-9 relative L2, and the same ReLU masks; in float32 with
   every ReLU mask pinned to the float64 forward's: each within 1e-4.
   The plain step's float32 gradients: each within 5e-4 and all together
   within 2e-4, as a mask that rounding flips at fc1 or fc2 (printed per
   ReLU site and device) moves the conditioning gradients by ~1e-4.
25. The training path end to end on a synthetic corpus made here: 72
   utterances of 44,000 samples (2.0 s, 160 hops) from
   ``np.random.default_rng(0)``, sines of random pitch with harmonics plus
   noise, written with ``metadata.csv``.  (a) ``wavernn_tpu_torch.preprocess
   --num_workers 1``; (b)
   ``voc_train_loop`` in process to step 30, a checkpoint with one
   audition every 15 steps: every loss it fetched must be finite (the
   averages it logs), the decode kernel's counter, set to 0 just before,
   must read 2 just after (one launch per audition), each audition must
   be int16 PCM of its
   utterance's length and not silence, a latest and a named pair must
   exist and the written weights must equal the model's; (c)
   ``wavernn_tpu_torch.train_wavernn`` must restore that pair, start at
   step 30 and stop at 40; (d) ``wavernn_tpu_torch.gen_wavernn`` on its
   latest weights must write a WAV that parses.  The CLIs of (a), (c) and
   (d) run in process through their ``main(argv)`` (``cli_output``: the
   hp singleton cleared around each, its standard output captured).
26. Training rate, all on one fixed batch of the corpus: 3 warm-up steps,
   then ``voc_train_ms_per_step`` as the median of 20 steps timed by CUDA
   events, and samples/s; the last loss must be below the first.  Then 5
   steps under ``torch.profiler`` (the card's busy share and its top
   kernels by time), and 10 steps with pruning engaged (masks every 5
   steps, a 20-step ramp from the first) between two runs of 5 plain
   steps: both medians, the measured sparsity, and pruned weights that
   must be exactly zero.

Phases 27-30 run the decode kernel's int8 feed-forward variant at full
width (the golden MOL, f16 in, int16 out, ``fold_bucket=16``):

27. The variant against its plain version, as phase 3: the golden MOL (16
   rows x 1024 steps of the eval mel) and the tiny RAW golden, each with
   bounds calibrated on its own mel; int8 recurrent matrices on and off,
   deterministic and sampling, the cluster design and the row design at
   one and two rows per CTA; phase 3's tolerances, max |d| printed.
28. The crossover sweep: ``tools.step_opt_probe``'s interleaved A/B of
   int8_hh against int8_hh + int8_ff at 1, 4, 16, 48, 64, 132 and 240
   rows x 2,048 steps (3 passes of 2 launches, CUDA events), both designs
   of the kernel as four interleaved arms, us/step per arm, and at 1, 48
   and 240 rows an ``int8_gates`` arm on each design; fails if the
   policy (``ops.decode.FF_AUTO_MIN_ROWS``) turns the variant on at a
   width where it lost on the cluster design.
29. Serving with the variant forced on: the kernel against its plain
   version on five co-batched 1920-frame requests' conditioning (240
   rows, 64 steps, both modes), then three co-batched serves of them, each
   one launch that takes the int8 pack, kHz printed; a StreamServer at
   width 132 (four deterministic sessions as in phase 19): every launch
   takes the int8 pack and each session is byte-equal to its solo stream.
30. The MCD gate with the variant forced: seeds 0-2 below 892.40, the
   deterministic MCD printed.

Phases 31-33 train ``hparams.py``'s Tacotron at full width
(``TacotronConfig.from_hp``, 11.1 M parameters, flax's init laws from seed
0, dropout 0.5, zoneout 0.1, Adam, clip 1.0):

31. One teacher-forced train step on the card against the CPU: B=4, a
   40-symbol text, 48 frames at r=2, from ``np.random.default_rng(0)``;
   the decoder's dropout and zoneout masks and the encoder prenet's
   keep-masks drawn once on the CPU and given to both devices.  In
   float64: the loss within 1e-12 relative, every gradient within 1e-9
   relative L2, the BatchNorm statistics within 1e-9, the same ReLU masks.
   In float32: the loss and the statistics within 1e-5, every gradient
   within 1e-4 relative L2 (its gap printed per tensor), also with every
   ReLU mask pinned to the float64 forward's (the flips are counted).
32. The training path end to end, on phase 25's synthetic corpus (its
   first 64 utterances, two whole batches of 32) with seeded word texts
   in ``metadata.csv``, under ``build/chip_smoke/
   tts_train/``, every CLI in process (``cli_output``): ``preprocess
   --num_workers 1``; ``wavernn_tpu_torch.train_tacotron`` with
   ``tts_schedule`` cut to
   sessions of two steps (r = 7, 5, 2; hparams' learning rates and
   batches): a first run of session 1 only, then a run of all three that
   must restore the pair and train sessions 2 and 3 only, the stored
   learning rate going from session 1's to session 3's; the latest and
   named pairs, the attention and mel plots (or their ``.npy``) and a GTA
   mel for every utterance, shaped as its mel; ``train_wavernn --gta`` to
   step 2 with an audition at its checkpoint; ``gen_wavernn --gta`` in process
   on the GTA test set (the decode kernel's counter, set to 0 just before,
   must read 2 just after); ``gen_tacotron --save_attention`` in process
   from the step-6 checkpoint into the GTA-trained vocoder (both counters
   must rise); the TTS kernel against its plain version on the trained
   weights (phase 6's tolerances, 200 steps).
33. ``tts_train_ms_per_step`` at ``tools/tts_train_probe.py``'s shape (B=16,
   L=100, T=600, r=2, its seeded inputs): 1 warm-up step, the median of 5
   steps timed by CUDA events, then 2 steps under ``torch.profiler`` (the
   card's activity only): its busy share, device events a step and the
   top kernels by time.

Phases 34-36 run the data axis of ``wavernn_tpu_torch/parallel``:

34. The decode kernel's ``row0``: 16 rows x 1,024 steps of the golden
   eval mel's conditioning (golden MOL, sampling, both feed-forward
   packs); launches over rows [4, 12) and [9, 16) with ``row0`` = 4 and 9
   must equal their plain version and those rows of the 16-row launch,
   max |d| 0.
35. Generation over a mesh: ``make_mesh({"data": 2}, devices=[cuda:0,
   cuda:0])`` (and ``["cuda:0", "cuda:1"]`` on a machine with two
   cards).  ``Generator(mesh=)`` against the meshless Generator on the
   golden MOL (f16 in, int16 out, ``fold_bucket=16``), sampling and
   deterministic: phase 4's 1920-frame request, phase 17's five
   co-batched, phase 18's stream (group 32, first group 4) and a
   StreamServer at width 64 (four sessions of 1920 / 1200 / 600 / 300
   frames).  Each must be byte-equal, with one decode launch per shard
   for each meshless launch; kHz of both printed.  Then ``gen_wavernn
   --mesh --mesh_devices cuda:0,cuda:0`` (in process) must write phase 5's
   WAV byte for byte, and ``tools.mesh_kernel_probe`` (in process) must
   pass.  The model axis: ``make_mesh({"data": 2, "model": 2},
   devices=["cuda:0"] * 4)`` on phase 4's 1920-frame request, sampling
   and deterministic, byte-equal to the meshless Generator with two
   decode launches (one a data shard) for each meshless launch.
36. Data-parallel training, ``tools.multihost_smoke --size full`` (its
   launcher in process, its ranks in worker processes): two gloo ranks on
   cuda:0 (half the batch each) and a world of one under NCCL, one step
   of ``hparams.py``'s vocoder (global batch 8 x 1,375) and Tacotron (B 4,
   L 40, T 48, r 2), each against the single-process step on the card in
   float32 and float64: the loss and the BatchNorm statistics within
   1e-5, every parameter within 1e-5 in float64 (in float32 printed beside
   float32's own distance from float64); the world of one bit-equal.  Each
   step's ms printed.  Then the model axis: ``--model 2 --backend gloo
   --processes 2``, data 1 x model 2 on cuda:0 (NCCL refuses two ranks on
   one card), both models' parameters sharded over the model axis and
   gathered through the host, held to the one-process step the same way,
   every shard exactly its slice of the gathered parameter and the
   weights and optimizer files the one-process files' leaves and shapes.
   The three groups run at once (each on its own port; their five worker
   processes share the card), so each step's ms is taken under the
   others' load.

Phases 37-39 run the modules through which weights enter and leave the
port:

37. The DeepMind dual-softmax WaveRNN at hidden 896
   (``models/deepmind_wavernn.py``), drawn from seed 0, on NB1's input
   (one second of a 220 Hz sine at 24 kHz): over its first 2,000 steps the
   fused forward on the card (one cuDNN GRU call, TF32 off) against the
   plain cell loop on the CPU in float64, logits within 1e-4, and one NB1
   loss's gradients on the card against the CPU in float64, within 1e-4;
   ``nb1_ms_per_step`` over the whole second (23,999 steps), the median of
   5 steps by CUDA events; generation replayed from a CUDA graph against
   the eager steps (2 rows x 300 steps: the same classes, logits within
   1e-5); ``generate`` of 24,000 samples (the graph) and 2,400 eager
   steps, their time and samples/s; then ``examples.nb1_sine_wave`` in
   process at ``--steps 10 --sample_rate 24000``: its loss must fall and
   its WAV parse.
38. The converters at full width (``tools.export_torch_checkpoint`` then
   ``tools.convert_torch_checkpoint``, in process, ``hparams.py``): the
   golden MOL vocoder and a seeded ``hparams.py`` Tacotron
   (``init_variables(cfg, 0)``, step 6) must come back leaf for leaf,
   ``step`` as int64; then one deterministic Generator (f16 in, int16 out,
   ``fold_bucket=16``) serves phase 4's first 1920-frame mel on the golden
   and, after ``update_variables``, on the converted tree: byte-equal.
39. ``quick_start`` in process under ``build/chip_smoke/quick_start/``:
   ``pretrained/`` zips of the golden vocoder and phase 32's trained
   Tacotron, ``-i`` one sentence, ``hparams.py``; both kernels' counters,
   set to 0 just before, must have risen, and the WAV must parse under
   the JAX package's name.  Prints the frames, the samples and the kHz.

Phases 40-42 run the two opt-in kernel variants at full width (the golden
MOL; ``gen_int8`` turns the decode kernel's on, ``TTSGenerator(int8_lstm=
True)`` the Tacotron kernel's):

40. ``int8_gates`` (the five big matrices int8, each operand quantized per
   row on the fly) on the cluster design against its plain version, as
   phase 27: the golden MOL (16 rows x 1024 steps of the eval mel) and
   the tiny RAW golden, deterministic and sampling, each launch counted
   as the cluster design's; phase 3's tolerances, max |d| printed.  Timed
   with CUDA events: plain, cluster, row, row, cluster; the kernel at the
   main path's shape (48 x 12,100, sampling) on the cluster design and
   on the row design (the A/B arm), the plain version at 16 x 1,024 of
   the same conditioning (the record says so: ``plain_shape``), whose
   output must equal both designs' rows 0-15, steps 0-1023.  Then the
   ``decode_cluster_spans`` instantiation of int8_gates prints the median
   span of each part of a step at 48 rows x 2,048, as phase 3 does for
   int8_ff.
41. The ``gen_int8`` path, the decode counts set to 0 before each step
   and read after (every launch must be int8_gates' and the cluster
   design's): ``gen_wavernn
   --int8 --file`` phase 4's first 1920-frame mel in process (the WAV's
   length checked); ``gen_tacotron --int8 wavernn`` from phase 32's
   trained step-6 Tacotron into its GTA-trained vocoder; one
   ``/synthesize`` on the daemon (``serve.setup`` in process, on a
   loopback port) from an hp file that sets ``gen_int8 = True``.  The
   variants' quality is read in phase 44, by one ``tools.kernel_quality``
   run for every decoder.
42. ``int8_lstm`` against its plain version at full width (phase 6's
   seeded model and 60-symbol text, L=64, r=2, 750 steps, every value
   equal), both timed in turns, the shared-memory plan's bytes printed;
   ``tools.tts_phase_spans``' spans launch of int8_lstm (every value
   equal) prints its span per phase beside phase 6's bf16 spans, with the
   LSTM phases' share of each step and the first three phases' sum (where
   int8_lstm loads and dots the h half);
   ``TTSGenerator(int8_lstm=True)`` on phase 32's trained step-6
   Tacotron (800 frames at most): the mean and max mel |d| of the bf16
   and the int8_lstm kernel against the float32 plain decoder; one text
   -> wav through both int8 variants (the tiny golden Tacotron with
   int8_lstm, the golden MOL with int8_gates), both kernels' counters set
   to 0 before and risen after.

Phases 43-47 run the quality and golden tools of
``wavernn_tpu_torch/tools/`` in process, each through its ``main(argv)``
at a cut size; each tool's JSON must hold finite numbers, and each phase
prints its seconds:

43. ``check_mel_parity`` with its defaults: the numpy mel against the
   card's (cuFFT) on three synthetic signals; the worst MCD below 0.1 dB.
44. ``kernel_quality --weights`` the golden MOL ``--eval_mel`` the golden
   eval mel ``--seeds 3`` (the four decoders: scan, bf16, int8_ff,
   int8_gates), cut to folds of 1,100 + 2 x 55 samples by ``--hp_file``
   (``hparams.py`` with ``voc_target = 1100``, ``voc_overlap = 55``: the
   float32 scan decoder takes ~1 ms a step on the card, 12 s a decode at
   the production folds); each kernel variant launched at least 4 times
   (3 seeds and the deterministic decode); each kernel variant's
   deterministic mean |sample diff| to the scan, which must lie between 0
   and the signal's std, and every decoder's MCD, printed beside phases 15
   and 30's.
45. ``tts_kernel_parity --int8 --train 50``: full width, 50 overfit steps,
   then the plain decoder, the kernel and the int8_lstm kernel on a
   60-symbol text (400 frames at most, best of 3); both kernel variants'
   counters, set to 0 just before, must have risen.
46. ``tts_train_probe 16 100 600 --passes 1 --calls 2``: the Tacotron
   train step split into pieces (2 calls, one pass, CUDA events; the
   tool's default is 4 calls, the best of 3), each piece's kernels counted
   under
   ``torch.profiler``; the full step printed beside phase 33's, and the
   dropout/zoneout share (the train forward against the train forward
   with neither).
47. ``train_golden --which full --steps 20`` with phase 44's hp file into
   a temporary ``--out`` under ``build/chip_smoke/``: 20 steps of the MOL
   vocoder on the speech-shaped corpus, then its MCD on the 1200-frame
   eval mel at phase 44's folds (scan 6 seeds, the decode kernel 3 seeds,
   its counter set to 0 before and risen after); the msgpack, the eval
   mel and the meta must load.  Then ``--which taco-pin
   --from tests/golden`` into the same directory: the committed tiny
   Tacotron decoded on the CPU must give the committed mel within 1e-3 and
   the committed gates (``mel_gt_l1`` within 1e-3).

Phases 48-53 run the examples of ``wavernn_tpu_torch/examples/`` in
process, each through its ``main(argv)`` (``e2e_tts`` through its
``run_pipeline`` and ``measure_gates``), under ``build/chip_smoke/
examples/``; both kernels' counters are set to 0 just before each of
phases 49-53 and read just after, and each phase prints its seconds.  The
loss-drop checks of NB3 and NB4 and the gates of e2e_tts are set for their
default depth, so at the cut depths below each phase prints the losses or
the gates and says that it skips those checks:

48. ``pruning_example`` uncut (300 steps, its tiny RAW model): the
   measured sparsity every 25 steps must equal the schedule's (the masks
   ``Pruner.compute`` makes from a freshly drawn model at that step), 0.0
   at steps 25 and 50, and the losses finite.  No kernel runs.
49. ``nb2_fit_single_sample --steps 20`` on ``hparams.py``'s model (full
   width) and a 3 s wav from NB3's ``synth_corpus``: the decode kernel
   (int8_ff) launched, the ``.resynth.wav`` written, (frames - 1) x 275
   samples, finite losses.
50. ``nb3_fit_long_sample --full_size --minutes 0.25 --steps 20
   --num_workers 1``: 12 utterances preprocessed, one audition through
   the decode kernel, int16 of its utterance's length, the latest weights
   on disk.
51. ``nb4_alternative_model --full_size --steps 20 --num_workers 1``: 8
   utterances with 16-bit labels, the MOL model trained, the held-out 2 s
   mel generated through the decode kernel at folds of 2,750 + 2 x 550,
   finite and longer than a second.
52. ``serving_demo`` at its defaults (its tiny models, folds of 2,750 + 2
   x 550, 20-frame mels): its own equalities (stream == handles bit for
   bit, served == solo within 1e-6, a RIFF body, one served session); both
   counters must rise.
53. ``e2e_tts`` on its first 64 texts, 30 Tacotron and 20 vocoder steps
   (its hp template's widths), the four CLIs in process, then
   ``measure_gates`` printed: three WAVs and attention matrices, finite
   gates; both counters must rise (``gen_tacotron``).

Phase 54 trains ``hparams.py``'s vocoder at full width (32 x 1,375) with
the JAX CLI's two training options, on phase 25's corpus:

54. (a) ``wavernn_tpu_torch.train_wavernn`` in process (``cli_output``)
   from a fresh checkpoint under ``build/chip_smoke/train_options/``,
   with an hp file that sets ``voc_seq_chunks = 5``, ``voc_chunk_warmup
   = 128`` and ``voc_compute_dtype = "bfloat16"``: 3 steps with one
   audition at step 3; the losses it fetched must be finite, the decode
   kernel's counter, set to 0 just before, must read 1 just after, the
   written weights must load, and ``gen_wavernn`` on them must write a
   WAV that parses.  (b) ``voc_train_ms_per_step`` on one fixed batch of
   the corpus (2 warm-up steps, the median of 4 by CUDA events) for four
   arms, each printed beside phase 26's float32 figure: float32
   unchunked, chunked k = 5, bf16, and both; each arm's last loss must be
   below its first.  (c) With memoryless GRUs (w_hh zeroed, the update
   gate killed) the chunked train-mode forward must equal the unchunked
   one within 1e-5 (B=4); the bf16 GRU sequence at the shape rnn2 takes
   under both options (160 rows x 403 steps, 544 -> 512) on the card's
   product (``torch.mm`` of bf16 operands to float32) against its plain
   version (the float32 matmul of the rounded operands): outputs within
   1e-3 and every gradient within 5e-3 relative L2 (a state element's
   bf16 rounding may flip where the two float32 sums differ in order).

The decode kernel's launch counts (all launches, those of the cluster
design, those with int8 feed-forward matrices and those of int8_gates) are
set to 0 just before each main-path run and read just after, and every
launch must be the cluster design's (int8_gates' too; the row design is
left to the A/B arms, the ablations and the breakdown, none of them on
the main path); the record's ``launches`` sum
phase 4's, phases 15-21's, phase 25's, phases 29-30's, phase 32's, phase
35's, phases 38-39's, phases 41-42's, phase 44's, phase 47's, phases
49-53's and phase 54's, split between the three variants, and the TTS kernel's sums
phase 8's, phases 20-21's, phase 32's, phase 39's, phase 45's and phases
52-53's (bf16) and phase 42's and phase 45's (int8_lstm; phase 37 runs no
hand-written kernel: the JAX package scans the DeepMind cell with XLA
ops).

Float32 matmuls, convolutions and cuDNN's GRU run in full float32 (TF32
off).  The last
two lines are the card's ``nvidia-smi`` name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record, where ``bound_ms`` is the least time the card could take for
the timed call (the larger of its operations over the H100's dense peak
for their type and its bytes, each input read once and each output written
once, over 3.35 TB/s) and ``library_ms`` is null: no single PyTorch call
computes any of these T-step recurrences.  The decode kernel has three
entries, all the cluster design's (``decode_cluster.cu``):
``wavernn_decode`` (bf16 feed-forward matrices),
``wavernn_decode_int8_ff`` and ``wavernn_decode_int8_gates``; the Tacotron
kernel two: ``tacotron_decode`` and ``tacotron_decode_int8_lstm``.
"""

import contextlib
import json
import os
import signal
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
# phases 44 and 47: folds of 1,100 + 2 x 55 samples, so that each float32
# scan decode (~1 ms a step on the card) takes 1,210 steps, not 12,100
SHORT_FOLDS = dict(voc_target=1100, voc_overlap=55)
# the decode kernel's designs (cuda_decode.DESIGNS) and the rows per CTA
# each is held at against its plain version: the cluster design (the
# default: it plans its own rows), the row design at one and two rows
DESIGNS = ("cluster", "row")
DESIGN_ARMS = (("cluster", 1), ("row", 1), ("row", 2))
# phase 28's widths with an int8_gates arm on both designs
GATES_WIDTHS = (1, 48, 240)


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
    bf16 dots (the fused aux matrix counted by its nonzero blocks), the
    two recurrent dots (int8 with int8_hh or int8_gates) and the three
    feed-forward dots (GRU2's input, FC1, FC2: int8 with int8_ff or
    int8_gates; the pack's variant is read from its markers), each type
    at its peak; bytes are the conditioning read, the weights and the
    output."""
    from wavernn_tpu_torch.ops import cuda_decode

    H, F = packed["b_hh1_n"].shape[0], packed["b_fc1"].shape[0]
    d, K0 = packed["w_aux"].shape[0] // 3, packed["w_Im"].shape[0]
    n_out = packed["b_fc3"].shape[0]
    hh = 2 * H * 3 * H
    ff = H * 3 * H + H * F + F * F
    bf16 = K0 * 4 * H + d * (3 * H + 2 * F) + F * n_out
    gates = cuda_decode.is_int8_gates(packed)
    i8 = cuda_decode.is_int8_hh(packed) or gates
    i8_ff = cuda_decode.is_int8_ff(packed) or gates
    int8 = (hh if i8 else 0) + (ff if i8_ff else 0)
    bf16 += (0 if i8 else hh) + (0 if i8_ff else ff)
    ops = [(2 * bf16 * B * T, PEAK_BF16), (2 * int8 * B * T, PEAK_INT8)]
    return bound(ops, nbytes(*packed.values()) + B * T * C * 2 + B * T * 4)


def timed_in_order(order):
    """Run each function of ``order`` in turn, each timed with CUDA events.
    Returns ({fn: its last output}, {fn: [ms of each run]})."""
    import torch

    outs, times = {}, {fn: [] for fn in order}
    for fn in order:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        outs[fn] = fn()
        end.record()
        torch.cuda.synchronize()
        times[fn].append(start.elapsed_time(end))
    return outs, times


def in_turns(run_plain, run_kernel):
    """Run the plain version and the kernel in turns (plain, kernel, kernel,
    plain), each timed with CUDA events.  Returns (plain output, kernel
    output, plain ms, kernel ms), the ms as lists."""
    outs, times = timed_in_order((run_plain, run_kernel, run_kernel,
                                  run_plain))
    return outs[run_plain], outs[run_kernel], times[run_plain], times[run_kernel]


# the decode kernel's launches in the main path's runs (phases 4, 15-21,
# 25, 29-30, 32, 35, 38-39, 41-42, 44, 47, 49-53 and 54): all of them,
# those of the cluster design, those with int8 feed-forward matrices and
# those of int8_gates
MAIN_DECODE = {"all": 0, "cluster": 0, "int8_ff": 0, "int8_gates": 0}


def zero_decode_counts():
    """Set the decode wrapper's launch counts to 0."""
    from wavernn_tpu_torch.ops import cuda_decode

    cuda_decode.decode.launches = 0
    cuda_decode.decode.launches_cluster = 0
    cuda_decode.decode.launches_int8_ff = 0
    cuda_decode.decode.launches_int8_gates = 0


def count_main_decode() -> int:
    """Add the decode launches since the counts were set to 0 to the main
    path's tally; returns all of them.  Fails unless every launch went
    through the cluster design (int8_gates' too; the main path runs no
    ablation)."""
    from wavernn_tpu_torch.ops import cuda_decode

    d = cuda_decode.decode
    if d.launches_cluster != d.launches:
        fail(f"{d.launches} decode launches ({d.launches_int8_gates} of "
             f"int8_gates), but {d.launches_cluster} of the cluster design")
    MAIN_DECODE["all"] += cuda_decode.decode.launches
    MAIN_DECODE["cluster"] += cuda_decode.decode.launches_cluster
    MAIN_DECODE["int8_ff"] += cuda_decode.decode.launches_int8_ff
    MAIN_DECODE["int8_gates"] += cuda_decode.decode.launches_int8_gates
    return cuda_decode.decode.launches


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

    t_start = time.perf_counter()
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
    zero_decode_counts()

    def variables_of(path):
        blob = load_pytree(path)
        return {"params": blob["params"], "batch_stats": blob["batch_stats"]}

    golden_cfg = WaveRNNConfig()
    golden = variables_of(GOLDEN)
    raw_cfg = WaveRNNConfig(rnn_dims=32, fc_dims=32, compute_dims=16,
                            res_out_dims=16, res_blocks=2, mode="RAW")
    tiny_raw = variables_of(TINY_RAW)

    # -- 3. kernel against plain ----------------------------------------
    errs, errs_row = [], []   # the cluster design's (bf16 ff), the row's

    def compare(tag, packed, cond, T, cfg, det, seed, design, rows_per_cta,
                out_p):
        """The kernel of ``design`` against ``out_p``, its plain version's
        output."""
        out_k = cuda_decode.decode(packed, cond, T, seed, cfg.mode,
                                   cfg.n_classes, det,
                                   rows_per_cta=rows_per_cta, design=design)
        torch.cuda.synchronize()
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
        (errs if design == "cluster" else errs_row).append(first)

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
            for det in (True, False):
                kind = "deterministic" if det else "sampling"
                seed = 0 if det else 1234
                # the plain version once for both designs
                out_p = cuda_decode.decode_reference(
                    gen.packed, cond, 1024, seed, cfg.mode, cfg.n_classes,
                    det)
                for design, rows in DESIGN_ARMS:
                    compare(f"{tag} {q} {design} R={rows} {kind}",
                            gen.packed, cond, 1024, cfg, det, seed, design,
                            rows, out_p)

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
    # the int8 feed-forward bounds of the main path's Generator, calibrated
    # on this request's conditioning (a 4,096-step B=1 decode), timed
    with torch.no_grad():
        mels_up, aux_mel = gen.model.upsample_parts(
            gen._ingress_f32(staged.mels_dev))
        stream = cuda_decode.pack_stream(mels_up, aux_mel,
                                         golden_cfg.total_scale)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen._calibrate_ff(stream)
        torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    print(f"int8_ff calibration (ff_ranges, {min(stream.shape[0], 4096)} "
          f"steps at B=1, golden MOL): {cal_s:.3f} s wall; bounds "
          f"{[round(float(x), 4) for x in gen.ff_scales.cpu()]} | {card}",
          flush=True)

    # both variants (bf16 and int8 feed-forward matrices) at the main
    # path's shape on both designs, in turns with their plain versions
    variants = {"bf16 ff": gen.packed, "int8_ff": gen.packed_ff}
    run = lambda p, design: (lambda: cuda_decode.decode(
        p, cond, T, 7, "MOL", 30, False, design=design))
    plain = lambda p: (lambda: cuda_decode.decode_reference(
        p, cond, T, 7, "MOL", 30, False))
    runs = {(v, d): run(p, d) for v, p in variants.items()
            for d in DESIGNS}
    for fn in runs.values():
        fn()  # warm
    pb, pf = plain(variants["bf16 ff"]), plain(variants["int8_ff"])
    c, r = "cluster", "row"
    order = (pb, runs["bf16 ff", c], runs["bf16 ff", r], runs["int8_ff", c],
             runs["int8_ff", r], runs["int8_ff", r], runs["int8_ff", c],
             runs["bf16 ff", r], runs["bf16 ff", c], pf)
    outs, times = timed_in_order(order)
    main_ms = {}
    errs_ff = []
    for (v, design), run_k in runs.items():
        run_p = pb if v == "bf16 ff" else pf
        d = (outs[run_k] - outs[run_p]).abs()
        main_err = float(d[:, :64].max())
        print(f"kernel vs plain [main path, sampling int8_hh, {v}, {design} "
              f"design] rows {cond.shape[0]} steps {T}: first-64 max|d| "
              f"{main_err:.3g}, within 2e-2 "
              f"{float((d <= 2e-2).float().mean()):.5f}, max|d| "
              f"{float(d.max()):.3g}")
        if main_err > 1e-2 or not torch.isfinite(outs[run_k]).all():
            fail(f"kernel disagrees with its plain version at the main "
                 f"shape [{v}, {design} design]")
        if design == "row":
            errs_row.append(main_err)
        else:
            (errs if v == "bf16 ff" else errs_ff).append(main_err)
        k_ms, p_ms = (float(np.mean(times[f])) for f in (run_k, run_p))
        main_ms[v, design] = (k_ms, p_ms)
        print(f"decode time at {cond.shape[0]} x {T} [{v}, {design} design]: "
              f"kernel {[round(x, 3) for x in times[run_k]]} ms "
              f"({k_ms * 1e3 / T:.2f} us/step), plain "
              f"{[round(x, 1) for x in times[run_p]]} ms "
              f"({p_ms * 1e3 / T:.2f} us/step) | {card}", flush=True)
    del outs
    # where the cluster design's step goes: the spans instantiation's
    # stamps at the main path's rows, 2,048 steps
    out_s, spans = cuda_decode.decode_cluster_spans(
        gen.packed_ff, cond[:, :2048].contiguous(), 2048, 7, "MOL", 30, False)
    ref = cuda_decode.decode(gen.packed_ff, cond[:, :2048].contiguous(), 2048,
                             7, "MOL", 30, False)
    if not torch.equal(out_s, ref):
        fail("the spans instantiation differs from the cluster kernel")
    st = spans.cpu().numpy().astype(np.float64)[64:2047]
    step_ns = np.median(np.diff(st[:, 0]))
    parts = np.median(np.diff(st, axis=1), axis=0)
    tail = np.median(st[1:, 0] - st[:-1, -1])
    names = cuda_decode.CLUSTER_SPANS
    print(f"cluster design spans (int8_ff, {cond.shape[0]} rows x 2048, CTA "
          f"0 of cluster 0, medians, us): step {step_ns / 1e3:.2f}; "
          + ", ".join(f"{names[i + 1]} {parts[i] / 1e3:.2f}"
                      for i in range(len(parts)))
          + f", sample {tail / 1e3:.2f} | {card}", flush=True)

    # -- 4. the main path -----------------------------------------------
    requests = [eval_mel] + long_mels
    gen(requests[0], batched=True, target=TARGET, overlap=OVERLAP,
        mu_law=False)                                   # warm
    torch.cuda.synchronize()
    zero_decode_counts()
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
    launches = count_main_decode()
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
    from wavernn_tpu_torch import gen_wavernn

    log, _ = cli_output(gen_wavernn.main, [
        "--file", str(mel_path), "--voc_weights", str(GOLDEN),
        "--output_dir", str(out_dir), "--hp_file", str(REPO / "hparams.py")],
        REPO)
    print("cli: " + " | ".join(log.strip().splitlines()[-2:]))
    wavs = sorted(out_dir.glob("__eval_mel__*.wav"))
    if len(wavs) != 1:
        fail(f"CLI wrote {wavs}")
    x, sr = wavio.read_wav_raw(wavs[0])
    if sr != 22050 or x.shape != ((eval_mel.shape[1] - 1) * 275,):
        fail(f"CLI WAV: sr {sr}, shape {x.shape}")
    print(f"cli: {wavs[0].name} parses: {x.shape[0]} samples at {sr} Hz")

    voc_bound = {v: decode_bound(p, cond.shape[0], T, cond.shape[2])
                 for v, p in variants.items()}

    def clock(phases: str):
        print(f"phases {phases} done at {time.perf_counter() - t_start:.1f} "
              "s", flush=True)

    clock("1-5")
    tts = tts_phases(dev, card, wavio, GOLDEN)
    clock("6-9")
    floor = measurement_phases(dev, card, golden_cfg, gen, eval_mel,
                               long_mels[0], errs_row)
    clock("10-14")
    serving = serving_phases(dev, card, golden_cfg, golden, eval_mel, errs)
    clock("15-19")
    text_serving = text_serving_phases(dev, card, golden_cfg, golden,
                                       eval_mel)
    clock("20-23")
    training = training_phases(dev, card)
    clock("24-26")
    ff = int8_ff_phases(dev, card, golden_cfg, golden, raw_cfg, tiny_raw,
                        eval_mel, raw_mel)
    errs_ff += ff["errs"]
    errs_row += ff["errs_row"]
    clock("27-30")
    tts_train = tts_training_phases(dev, card)
    clock("31-33")
    par = parallel_phases(dev, card, golden_cfg, golden, eval_mel,
                          long_mels[0])
    errs.append(par["errs"]["bf16 ff"])
    errs_ff.append(par["errs"]["int8_ff"])
    clock("34-36")
    wts = weights_phases(dev, card, golden_cfg, golden, long_mels[0],
                         tts_train["tts_weights"])
    clock("37-39")
    i8 = int8_variant_phases(dev, card, golden_cfg, golden, raw_cfg,
                             tiny_raw, eval_mel, raw_mel, cond, T,
                             long_mels[0], tts_train, tts["spans"])
    clock("40-42")
    tools = quality_tool_phases(
        dev, card, {"bf16 ff": serving["mcd"], "int8_ff": ff["mcd"]},
        tts_train["ms_per_step"])
    i8["int8_lstm"]["launches"] += tools["int8_lstm_launches"]
    clock("43-47")
    examples = example_phases(dev, card)
    clock("48-53")
    options = train_option_phases(dev, card, training["ms_per_step"])
    clock("54")

    # -- the record -----------------------------------------------------
    n_ff = MAIN_DECODE["int8_ff"]
    n_g = MAIN_DECODE["int8_gates"]
    n_bf = MAIN_DECODE["all"] - n_ff - n_g
    print(f"decode launches on the main path: {MAIN_DECODE['all']} "
          f"({MAIN_DECODE['cluster']} of the cluster design: {n_bf} with bf16 "
          f"feed-forward matrices, {n_ff} with int8, {n_g} of int8_gates; "
          f"phase 4: {launches}, serving {serving['launches']}, text "
          f"serving {text_serving['decode_launches']}, training "
          f"{training['decode_launches']}, int8_ff serving "
          f"{ff['launches']}, Tacotron training "
          f"{tts_train['decode_launches']}, mesh serving "
          f"{par['launches']}, converters and quick_start "
          f"{wts['decode_launches']}, the gen_int8 path "
          f"{i8['int8_gates']['launches']}, the quality tools "
          f"{tools['decode_launches']}, the examples "
          f"{examples['decode']}, the training options "
          f"{options['decode_launches']})")
    if n_bf == 0 or n_ff == 0 or n_g == 0 or i8["int8_lstm"]["launches"] == 0:
        fail("a kernel variant was not launched on the main path")
    if MAIN_DECODE["cluster"] != n_bf + n_ff + n_g:
        fail(f"{n_bf + n_ff + n_g} decode launches, "
             f"{MAIN_DECODE['cluster']} of the cluster design")
    print(f"the row design (decode.cu), held beside the cluster design in "
          f"phases 3, 11 and 27: max first-64 |d| {max(errs_row):.3g} over "
          f"{len(errs_row)} comparisons")
    i8["int8_gates"]["launches"] = n_g   # phases 41-42's and phase 44's
    print(json.dumps({"kernels": [{
        "name": "wavernn_decode",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/decode_cluster.cu",
        "replaces": "wavernn_tpu/ops/pallas_decode.py:103",
        "launches": n_bf,
        "max_abs_err": max(errs),
        "ms": main_ms["bf16 ff", "cluster"][0],
        "plain_ms": main_ms["bf16 ff", "cluster"][1],
        "bound_ms": voc_bound["bf16 ff"][0],
        "bound_by": voc_bound["bf16 ff"][1],
        "library_ms": None,
    }, {
        "name": "wavernn_decode_int8_ff",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/decode_cluster.cu",
        "replaces": "wavernn_tpu/ops/pallas_decode.py:103",
        "launches": n_ff,
        "max_abs_err": max(errs_ff),
        "ms": main_ms["int8_ff", "cluster"][0],
        "plain_ms": main_ms["int8_ff", "cluster"][1],
        "bound_ms": voc_bound["int8_ff"][0],
        "bound_by": voc_bound["int8_ff"][1],
        "library_ms": None,
    }, {
        "name": "tacotron_decode",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/tts_decode.cu",
        "replaces": "wavernn_tpu/ops/pallas_tts.py:237",
        "launches": (tts["launches"] + text_serving["tts_launches"]
                     + tts_train["tts_launches"] + wts["tts_launches"]
                     + tools["tts_launches"] + examples["tts"]),
        "max_abs_err": max(tts["max_abs_err"], tts_train["max_abs_err"]),
        "ms": tts["ms"],
        "plain_ms": tts["plain_ms"],
        "bound_ms": tts["bound_ms"],
        "bound_by": tts["bound_by"],
        "library_ms": None,
    }, {
        "name": "tacotron_decode_global",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/tts_decode.cu",
        "replaces": "wavernn_tpu/ops/pallas_tts.py:237",
        **tts["global"],
        "library_ms": None,
    }, {
        "name": "wavernn_decode_int8_gates",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/decode_cluster.cu",
        "replaces": "wavernn_tpu/ops/pallas_decode.py:103",
        **i8["int8_gates"],
        "library_ms": None,
    }, {
        "name": "tacotron_decode_int8_lstm",
        "route": "cuda",
        "source": "wavernn_tpu_torch/ops/csrc/tts_decode.cu",
        "replaces": "wavernn_tpu/ops/pallas_tts.py:237",
        **i8["int8_lstm"],
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


def tts_hp_file(meta: dict) -> Path:
    """An hp file: the repository's hparams.py (the golden MOL vocoder)
    with the tiny golden Tacotron's dims and an r=2 schedule."""
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
    return hp_file


def tts_kernel_inputs(dev, cfg, variables, seq, L: int, r: int,
                      int8_lstm: bool = False):
    """The TTS kernel's inputs for one text: the weights packed at r (the
    LSTM rows int8 with ``int8_lstm``), and the encoder outputs of ``seq``
    zero-padded to L symbols."""
    import torch

    from wavernn_tpu_torch.models.tacotron import from_jax_variables
    from wavernn_tpu_torch.ops.tts_decode import (
        extract_tts_decode_weights, pack_tts_weights,
    )

    model = from_jax_variables(variables, cfg, dev)
    x = torch.zeros(1, L, dtype=torch.long)
    x[0, :len(seq)] = torch.tensor(seq)
    with torch.no_grad():
        enc, encp = model.encode(x.to(dev))
    packed = pack_tts_weights(extract_tts_decode_weights(model), r,
                              cfg.n_mels, int8_lstm=int8_lstm)
    return packed, enc[0].contiguous(), encp[0].contiguous()


def tts_fresh_state(dev, packed, L: int):
    from wavernn_tpu_torch.ops.tts_decode import (
        init_tts_decode_state, packed_dims,
    )

    D, _, H, n_mels, _ = packed_dims(packed)
    return init_tts_decode_state(D, H, L, n_mels, dev)


def tts_compare(dev, tag, packed, enc, encp, n: int,
                exact: bool = False) -> float:
    """Hold n steps of the TTS kernel (the pack's variant) against its
    plain version: the first 64 steps within 1e-3 on mels and scores, at
    least 99% of mel values within 2e-2; with ``exact`` (int8_lstm, whose
    LSTM sums are exact integers) every value equal.  Returns the max |d|
    of mels and scores over all steps."""
    import torch

    from wavernn_tpu_torch.ops import cuda_tts
    from wavernn_tpu_torch.ops.tts_decode import (
        is_int8_lstm, tts_decode_reference,
    )

    L = enc.shape[0]
    mk, sk, _, _ = cuda_tts.tts_decode(packed, enc, encp,
                                       tts_fresh_state(dev, packed, L), n,
                                       int8_lstm=is_int8_lstm(packed))
    torch.cuda.synchronize()
    mp, sp, _, _ = tts_decode_reference(packed, enc, encp,
                                        tts_fresh_state(dev, packed, L), n)
    dm, ds = (mk - mp).abs(), (sk - sp).abs()
    first = max(float(dm[:64].max()), float(ds[:64].max()))
    agree = float((dm <= 2e-2).float().mean())
    ok = first <= 1e-3 and agree >= 0.99
    if exact:
        ok = ok and float(dm.max()) == 0.0 and float(ds.max()) == 0.0
    print(f"tts kernel vs plain [{tag}] L {L} steps {n}: first-64 "
          f"max|d| mel {float(dm[:64].max()):.3g} score "
          f"{float(ds[:64].max()):.3g}, mel within 2e-2 {agree:.5f}, "
          f"max|d| mel {float(dm.max()):.3g} score {float(ds.max()):.3g}"
          f" -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not torch.isfinite(mk).all():
        fail(f"the TTS kernel disagrees with its plain version [{tag}]")
    return max(float(dm.max()), float(ds.max()))


def tts_timed(dev, fn, packed, enc, encp, n: int) -> float:
    """ms of one ``fn(packed, enc, encp, state, n)`` from a fresh state, by
    CUDA events."""
    import torch

    state = tts_fresh_state(dev, packed, enc.shape[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(packed, enc, encp, state, n)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def tts_text_limit(dev, cfg, int8_lstm: bool = False) -> int:
    """The longest text the TTS kernel's shared placement holds for
    ``cfg`` at r=2 on one CTA per SM (``cuda_tts.shared_text_limit``:
    2,918 symbols at full width on 132 CTAs, 3,828 with int8_lstm)."""
    import torch

    from wavernn_tpu_torch.ops import cuda_tts

    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    D = cfg.decoder_dims
    return cuda_tts.shared_text_limit(D, D // 2, cfg.lstm_dims, cfg.n_mels,
                                      2, grid, int8_lstm)


def tts_placement_ab(dev, card, cfg, variables, packed, enc, encp) -> dict:
    """Phase 6's placement A/B on texts that fit shared memory: the kernel
    pinned to each placement (``cuda_tts._launch``'s ``placement``, not
    counted) at L = 64 (phase 6's (b) inputs, 750 steps) and at the shared
    placement's longest text (``tts_text_limit``, 96 steps): the two must
    give the same bits, and each is timed in turns (shared, global,
    global, shared).  Returns {L: (shared us/step, global us/step)}."""
    import torch

    from wavernn_tpu_torch.ops import cuda_tts

    def pinned(placement):
        return lambda p, e, ep, st, k: cuda_tts._launch(
            p, e, ep, st, k, None, placement=placement)[0]

    shared, glob = pinned("shared"), pinned("global")
    limit = tts_text_limit(dev, cfg)
    seq = [int(i) for i in np.random.default_rng(limit).integers(
        1, cfg.num_chars, limit)]
    out = {}
    for L, n in ((64, 750), (limit, 96)):
        if L != enc.shape[0]:
            packed, enc, encp = tts_kernel_inputs(dev, cfg, variables, seq, L,
                                                  2)
        D = packed["W_q"].shape[0]
        grid = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = cuda_tts.tts_smem_plan(D, D // 2, cfg.lstm_dims, cfg.n_mels,
                                      2, L, grid)
        if plan["placement"] != "shared":
            fail(f"L={L}: the plan chose the {plan['placement']} placement")
        got = [fn(packed, enc, encp, tts_fresh_state(dev, packed, L), n)
               for fn in (shared, glob)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got[0][:3], got[1][:3]))
        times = {shared: [], glob: []}
        for fn in (shared, glob, glob, shared):
            times[fn].append(tts_timed(dev, fn, packed, enc, encp, n))
        us = [float(np.mean(times[fn])) * 1e3 / n for fn in (shared, glob)]
        print(f"tts placement A/B at L {L}, full width, r=2, {n} steps: "
              f"shared {[round(x, 3) for x in times[shared]]} ms "
              f"({us[0]:.2f} us/step), global pinned "
              f"{[round(x, 3) for x in times[glob]]} ms ({us[1]:.2f} "
              f"us/step), global / shared {us[1] / us[0]:.3f}; the same "
              f"bits {same} | {card}", flush=True)
        if not same:
            fail(f"L={L}: the global placement's bits differ from the "
                 f"shared placement's")
        out[L] = tuple(us)
    return out


def tts_long_texts(dev, card, cfg, variables) -> dict:
    """Phase 6's long texts, past the shared placement's limit at full
    width (``tts_text_limit``: 2,918 symbols, 3,828 with int8_lstm, on 132
    CTAs): the kernel in its global placement against its plain version
    (``tts_compare``, r=2, 96 steps) and timed (plain, kernel, kernel,
    plain) one symbol past the limit, at 4,096 and 16,384 (bf16) and one
    past int8_lstm's limit; then one 3,000-symbol
    text through ``TTSGenerator(backend="kernel", steps=480)``, one
    launch per 48-step chunk, against the same generator with the
    kernel's plain version in its place and against the float32 plain
    backend.  Returns the global placement's record (its time and bound
    at 16,384 symbols, its launches from the generator's run)."""
    import torch

    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.ops import cuda_tts
    from wavernn_tpu_torch.ops.tts_decode import (
        LSTM_MATRICES, MATRICES, tts_decode_reference,
    )

    t_phase = time.perf_counter()
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(21)
    errs, rec = [], {}
    n = 96
    for L, int8 in ((tts_text_limit(dev, cfg) + 1, False), (4_096, False),
                    (16_384, False), (tts_text_limit(dev, cfg, True) + 1,
                                      True)):
        seq = [int(i) for i in rng.integers(1, cfg.num_chars, L)]
        packed, enc, encp = tts_kernel_inputs(dev, cfg, variables, seq, L, 2,
                                              int8_lstm=int8)
        D = packed["W_q"].shape[0]
        plan = cuda_tts.tts_smem_plan(D, D // 2, cfg.lstm_dims, cfg.n_mels,
                                      2, L, grid, int8_lstm=int8)
        if plan["placement"] != "global":
            fail(f"L={L}: the plan chose the {plan['placement']} placement")
        tag = f"{'int8_lstm' if int8 else 'bf16'}, full width, r=2, global"
        errs.append(tts_compare(dev, tag, packed, enc, encp, n, exact=int8))
        kernel = lambda *a: cuda_tts.tts_decode(*a, int8_lstm=int8)
        times = {kernel: [], tts_decode_reference: []}
        for fn in (tts_decode_reference, kernel, kernel, tts_decode_reference):
            times[fn].append(tts_timed(dev, fn, packed, enc, encp, n))
        k_ms = float(np.mean(times[kernel]))
        p_ms = float(np.mean(times[tts_decode_reference]))
        macs_i8 = sum(packed[k].numel() for k in LSTM_MATRICES) if int8 else 0
        macs = (sum(packed[k].numel() for k in MATRICES
                    if k not in ("M_loc", "v")) - macs_i8
                + L * (packed["M_loc"].numel() + 2 * D))
        b = bound([(2 * macs * n, PEAK_BF16), (2 * macs_i8 * n, PEAK_INT8)],
                  nbytes(*packed.values(), enc, encp)
                  + n * (2 * cfg.n_mels + L + 1) * 4)
        # were enc and encp read again every step (33.6 MB at 16,384)
        restream_us = nbytes(enc, encp) / HBM_RATE * 1e6
        print(f"tts decode time at L {L} ({tag}), {n} steps: kernel "
              f"{[round(x, 3) for x in times[kernel]]} ms "
              f"({k_ms * 1e3 / n:.2f} us/step), plain "
              f"{[round(x, 1) for x in times[tts_decode_reference]]} ms "
              f"({p_ms * 1e3 / n:.2f} us/step); bound {b[0]:.4f} ms "
              f"({b[1]}; {b[0] * 1e3 / n:.3f} us/step), enc + encp re-read "
              f"a step {restream_us:.2f} us; {plan['bytes']} bytes of shared "
              f"memory per CTA on {plan['grid']} CTAs, workspace "
              f"{plan['workspace']} bytes | {card}", flush=True)
        if L == 16_384:
            rec = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b[0],
                   "bound_by": b[1]}
        del packed, enc, encp

    # the long text through the generator
    L = 3_000
    seq = [int(i) for i in rng.integers(1, cfg.num_chars, L)]
    kernel_fn = cuda_tts.tts_decode
    torch.cuda.synchronize()
    cuda_tts.tts_decode.launches = 0
    cuda_tts.tts_decode.launches_global = 0
    mel_k, _, attn_k = TTSGenerator(cfg, variables, dev, steps=480,
                                    backend="kernel")(seq, r=2)
    torch.cuda.synchronize()
    launches = (cuda_tts.tts_decode.launches,
                cuda_tts.tts_decode.launches_global)
    want = -(-(mel_k.shape[1] // 2) // TTS_CHUNK)
    # the same generator with the kernel's plain version in its place
    cuda_tts.tts_decode = lambda p, e, ep, st, k, int8_lstm=False: (
        tts_decode_reference(p, e, ep, st, k))
    try:
        mel_p, _, attn_p = TTSGenerator(cfg, variables, dev, steps=480,
                                        backend="kernel")(seq, r=2)
    finally:
        cuda_tts.tts_decode = kernel_fn
    mel_f, _, _ = TTSGenerator(cfg, variables, dev, steps=480,
                               backend="plain")(seq, r=2)
    if mel_k.shape != mel_p.shape or attn_k.shape != attn_p.shape:
        fail(f"the long text: kernel {mel_k.shape}, its plain version "
             f"{mel_p.shape}")
    dm = np.abs(mel_k - mel_p)                     # (n_mels, frames)
    first = float(dm[:, :128].max())
    agree = float((dm <= 2e-2).mean())
    nf = min(mel_k.shape[1], mel_f.shape[1])
    df = np.abs(mel_k[:, :nf] - mel_f[:, :nf])
    f64 = float(df[:, :128].mean())
    ok = (first <= 1e-3 and agree >= 0.99 and np.isfinite(mel_k).all()
          and launches == (want, want) and f64 < 0.05)
    print(f"long text, {L} symbols, TTSGenerator(backend='kernel', "
          f"steps=480): {mel_k.shape[1]} frames; against the kernel's plain "
          f"version first-64-step max|d| {first:.3g}, within 2e-2 "
          f"{agree:.5f}, max|d| {float(dm.max()):.3g}; against the float32 "
          f"plain backend ({mel_f.shape[1]} frames) mean|d| first 64 steps "
          f"{f64:.4f}, all {float(df.mean()):.4f}, max {float(df.max()):.3g}"
          f"; launches {launches[0]} (global {launches[1]}, want {want}) -> "
          f"{'ok' if ok else 'FAIL'} | {card}", flush=True)
    if not ok:
        fail("the long text through the TTS kernel")
    print(f"phase 6 long texts in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches[1], "max_abs_err": max(errs), **rec}


def tts_phases(dev, card, wavio, voc_weights) -> dict:
    """Phases 6-9: the Tacotron kernel against its plain version, the TTS
    gate, the text -> wav path and its CLI.  Returns the kernel's record."""
    import torch

    from wavernn_tpu_torch.infer.gates import gates_pass, tts_gates
    from wavernn_tpu_torch.infer.pipeline import TTSPipeline
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, init_variables,
    )
    from wavernn_tpu_torch.models.wavernn import WaveRNNConfig
    from wavernn_tpu_torch.ops import cuda_decode, cuda_tts
    from wavernn_tpu_torch.ops.tts_decode import (
        MATRICES, tts_decode_reference,
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
        return tts_kernel_inputs(dev, cfg, variables, seq, L, r)

    errs = []

    def compare(tag, packed, enc, encp, n):
        errs.append(tts_compare(dev, tag, packed, enc, encp, n))

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
        return tts_timed(dev, fn, packed, enc, encp, 750)

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
    tts_placement_ab(dev, card, full, full_vars, packed, enc, encp)
    spans = tts_phase_spans.main(["--steps", "750", "--L", "64"])
    if spans["max_abs_err"] > 1e-3:
        fail("the spans launch disagrees with the plain version")
    long_texts = tts_long_texts(dev, card, full, full_vars)
    # the spans of the long-text path beside L = 64's: 16,384 symbols and
    # int8_lstm one past its shared limit, both in the global placement
    for L, int8 in ((16_384, False), (tts_text_limit(dev, full, True) + 1,
                                      True)):
        rec = tts_phase_spans.phase_spans(*tts_phase_spans.kernel_inputs(
            L, dev, int8_lstm=int8), 96)
        if rec["max_abs_err"] > (0.0 if int8 else 1e-3):
            fail(f"the spans launch at L={L} disagrees with the plain "
                 f"version")
        variant = "int8_lstm" if int8 else "bf16"
        print(f"tts spans [{variant}, global], L {L}, 96 steps: " + ", ".join(
            f"{k} {v:.2f} (L 64: {spans['phase_us'][k]:.2f})"
            for k, v in rec["phase_us"].items())
            + f" us; {rec['us_per_step']:.2f} us/step (L 64: "
            f"{spans['us_per_step']:.2f}); max|d| {rec['max_abs_err']:.3g} | "
            f"{card}", flush=True)

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
    zero_decode_counts()
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
    hp_file = tts_hp_file(meta)
    out_dir = SMOKE_DIR / "tts_cli_out"
    from wavernn_tpu_torch import gen_tacotron

    log, _ = cli_output(gen_tacotron.main, [
        "--input_text", meta["eval_text"], "--tts_weights",
        str(TACO_DIR / "tiny_tacotron.msgpack"), "--hp_file", str(hp_file),
        "--output_dir", str(out_dir), "wavernn", "--voc_weights",
        str(voc_weights)], REPO)
    print("tts cli: " + " | ".join(log.strip().splitlines()[-3:]))
    wavs = sorted(out_dir.glob("__input_*.wav"))
    if len(wavs) != 1:
        fail(f"TTS CLI wrote {wavs}")
    x, sr = wavio.read_wav_raw(wavs[0])
    if sr != 22050 or x.size == 0 or x.size % voc_cfg.hop_length:
        fail(f"TTS CLI WAV: sr {sr}, shape {x.shape}")
    print(f"tts cli: {wavs[0].name} parses: {x.shape[0]} samples at {sr} Hz")
    return {"launches": tts_launches, "max_abs_err": max(errs),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": tts_bound[0],
            "bound_by": tts_bound[1], "global": long_texts, "spans": spans}


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
    zero_decode_counts()
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


def serving_phases(dev, card, cfg, golden, eval_mel, errs: list,
                   frames: int = 1920) -> dict:
    """Phases 15-19: the MCD gate, the wire formats, co-batching,
    streaming and the StreamServer, on the golden MOL at full width, with
    utterances of ``frames`` mel frames (the server's four sessions
    ``frames`` x 1, 5/8, 5/16 and 5/32).  Kernel-vs-plain errors go to
    ``errs``; returns the decode kernel's launches on these paths and what
    was measured."""
    import torch

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.dsp import audio
    from wavernn_tpu_torch.infer.eval import copy_synthesis_mcd
    from wavernn_tpu_torch.infer.stream_server import StreamServer
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.ops.decode import (
        Generator, fold_spans, int8_ff_policy,
    )

    if not hp.is_configured():
        hp.configure(REPO / "hparams.py")
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)
    launches = 0

    def make(**kw):
        kw = {"fold_bucket": 16, "input_dtype": "float16",
              "output_dtype": "int16", **kw}
        return Generator(cfg, golden, device=dev, **kw)

    def counted(fn, main: bool = True):
        """Run ``fn`` with the decode counts set to 0 just before it;
        return (its result, the launches it made), adding them to the main
        path's tally unless ``main`` is False."""
        torch.cuda.synchronize()
        zero_decode_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, (count_main_decode() if main
                     else cuda_decode.decode.launches)

    # -- 15 (a). the MCD gate --------------------------------------------
    meta = json.loads((REPO / "bench_assets" / "golden_meta.json")
                      .read_text())
    threshold = meta["mcd_scan_mean"] + max(4 * meta["mcd_scan_spread"],
                                            3.0)
    # bf16 feed-forward matrices (phase 30 holds the int8 variant to it)
    gen_f = make(output_dtype="float64", int8_ff=False)
    scores, n = counted(lambda: [copy_synthesis_mcd(
        gen_f, eval_mel, batched=True, seed=s, **geom)[0]
        for s in range(3)])
    launches += n
    det_mcd = copy_synthesis_mcd(make(output_dtype="float64",
                                      deterministic=True, int8_ff=False),
                                 eval_mel, batched=True, **geom)[0]
    mcd = float(np.mean(scores))
    print(f"mcd gate (golden eval mel, {eval_mel.shape[1]} frames, f16 in, "
          f"float64 out, bf16 feed-forward matrices, "
          f"sampling, seeds 0-2): {[round(x, 4) for x in scores]} mean "
          f"{mcd:.4f} threshold {threshold:.4f} -> "
          f"{'pass' if mcd < threshold else 'FAIL'}; deterministic "
          f"{det_mcd:.4f}", flush=True)
    if not mcd < threshold:
        fail(f"MCD gate: mean {mcd} >= {threshold}")

    # -- 16 (b). the wire formats -----------------------------------------
    q = (np.clip(np.round(eval_mel * 255.0), 0.0, 255.0)
         * np.float32(1.0 / 255.0)).astype(np.float32)
    u8 = make(input_dtype="uint8", deterministic=True)(eval_mel, True,
                                                         **geom)
    f32 = make(input_dtype="float32", deterministic=True)(q, True, **geom)
    print(f"wire uint8 in (deterministic) vs float32 in of the requantized "
          f"mel: {u8.shape[0]} samples, bit-equal {np.array_equal(u8, f32)}")
    if not np.array_equal(u8, f32):
        fail("uint8 ingress is not bit-equal to float32 of the "
             "requantized mel")
    w8 = make(output_dtype="mulaw8", deterministic=True)(eval_mel, True,
                                                         **geom)
    fl = make(output_dtype="float64", deterministic=True)(eval_mel, True,
                                                          **geom)
    d = np.abs(w8.astype(np.float64)
               - audio.encode_mu_law(np.clip(fl, -1, 1), 256))
    print(f"wire mulaw8 out (deterministic) vs encode_mu_law(float path): "
          f"max {d.max():.0f} label, exact {np.mean(d == 0):.6f}")
    if w8.dtype != np.uint8 or w8.shape != fl.shape or d.max() > 1:
        fail("mulaw8 egress is more than 1 label from the float path")
    bf_mcd = copy_synthesis_mcd(make(input_dtype="bfloat16",
                                     output_dtype="float64"), eval_mel,
                                batched=True, **geom)[0]
    mu_mcd = copy_synthesis_mcd(
        make(output_dtype="mulaw8"), eval_mel, batched=True, **geom,
        to_float=lambda w: audio.decode_mu_law(w.astype(np.float64), 256))[0]
    print(f"wire MCD (sampling, seed 0): bfloat16 in {bf_mcd:.4f}, mulaw8 "
          f"out {mu_mcd:.4f} (gate {threshold:.4f})", flush=True)
    if not (np.isfinite(bf_mcd) and np.isfinite(mu_mcd)):
        fail("a wire format gave no MCD")

    # -- 17 (c). co-batching -----------------------------------------------
    rng = np.random.default_rng(0)
    mels5 = [rng.uniform(0, 1, (cfg.feat_dims, frames)).astype(np.float32)
             for _ in range(5)]
    gen = make()
    gen.generate_batch(mels5, **geom)                          # warm
    gen.collect_batch(gen.submit_batch(mels5, **geom))
    staged = gen.prestage_batch(mels5, TARGET, OVERLAP)
    cond, T = gen.batch_conditioning(staged)
    rows = cond.shape[0]
    head = cond[:, :64].contiguous()
    for det in (True, False):
        out_k = cuda_decode.decode(gen.packed, head, 64, 3, cfg.mode,
                                   cfg.n_classes, det)
        torch.cuda.synchronize()
        out_p = cuda_decode.decode_reference(gen.packed, head, 64, 3,
                                             cfg.mode, cfg.n_classes, det)
        err = float((out_k - out_p).abs().max())
        print(f"kernel vs plain [co-batched conditioning, "
              f"{'deterministic' if det else 'sampling'}] rows {rows} "
              f"steps 64: max|d| {err:.3g}", flush=True)
        if err > (1e-3 if det else 1e-2) or not torch.isfinite(out_k).all():
            fail(f"kernel disagrees with its plain version at {rows} rows")
        errs.append(err)
    del head
    step_us = {arm: [] for arm in DESIGN_ARMS}
    for arm in DESIGN_ARMS + DESIGN_ARMS[::-1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        cuda_decode.decode(gen.packed, cond, T, 9, cfg.mode, cfg.n_classes,
                           False, design=arm[0], rows_per_cta=arm[1])
        end.record()
        torch.cuda.synchronize()
        step_us[arm].append(start.elapsed_time(end) * 1e3 / T)
    del cond
    print(f"decode step at {rows} x {T} (co-batched, sampling, bf16 ff): "
          + ", ".join(f"{d} design R={r} "
                      f"{[round(x, 2) for x in step_us[d, r]]} us/step"
                      for d, r in DESIGN_ARMS) + f" | {card}", flush=True)

    def oneshot(p):
        return gen.generate_batch(mels5, seed=1_000_000 + p, **geom)

    def pipelined(p):
        hs = []
        for s, m in enumerate(mels5):
            hs.append(gen.submit(gen.prestage(m, True, TARGET, OVERLAP),
                                 True, seed=p * 5 + s + 1, **geom))
        for h in hs:
            gen.prefetch(h)
        return [gen.collect(h) for h in hs]

    co_k = 3
    co_launches = []

    def costeady(p):
        """co_k co-batched serves, each one's successor submitted (and its
        batch staged) before it is collected."""
        waves = []
        n0 = cuda_decode.decode.launches
        b = gen.prestage_batch(mels5, TARGET, OVERLAP)
        h = gen.submit_batch(b, seed=2_000_000 + p * co_k, **geom)
        gen.prefetch_batch(h)
        for k in range(1, co_k + 1):
            h2 = None
            if k < co_k:
                b = gen.prestage_batch(mels5, TARGET, OVERLAP)
                h2 = gen.submit_batch(b, seed=2_000_000 + p * co_k + k,
                                      **geom)
                gen.prefetch_batch(h2)
            waves += gen.collect_batch(h)
            h = h2
        co_launches.append(cuda_decode.decode.launches - n0)
        return waves

    want = [(m.shape[1] - 1) * cfg.hop_length for m in mels5]
    rates = {"oneshot": [], "pipelined": [], "cobatch_steady": []}

    def serve_passes():
        for p in range(3):
            for name, fn in (("oneshot", oneshot), ("pipelined", pipelined),
                             ("cobatch_steady", costeady)):
                t0 = time.perf_counter()
                waves = fn(p)
                dt = time.perf_counter() - t0
                for w, n in zip(waves, want * co_k):
                    if w.dtype != np.int16 or w.shape != (n,) or not (
                            np.abs(w.astype(np.int32)).max() > 256):
                        fail(f"{name}: bad wave {w.dtype} {w.shape}")
                rates[name].append(sum(len(w) for w in waves) / dt / 1e3)

    _, n = counted(serve_passes)
    launches += n
    # int8_ff under "auto": each launch takes the pack the policy gives
    # its width (48 rows a request, 240 a co-batched serve)
    n_ff = cuda_decode.decode.launches_int8_ff
    want_ff = 3 * (10 * int8_ff_policy(None, 48)
                   + co_k * int8_ff_policy(None, rows))
    print(f"co-batching, 5 x {frames} frames, f16 in, int16 out, sampling, "
          "int8_ff auto, 3 interleaved passes: " + ", ".join(
              f"{k} {[round(x, 1) for x in v]} kHz (median "
              f"{float(np.median(v)):.1f})" for k, v in rates.items())
          + f"; launches {n}, {n_ff} with int8 feed-forward matrices "
          f"(policy: {want_ff}) (co-batched serves: {co_launches} for "
          f"{co_k} each) | {card}", flush=True)
    if co_launches != [co_k] * 3 or n != 3 * (5 + 5 + co_k):
        fail("a co-batched serve was not exactly one decode launch")
    if n_ff != want_ff:
        fail(f"{n_ff} launches took the int8 feed-forward pack, the "
             f"policy gives {want_ff}")
    gen_d = make(deterministic=True)
    co = gen_d.generate_batch(gen_d.prestage_batch(mels5, TARGET, OVERLAP),
                              **geom)
    for i, (w, m) in enumerate(zip(co, mels5)):
        solo = gen_d(m, True, **geom)
        lsb = np.abs(w.astype(np.int32) - solo.astype(np.int32))
        agree = float(np.mean(lsb <= 655))
        print(f"co-batched vs solo, deterministic, utterance {i}: "
              f"{agree:.6f} within 655 LSB, exact {np.mean(lsb == 0):.6f}, "
              f"max {int(lsb.max())} LSB")
        if w.shape != solo.shape or agree < 0.99:
            fail("a co-batched utterance disagrees with its solo submit")

    # -- 18 (d). streaming -------------------------------------------------
    mel_s = np.random.default_rng(7).uniform(
        0, 1, (cfg.feat_dims, frames)).astype(np.float32)
    needed = gen.open_stream_session(mel_s, TARGET, OVERLAP).needed_folds
    stream_rec = {}
    for group in (32, 48):
        kw = dict(geom, group=group, first_group=4)
        n_spans = len(fold_spans(needed, group, 4))
        for _ in gen.stream(mel_s, seed=0, **kw):                # warm
            pass
        ttfc, khz = [], []
        for p in range(5):
            torch.cuda.synchronize()
            zero_decode_counts()
            t0 = time.perf_counter()
            first, total = None, 0
            for chunk in gen.stream(mel_s, seed=p + 1, **kw):
                if first is None:
                    first = time.perf_counter() - t0
                total += len(chunk)
            dt = time.perf_counter() - t0
            n = count_main_decode()
            launches += n
            if n != n_spans:
                fail(f"stream group {group}: {n} launches for {n_spans} "
                     "fold spans")
            if total != (mel_s.shape[1] - 1) * cfg.hop_length:
                fail(f"stream group {group}: {total} samples")
            ttfc.append(first * 1e3)
            khz.append(total / dt / 1e3)
        stream_rec[group] = (float(np.median(khz)), float(np.median(ttfc)))
        print(f"stream {frames} frames, group {group}, first group 4, int16: "
              f"stream_khz {[round(x, 1) for x in khz]} (median "
              f"{stream_rec[group][0]:.1f}), ttfc_ms "
              f"{[round(x, 1) for x in ttfc]} (median "
              f"{stream_rec[group][1]:.1f}); launches per stream "
              f"{n_spans} = fold spans | {card}", flush=True)
    kw = dict(geom, group=32, first_group=4)
    streamed = np.concatenate(list(gen_d.stream(mel_s, **kw)))
    oneshot_w = gen_d.stream_oneshot(mel_s, **kw)
    print(f"deterministic stream vs stream_oneshot: {streamed.shape[0]} "
          f"samples, byte-equal {np.array_equal(streamed, oneshot_w)}")
    if not np.array_equal(streamed, oneshot_w):
        fail("stream differs from stream_oneshot")

    # -- 19 (e). the StreamServer ------------------------------------------
    rng = np.random.default_rng(11)
    sess_mels = [rng.uniform(0, 1, (cfg.feat_dims, f)).astype(np.float32)
                 for f in (frames, frames * 5 // 8, frames * 5 // 16,
                           frames * 5 // 32)]
    solo, solo_launches = counted(lambda: [np.concatenate(list(
        gen_d.stream(m, group=16, **geom))) for m in sess_mels], main=False)
    sizes = "/".join(str(m.shape[1]) for m in sess_mels)
    server_rec = {}
    for width in (64, 132):
        srv = StreamServer(gen_d, group=16, width=width, capacity=4, **geom)
        t0 = time.perf_counter()
        got, n = counted(lambda: srv.run(sess_mels))
        dt = time.perf_counter() - t0
        launches += n
        n_ff = cuda_decode.decode.launches_int8_ff
        if int8_ff_policy(None, 16) and n_ff != n:
            fail(f"server width {width}: {n_ff} of {n} launches took the "
                 "int8 feed-forward pack under auto")
        equal = all(np.array_equal(g, w) for g, w in zip(got, solo))
        khz = sum(len(g) for g in got) / dt / 1e3
        server_rec[width] = khz
        print(f"stream server, 4 sessions ({sizes} frames), "
              f"deterministic, group 16, width {width}, int8_ff auto: "
              f"{khz:.1f} kHz aggregate, launches {srv.launches} ({n_ff} "
              f"with int8 feed-forward matrices; solo streams "
              f"{solo_launches}), byte-equal to solo {equal} | {card}",
              flush=True)
        if not equal:
            fail(f"a server session (width {width}) differs from its solo "
                 "stream")
        if srv.launches != n or srv.launches >= solo_launches:
            fail(f"server launches {srv.launches} not below the solo "
                 f"streams' {solo_launches}")
    return {"launches": launches, "rows": rows, "step_us": step_us,
            "mcd": mcd, "stream": stream_rec, "server": server_rec}


def int8_ff_phases(dev, card, cfg, golden, raw_cfg, tiny_raw, eval_mel,
                   raw_mel, frames: int = 1920) -> dict:
    """Phases 27-30: the decode kernel's int8 feed-forward variant against
    its plain version, the crossover sweep that sets the width policy,
    serving through the variant forced on, and the MCD gate with it.
    Returns the variant's kernel-vs-plain errors and its launches on the
    serving paths."""
    import torch

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.infer.eval import copy_synthesis_mcd
    from wavernn_tpu_torch.infer.stream_server import StreamServer
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.ops.decode import (
        FF_AUTO_MIN_ROWS, Generator, int8_ff_policy,
    )
    from wavernn_tpu_torch.tools import step_opt_probe

    if not hp.is_configured():
        hp.configure(REPO / "hparams.py")
    errs, errs_row, launches = [], [], 0
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)

    # -- 27. the variant against its plain version ------------------------
    for tag, mcfg, v, mel, (target, overlap) in (
            ("golden MOL", cfg, golden, eval_mel, (TARGET, OVERLAP)),
            ("tiny RAW", raw_cfg, tiny_raw, raw_mel, (1000, 12))):
        for int8_hh in (True, False):
            gen = Generator(mcfg, v, device=dev, fold_bucket=16,
                            int8_hh=int8_hh, int8_ff=True)
            staged = gen.prestage(mel, batched=True, target=target,
                                  overlap=overlap)
            gen._ensure_ff_scales(staged.mels_dev, 16)
            cond = gen.fold_conditioning(staged)[0][:16, :ROW0_STEPS].contiguous()
            if cond.shape[:2] != (16, 1024):
                fail(f"conditioning {tuple(cond.shape)} too small")
            q = "int8_hh" if int8_hh else "bf16 hh"
            for det in (True, False):
                seed = 0 if det else 1234
                out_p = cuda_decode.decode_reference(
                    gen.packed_ff, cond, 1024, seed, mcfg.mode,
                    mcfg.n_classes, det)
                for design, rows in DESIGN_ARMS:
                    out_k = cuda_decode.decode(
                        gen.packed_ff, cond, 1024, seed, mcfg.mode,
                        mcfg.n_classes, det, rows_per_cta=rows, design=design)
                    torch.cuda.synchronize()
                    d = (out_k - out_p).abs()
                    first = float(d[:, :64].max())
                    agree = float((d <= 2e-2).float().mean())
                    ok = ((first <= 1e-3 and agree >= 0.99) if det
                          else first <= 1e-2)
                    kind = "deterministic" if det else "sampling"
                    print(f"int8_ff kernel vs plain [{tag} {q} {design} "
                          f"R={rows} {kind}] rows 16 steps 1024: first-64 "
                          f"max|d| {first:.3g}, within 2e-2 {agree:.5f}, "
                          f"max|d| {float(d.max()):.3g} -> "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
                    if not ok or not torch.isfinite(out_k).all():
                        fail(f"the int8_ff kernel disagrees with its plain "
                             f"version [{tag} {q} {design} R={rows} {kind}]")
                    (errs if design == "cluster" else errs_row).append(first)

    # -- 28. the crossover sweep ------------------------------------------
    sweep = step_opt_probe.ab_int8_ff(
        *step_opt_probe.golden_setup(dev, golden, cfg, eval_mel),
        widths=step_opt_probe.WIDTHS, T=2048, passes=3, reps=2,
        log=lambda line: print(line, flush=True), designs=DESIGNS,
        gates_widths=GATES_WIDTHS)
    for w in sweep["widths"]:
        if w["rows"] in GATES_WIDTHS:
            g = {d: w["designs"][d]["int8_gates"]["median_us_per_step"]
                 for d in DESIGNS}
            ff_us = w["designs"]["cluster"]["int8_ff"]["median_us_per_step"]
            print(f"int8_gates at {w['rows']} rows x 2048: cluster design "
                  f"{g['cluster']:.2f} us/step, row design {g['row']:.2f} "
                  f"(medians; int8_ff on the cluster design {ff_us:.2f}) | "
                  f"{card}", flush=True)
    lost = [w["rows"] for w in sweep["widths"] if w["delta_median"] >= 0]
    print(f"int8_ff policy: auto from {FF_AUTO_MIN_ROWS} rows; the sweep's "
          f"crossover {sweep['crossover_rows']}, int8_ff slower at "
          f"{lost or 'no width'} | {card}", flush=True)
    if any(int8_ff_policy(None, r) for r in lost):
        fail(f"the policy turns int8_ff on at {lost} rows, where it lost")

    # -- 29. serving through the variant, forced on -----------------------
    def make(**kw):
        return Generator(cfg, golden, device=dev, **{
            "fold_bucket": 16, "input_dtype": "float16",
            "output_dtype": "int16", "int8_ff": True, **kw})

    rng = np.random.default_rng(0)
    mels5 = [rng.uniform(0, 1, (cfg.feat_dims, frames)).astype(np.float32)
             for _ in range(5)]
    gen = make()
    gen.collect_batch(gen.submit_batch(mels5, **geom))           # warm
    staged = gen.prestage_batch(mels5, TARGET, OVERLAP)
    cond, _ = gen.batch_conditioning(staged)
    rows = cond.shape[0]
    head = cond[:, :64].contiguous()
    del cond
    for det in (True, False):
        out_k = cuda_decode.decode(gen.packed_ff, head, 64, 3, cfg.mode,
                                   cfg.n_classes, det)
        torch.cuda.synchronize()
        out_p = cuda_decode.decode_reference(gen.packed_ff, head, 64, 3,
                                             cfg.mode, cfg.n_classes, det)
        err = float((out_k - out_p).abs().max())
        print(f"int8_ff kernel vs plain [co-batched conditioning, "
              f"{'deterministic' if det else 'sampling'}] rows {rows} steps "
              f"64: max|d| {err:.3g}", flush=True)
        if err > (1e-3 if det else 1e-2) or not torch.isfinite(out_k).all():
            fail(f"the int8_ff kernel disagrees with its plain version at "
                 f"{rows} rows")
        errs.append(err)
    del head
    khz = []
    want = [(m.shape[1] - 1) * cfg.hop_length for m in mels5]
    for p in range(3):
        torch.cuda.synchronize()
        zero_decode_counts()
        t0 = time.perf_counter()
        waves = gen.collect_batch(gen.submit_batch(
            gen.prestage_batch(mels5, TARGET, OVERLAP), seed=p, **geom))
        dt = time.perf_counter() - t0
        n_ff = cuda_decode.decode.launches_int8_ff
        n = count_main_decode()
        launches += n
        if n != 1 or n_ff != 1:
            fail(f"a forced co-batched serve made {n} launches, {n_ff} "
                 "with the int8 pack")
        if [w.shape[0] for w in waves] != want or any(
                np.abs(w.astype(np.int32)).max() <= 256 for w in waves):
            fail("a forced co-batched serve gave a bad wave")
        khz.append(sum(want) / dt / 1e3)
    print(f"int8_ff forced, 5 x {frames} frames co-batched ({rows} rows, "
          f"one launch each, int8 pack), f16 in, int16 out, sampling: "
          f"{[round(x, 1) for x in khz]} kHz (median "
          f"{float(np.median(khz)):.1f}) | {card}", flush=True)

    gen_d = make(deterministic=True)
    rng = np.random.default_rng(11)
    sess_mels = [rng.uniform(0, 1, (cfg.feat_dims, f)).astype(np.float32)
                 for f in (frames, frames * 5 // 8, frames * 5 // 16,
                           frames * 5 // 32)]
    solo = [np.concatenate(list(gen_d.stream(m, group=16, **geom)))
            for m in sess_mels]
    srv = StreamServer(gen_d, group=16, width=132, capacity=4, **geom)
    torch.cuda.synchronize()
    zero_decode_counts()
    t0 = time.perf_counter()
    got = srv.run(sess_mels)
    dt = time.perf_counter() - t0
    n_ff = cuda_decode.decode.launches_int8_ff
    n = count_main_decode()
    launches += n
    equal = all(np.array_equal(g, w) for g, w in zip(got, solo))
    print(f"int8_ff forced, stream server, 4 sessions, deterministic, group "
          f"16, width 132: {sum(len(g) for g in got) / dt / 1e3:.1f} kHz "
          f"aggregate, launches {n} ({n_ff} with the int8 pack), "
          f"byte-equal to solo streams {equal} | {card}", flush=True)
    if n == 0 or n_ff != n or not equal:
        fail("the forced stream server did not serve its sessions through "
             "the int8 pack, or differs from the solo streams")

    # -- 30. the MCD gate with the variant forced --------------------------
    meta = json.loads((REPO / "bench_assets" / "golden_meta.json")
                      .read_text())
    threshold = meta["mcd_scan_mean"] + max(4 * meta["mcd_scan_spread"],
                                            3.0)
    gen_f = make(output_dtype="float64")
    torch.cuda.synchronize()
    zero_decode_counts()
    scores = [copy_synthesis_mcd(gen_f, eval_mel, batched=True, seed=s,
                                 **geom)[0] for s in range(3)]
    n_ff = cuda_decode.decode.launches_int8_ff
    n = count_main_decode()
    launches += n
    det_mcd = copy_synthesis_mcd(make(output_dtype="float64",
                                      deterministic=True), eval_mel,
                                 batched=True, **geom)[0]
    mcd = float(np.mean(scores))
    print(f"mcd gate, int8_ff forced (golden eval mel, "
          f"{eval_mel.shape[1]} frames, f16 in, float64 out, sampling, "
          f"seeds 0-2): {[round(x, 4) for x in scores]} mean {mcd:.4f} "
          f"threshold {threshold:.4f} -> "
          f"{'pass' if mcd < threshold else 'FAIL'}; deterministic "
          f"{det_mcd:.4f}; launches {n} ({n_ff} with the int8 pack)",
          flush=True)
    if not mcd < threshold or n_ff != n or n == 0:
        fail(f"MCD gate with int8_ff: mean {mcd} >= {threshold}, or "
             f"{n - n_ff} launches without the int8 pack")
    return {"errs": errs, "errs_row": errs_row, "launches": launches,
            "mcd": mcd, "crossover": sweep["crossover_rows"]}


def http_get(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    if resp.status != 200:
        fail(f"GET {path}: {resp.status} {body}")
    return body


def pcm_of(body: bytes, sample_rate: int) -> np.ndarray:
    """The int16 samples of a 16-bit mono WAV body; fails on any other."""
    import struct

    if body[:4] != b"RIFF" or body[8:16] != b"WAVEfmt ":
        fail(f"not a WAV: {body[:64]!r}")
    _, fmt, ch, sr, _, _, bits = struct.unpack("<IHHIIHH", body[16:36])
    if (fmt, ch, sr, bits) != (1, 1, sample_rate, 16) or \
            body[36:40] != b"data":
        fail(f"WAV header {(fmt, ch, sr, bits)}")
    return np.frombuffer(body[44:], "<i2")


def concurrently(fn, args) -> list:
    """fn(a) for every a, each on its own thread; results in order."""
    import threading

    results = [None] * len(args)

    def run(i):
        results[i] = fn(args[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
        if t.is_alive():
            fail("a request thread did not finish in 900 s")
    if any(r is None for r in results):
        fail("a concurrent request failed")
    return results


def device_events(prof) -> list:
    """(start us, end us, name) of every event the card ran in a
    torch.profiler run, from the profiler's raw results: ``prof.events()``
    builds an event object for each at ~0.1 ms apiece (minutes for the
    Tacotron step's 400 k)."""
    from torch.autograd import DeviceType

    return [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def kernel_times(prof) -> dict:
    """{name: (total us, launches)} of the card's events."""
    by_name = {}
    for a, b, name in device_events(prof):
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + b - a, n + 1)
    return by_name


def device_busy(prof):
    """(device events, busy us, longest idle gap us) of a torch.profiler
    run: busy is the union of the card's kernel spans."""
    spans = sorted((a, b) for a, b, _ in device_events(prof))
    busy, gap, end = 0.0, 0.0, None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                gap = max(gap, a - end)
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return len(spans), busy, gap


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def text_serving_phases(dev, card, voc_cfg, golden, eval_mel) -> dict:
    """Phases 20-23: the two-stage server, the HTTP daemon in process at
    full width, the serve CLI and Griffin-Lim.  Returns both kernels'
    launches on these paths."""
    import threading

    import torch

    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.dsp import audio, torch_audio, wavio
    from wavernn_tpu_torch.infer.http_server import (SynthesisService,
                                                     make_http_server)
    from wavernn_tpu_torch.infer.pipeline import TTSPipeline, mel_from_linear
    from wavernn_tpu_torch.infer.stream_server import TTSStreamServer
    from wavernn_tpu_torch.models.tacotron import (TacotronConfig,
                                                   init_variables)
    from wavernn_tpu_torch.ops import cuda_decode, cuda_tts
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.tools.http_serve_probe import post
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    if not hp.is_configured():
        hp.configure(REPO / "hparams.py")
    meta = json.loads((TACO_DIR / "tiny_tacotron_meta.json").read_text())
    blob = load_pytree(TACO_DIR / "tiny_tacotron.msgpack")
    taco = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    taco_cfg = TacotronConfig(**meta["dims"])
    cleaners = ["english_cleaners"]
    hop, sr = voc_cfg.hop_length, voc_cfg.sample_rate
    decode_launches = tts_launches = 0

    def chunks_of(frames: int, r: int) -> int:
        """TTS kernel launches of a decode that gave ``frames`` frames."""
        return -(-(frames // r) // TTS_CHUNK)

    def reset_counters():
        torch.cuda.synchronize()
        zero_decode_counts()
        cuda_tts.tts_decode.launches = 0

    # -- 20. the two-stage server ----------------------------------------
    r = meta["r"]
    pipe = TTSPipeline(taco_cfg, taco, voc_cfg, golden, cleaners, r=r,
                       device=dev, tts_steps=400, deterministic=True,
                       output_dtype="int16", input_dtype="float16")
    texts = ["abcdeabcde", "edcba abcde", "abcde"]
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)
    solo, want_tts = [], 0
    reset_counters()
    for t in texts:                      # the solo two-stage streams
        m = pipe.tts(text_to_sequence(t, cleaners), r=r)[1]
        want_tts += chunks_of(m.shape[1], r)
        solo.append(np.concatenate(list(pipe.voc.stream(
            mel_from_linear(m), group=16, **geom))))
    torch.cuda.synchronize()
    solo_launches = cuda_decode.decode.launches
    srv = TTSStreamServer(pipe, group=16, width=64, capacity=4, **geom)
    reset_counters()
    t0 = time.perf_counter()
    sids = [srv.add(t) for t in texts]
    pieces = {sid: [] for sid in sids}
    first = {}
    while srv.active:
        for sid, chunk in srv.step().items():
            if isinstance(chunk, Exception):
                fail(f"two-stage session {sid}: {chunk!r}")
            first.setdefault(sid, time.perf_counter() - t0)
            pieces[sid].append(chunk)
    dt = time.perf_counter() - t0
    voc_n, tts_n = count_main_decode(), cuda_tts.tts_decode.launches
    decode_launches += voc_n
    tts_launches += tts_n
    got = [np.concatenate(pieces[sid]) for sid in sids]
    equal = all(g.dtype == np.int16 and np.array_equal(g, w)
                for g, w in zip(got, solo))
    khz = sum(len(g) for g in got) / dt / 1e3
    print(f"two-stage server, 3 texts (tiny golden Tacotron -> golden MOL, "
          f"deterministic, int16, group 16): {khz:.2f} kHz aggregate in "
          f"{dt:.3f} s; time to first chunk "
          f"{[round(first[s] * 1e3, 1) for s in sids]} ms; launches: "
          f"vocoder {voc_n} (solo streams {solo_launches}), tts {tts_n} "
          f"(want {want_tts}); byte-equal to solo {equal} | {card}",
          flush=True)
    if not equal:
        fail("a two-stage session differs from its solo stream")
    if not voc_n < solo_launches or tts_n != want_tts:
        fail("the two-stage server's launches are not co-batched or miss "
             "the TTS kernel")

    # -- 21. the HTTP daemon at full width --------------------------------
    full = TacotronConfig()
    full_pipe = TTSPipeline(full, init_variables(full, 0), voc_cfg, golden,
                            cleaners, r=2, device=dev, tts_steps=800,
                            output_dtype="int16", input_dtype="float16")
    rng = np.random.default_rng(21)
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                rng.integers(3, 9))) for _ in range(40)]
    req_texts = [" ".join(words[10 * i:10 * i + 10]) + "." for i in range(4)]
    want_len, want_tts = [], 0
    for t in req_texts:                  # the kernel decode is deterministic
        m = full_pipe.tts(text_to_sequence(t, cleaners), r=2)[1]
        want_len.append((m.shape[1] - 1) * hop)
        want_tts += 2 * chunks_of(m.shape[1], 2)
    service = SynthesisService(full_pipe, target=TARGET, overlap=OVERLAP,
                               mu_law=False, group=16, capacity=4)
    httpd = make_http_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    try:
        health = http_get(port, "/health")
        if health["ok"] is not True or health["sample_rate"] != sr:
            fail(f"/health: {health}")
        for path in ("/synthesize", "/stream"):                # warm
            post(port, path, "warm up.")
        reset_counters()
        launches0 = http_get(port, "/health")["launches"]
        batches = {}
        for path in ("/synthesize", "/stream"):
            t0 = time.perf_counter()
            res = concurrently(lambda t: post(port, path, t), req_texts)
            wall = time.perf_counter() - t0
            for (body, _, _), n, t in zip(res, want_len, req_texts):
                pcm = pcm_of(body, sr)
                if pcm.shape != (n,) or not np.abs(pcm.astype(np.int32)
                                                   ).max() > 256:
                    fail(f"{path} {t!r}: {pcm.shape} samples (want {n}), "
                         f"max |x| {np.abs(pcm.astype(np.int32)).max()}")
            samples = sum(want_len)
            batches[path] = (samples / wall / 1e3, wall,
                             [x[2] for x in res], [x[1] for x in res])
        torch.cuda.synchronize()
        voc_n, tts_n = count_main_decode(), cuda_tts.tts_decode.launches
        health = http_get(port, "/health")
        for path, (khz, wall, lat, ttfb) in batches.items():
            print(f"http {path}, 4 concurrent requests (full-width untrained "
                  f"Tacotron, tts_steps 800, r=2 -> golden MOL, f16 in, "
                  f"int16 out, sampling, 4 sessions): {khz:.2f} kHz "
                  f"aggregate ({sum(want_len)} samples in {wall:.3f} s); "
                  f"latency {[round(x, 3) for x in lat]} s"
                  + (f"; TTFB {[round(x * 1e3, 1) for x in ttfb]} ms"
                     if path == "/stream" else "") + f" | {card}",
                  flush=True)
        print(f"http launches in the 8 requests: vocoder {voc_n}, tts "
              f"{tts_n} (want {want_tts}); /health launches "
              f"{health['launches']} (stream-server launches in the "
              f"requests {health['launches'] - launches0}), served "
              f"{health['served_sessions']} sessions, "
              f"{health['served_audio_seconds']} s", flush=True)
        decode_launches += voc_n
        tts_launches += tts_n
        if voc_n < 5 or tts_n != want_tts:
            fail("the HTTP requests did not run through both kernels")

        # the card's busy share over a batch of four streams
        from torch.profiler import ProfilerActivity, profile

        reset_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = concurrently(lambda t: post(port, "/stream", t),
                               req_texts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        decode_launches += count_main_decode()
        tts_launches += cuda_tts.tts_decode.launches
        n_events, busy, gap = device_busy(prof)
        if n_events:
            print(f"http /stream x 4 under torch.profiler: wall "
                  f"{wall:.3f} s, {n_events} device events, busy "
                  f"{busy / 1e6:.3f} s = {busy / 1e6 / wall:.4f} of the "
                  f"wall time, longest idle gap {gap / 1e3:.1f} ms; TTFB "
                  f"{[round(x[1] * 1e3, 1) for x in res]} ms | {card}",
                  flush=True)
        else:
            print("http /stream x 4 under torch.profiler: no device "
                  "events recorded; busy share not measured", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    del full_pipe, service

    # -- 22. the serve CLI -------------------------------------------------
    hp_file = tts_hp_file(meta)
    port = free_port()
    log_path = SMOKE_DIR / "serve.log"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "wavernn_tpu_torch.serve", "--hp_file",
             str(hp_file), "--tts_weights",
             str(TACO_DIR / "tiny_tacotron.msgpack"), "--voc_weights",
             str(GOLDEN), "--deterministic", "--slot_seconds", "10",
             "--port", str(port)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            up = None
            while up is None:
                if proc.poll() is not None:
                    fail(f"serve exited {proc.returncode}:\n"
                         f"{log_path.read_text()[-3000:]}")
                if time.perf_counter() - t0 > 300:
                    fail("serve did not answer /health in 300 s")
                try:
                    up = http_get(port, "/health")
                except OSError:
                    time.sleep(0.5)
            ready = time.perf_counter() - t0
            text = meta["eval_text"]
            one, _, one_s = post(port, "/synthesize", text)
            streamed, ttfb, stream_s = post(port, "/stream", text)
            a, b = pcm_of(one, sr), pcm_of(streamed, sr)
            print(f"serve CLI: /health after {ready:.1f} s; /synthesize "
                  f"{len(a)} samples in {one_s:.3f} s, /stream {len(b)} "
                  f"in {stream_s:.3f} s (TTFB {ttfb * 1e3:.1f} ms); "
                  f"byte-equal {np.array_equal(a, b)} | {card}", flush=True)
            if len(a) == 0 or not np.array_equal(a, b):
                fail("the serve CLI's /stream and /synthesize PCM differ")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print("serve CLI: " + " | ".join(
        line.strip() for line in log_path.read_text().splitlines()
        if "Warm-up" in line or "Using device" in line)
        + f"; exit {code} after SIGTERM")
    if code != 0:
        fail(f"serve exited {code} after SIGTERM:\n"
             f"{log_path.read_text()[-3000:]}")

    # -- 23. Griffin-Lim on the card ---------------------------------------
    torch_audio.reconstruct_waveform(eval_mel[:, :64], n_iter=2,
                                     device=dev)                  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = torch_audio.reconstruct_waveform(eval_mel, n_iter=32, device=dev)
    gl_s = time.perf_counter() - t0
    if wav.shape != ((eval_mel.shape[1] - 1) * hop,) or \
            not np.isfinite(wav).all():
        fail(f"Griffin-Lim gave {wav.shape}")
    S = torch_audio.mel_to_linear(eval_mel, dev)
    S_cpu = torch_audio.mel_to_linear(eval_mel, "cpu")
    phase = torch.rand(S.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0)) * (2 * np.pi)
    gl = dict(n_iter=32, hop_length=hp.hop_length,
              win_length=hp.win_length)
    with torch.no_grad():
        on_card = torch_audio.griffinlim(S, phase, **gl).cpu().numpy()
        on_cpu = torch_audio.griffinlim(S_cpu, phase.cpu(), **gl).numpy()
    rel = float(np.linalg.norm(on_card - on_cpu) / np.linalg.norm(on_cpu))
    s_rel = float((S.cpu() - S_cpu).norm() / S_cpu.norm())
    t = np.arange(sr // 2) / sr
    tone = torch_audio.reconstruct_waveform(audio.melspectrogram(
        (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)), n_iter=32,
        device=dev)
    spec = np.abs(np.fft.rfft(tone * np.hanning(len(tone))))
    freqs = np.fft.rfftfreq(len(tone), 1 / sr)
    band = (freqs > 200) & (freqs < 900)
    centroid = float((freqs[band] * spec[band]).sum() / spec[band].sum())
    share = float(spec[band].sum() / spec.sum())
    print(f"griffin-lim on the card: golden eval mel ({eval_mel.shape[1]} "
          f"frames), 32 iterations, {gl_s * 1e3:.1f} ms ({len(wav)} samples "
          f"= {len(wav) / gl_s / 1e3:.1f} kHz); card vs cpu from one phase: "
          f"NNLS rel {s_rel:.3g}, waveform rel RMS {rel:.3g}, max |d| "
          f"{float(np.abs(on_card - on_cpu).max()):.3g}; 440 Hz tone: "
          f"centroid {centroid:.1f} Hz, band share {share:.4f} | {card}",
          flush=True)
    if not rel <= 1e-3:
        fail(f"Griffin-Lim on the card is {rel:.3g} (relative RMS) from "
             "the CPU")
    if not (abs(centroid - 440) < 50 and share > 0.8):
        fail("Griffin-Lim does not give back the 440 Hz tone")
    out_dir = SMOKE_DIR / "gl_cli_out"
    from wavernn_tpu_torch import gen_tacotron

    log, _ = cli_output(gen_tacotron.main, [
        "--input_text", meta["eval_text"], "--tts_weights",
        str(TACO_DIR / "tiny_tacotron.msgpack"), "--hp_file", str(hp_file),
        "--output_dir", str(out_dir), "griffinlim"], REPO)
    print("gl cli: " + " | ".join(log.strip().splitlines()[-3:]))
    wavs = sorted(out_dir.glob("__input_*_griffinlim_*.wav"))
    if len(wavs) != 1:
        fail(f"griffinlim CLI wrote {wavs}")
    x, got_sr = wavio.read_wav_raw(wavs[0])
    if got_sr != sr or x.size == 0 or x.size % hop or not np.isfinite(x).all():
        fail(f"griffinlim CLI WAV: sr {got_sr}, shape {x.shape}")
    print(f"gl cli: {wavs[0].name} parses: {x.shape[0]} samples at "
          f"{got_sr} Hz")
    return {"decode_launches": decode_launches,
            "tts_launches": tts_launches}


# phases 24-26 train hparams.py's vocoder at full width; the corpus of
# phase 25
TRAIN_UTTS, TRAIN_SAMPLES = 72, 44_000
# phases 25 and 32 preprocess in one process: each spawned worker of the
# pool imports torch, which for a few dozen utterances costs more than it
# saves (tests/test_torch_data.py holds the pool to one worker's output)
PREPROCESS_WORKERS = 1


def synthetic_corpus(wav_dir: Path, sr: int, texts=None) -> None:
    """TRAIN_UTTS utterances (one per text of ``texts`` when given) of
    TRAIN_SAMPLES samples from ``np.random.default_rng(0)``: a sine of
    random pitch with 1-4 harmonics, plus noise, and an LJSpeech
    ``metadata.csv`` whose texts are ``texts`` (default "Sentence <i>.")."""
    from wavernn_tpu_torch.dsp import wavio

    rng = np.random.default_rng(0)
    wav_dir.mkdir(parents=True)
    t = np.arange(TRAIN_SAMPLES) / sr
    lines = []
    for i in range(TRAIN_UTTS if texts is None else len(texts)):
        f0 = rng.uniform(90, 300)
        y = sum(rng.uniform(0.1, 0.4) / k * np.sin(2 * np.pi * k * f0 * t
                                                   + rng.uniform(0, 6.3))
                for k in range(1, int(rng.integers(1, 5)) + 1))
        y = y + 0.02 * rng.standard_normal(TRAIN_SAMPLES)
        y = 0.9 * y / max(1.0, np.abs(y).max())
        wavio.save_wav(y.astype(np.float32), wav_dir / f"utt{i:03d}.wav", sr)
        text = texts[i] if texts is not None else f"Sentence {i}."
        lines.append(f"utt{i:03d}|{text}|{text}")
    (wav_dir / "metadata.csv").write_text("\n".join(lines) + "\n")


@contextlib.contextmanager
def relu_masks(record=None, pinned=None):
    """A context in which ``F.relu`` appends each call's mask (x > 0) to
    ``record``, and with ``pinned`` applies the masks of an earlier run in
    its order instead of its own: a float32 run then follows the float64
    run's branches exactly."""
    import torch.nn.functional as F

    relu, it = F.relu, iter(pinned or ())

    def probe(x, inplace=False):
        if record is not None:
            record.append(x > 0)
        return x * next(it).to(x) if pinned is not None else relu(x)

    F.relu = probe
    try:
        yield
    finally:
        F.relu = relu


def is_pcm16(path: Path) -> bool:
    """The WAV's first chunk is a fmt chunk of 16-bit integer PCM."""
    import struct

    data = path.read_bytes()
    fmt, _, _, _, _, bits = struct.unpack_from("<HHIIHH", data, 20)
    return data[12:16] == b"fmt " and fmt == 1 and bits == 16


def training_phases(dev, card) -> dict:
    """Phases 24-26: the train step on the card against the CPU, the
    training path end to end, and the training rate."""
    import re
    import shutil

    import torch

    from wavernn_tpu_torch import gen_wavernn, preprocess, train_wavernn
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.data.dataset import get_vocoder_datasets
    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.models.wavernn import (
        WaveRNN, WaveRNNConfig, num_params, to_jax_variables,
    )
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.paths import Paths
    from wavernn_tpu_torch.pruning import (
        PruneConfig, Pruner, measured_sparsity,
    )
    from wavernn_tpu_torch.training.state import (
        Adam, make_optimizer, new_train_state,
    )
    from wavernn_tpu_torch.training.wavernn import (
        batch_to, make_train_step, voc_train_loop,
    )
    from wavernn_tpu_torch.utils.checkpoints import (
        load_pytree, restore_checkpoint,
    )

    work = SMOKE_DIR / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    overrides = dict(wav_path=str(work / "wavs"),
                     data_path=str(work / "data"), voc_total_steps=30,
                     voc_checkpoint_every=15, voc_gen_at_checkpoint=1,
                     voc_test_samples=2)
    hp_file = work / "hp_train.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"{k} = {v!r}\n" for k, v in overrides.items()))
    hp.reset()
    hp.configure(hp_file)
    cfg = WaveRNNConfig.from_hp(hp)
    B, T = hp.voc_batch_size, hp.voc_seq_len
    mel_win = T // hp.hop_length + 2 * hp.voc_pad

    def seeded_model(device):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return WaveRNN(cfg).to(device)

    # -- 24. the train step on the card against the CPU -------------------
    from wavernn_tpu_torch.ops.mol import discretized_mix_logistic_loss

    class KeepGrads(Adam):
        def step(self, model, state):
            self.grads = {n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()}
            return super().step(model, state)

    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        y = rng.uniform(-1, 1, (4, T + 1)).astype(np.float32)
        batches.append((y[:, :-1], y[:, 1:], rng.uniform(
            0, 1, (4, mel_win, cfg.feat_dims)).astype(np.float32)))

    def gradients(d, dt, **masks):
        """Step 1's gradients without the update, in dtype dt."""
        model = seeded_model(d).to(dt).train()
        x, y, mels = (torch.from_numpy(np.ascontiguousarray(a)).to(d, dt)
                      for a in batches[0])
        with relu_masks(**masks):
            discretized_mix_logistic_loss(model(x, mels), y).backward()
        return {n: p.grad.cpu() for n, p in model.named_parameters()}

    runs, ref, flips, pinned = [], {}, {}, {}
    for d in (dev, torch.device("cpu")):
        ref[d.type] = []                  # the float64 forward's masks
        g64 = gradients(d, torch.float64, record=ref[d.type])
        opt = KeepGrads(hp.voc_lr, hp.voc_clip_grad_norm)
        state = new_train_state(seeded_model(d), opt)
        step = make_train_step(opt, cfg.mode)
        t0 = time.perf_counter()
        seen = []
        with relu_masks(record=seen):
            _, loss1, gn1 = step(state, *batches[0])
        flips[d.type] = [int((a != b).sum()) for a, b in
                         zip(seen, ref[d.type])]
        grads = opt.grads
        stats = {n: b.detach().cpu().clone() for n, b in
                 state.model.named_buffers() if "running" in n}
        _, loss2, _ = step(state, *batches[1])
        loss1, loss2, gn1 = float(loss1), float(loss2), float(gn1)
        runs.append((loss1, loss2, gn1, grads, stats,
                     time.perf_counter() - t0, num_params(state.model),
                     g64))
        pinned[d.type] = gradients(d, torch.float32, pinned=ref[d.type])
    ((l1, l2, gn, g, st, secs, n_par, g64),
     (c1, c2, cgn, cg, cst, csecs, _, c64)) = runs
    d_loss1, d_loss2 = abs(l1 - c1) / abs(c1), abs(l2 - c2) / abs(c2)
    rel = lambda a, b: float((a.double() - b.double()).norm()
                             / b.double().norm().clamp_min(1e-300))
    worst = lambda a, b: max((rel(a[n], b[n]), n) for n in b)
    d_grad, at = worst(g, cg)
    flat = lambda gs: torch.cat([gs[n].double().flatten() for n in cg])
    d_global = rel(flat(g), flat(cg))
    d_stats = max(float((st[n] - cst[n]).abs().max()) for n in cst)
    d64 = worst(g64, c64)[0]
    same_masks = all(bool((a.cpu() == b).all())
                     for a, b in zip(ref[dev.type], ref["cpu"]))
    d_pin, at_pin = worst(pinned[dev.type], pinned["cpu"])
    print(f"train step card vs cpu ({n_par:.3f}M "
          f"params, {cfg.mode}, B=4 x {T}, TF32 off): loss {l1:.6f} / "
          f"{c1:.6f} (rel {d_loss1:.3g}), step-2 loss rel {d_loss2:.3g}, "
          f"grad norm {gn:.6f} / {cgn:.6f}, BatchNorm stats max|d| "
          f"{d_stats:.3g}; gradients rel L2: worst tensor {d_grad:.3g} "
          f"({at}), all together {d_global:.3g}; ReLU masks flipped "
          f"against the float64 forward's (per site, the last two fc1 and "
          f"fc2): card {flips[dev.type]}, cpu {flips['cpu']}; with every "
          f"mask pinned to the float64 forward's: worst tensor {d_pin:.3g} "
          f"({at_pin}), float32 vs float64 worst card "
          f"{worst(pinned[dev.type], g64)[0]:.3g}, cpu "
          f"{worst(pinned['cpu'], c64)[0]:.3g}; float64 card vs cpu worst "
          f"{d64:.3g}, masks equal {same_masks}; two steps {secs:.2f} s on "
          f"the card, {csecs:.2f} s on the CPU | {card}", flush=True)
    # Each float32 gradient holds 1e-4 with the ReLU masks pinned; the
    # plain step's gradients 5e-4 per tensor and 2e-4 all together: a mask
    # that float32 rounding flips at fc1 or fc2 (one or two of 2.8 M, on
    # either device) moves every conditioning gradient by ~1e-4.
    if not (d_loss1 <= 1e-5 and d_loss2 <= 1e-4 and d_stats <= 1e-5
            and d_pin <= 1e-4 and d_grad <= 5e-4 and d_global <= 2e-4
            and d64 <= 1e-9 and same_masks):
        fail("the train step on the card disagrees with the CPU")

    # -- 25. the training path end to end ----------------------------------
    synthetic_corpus(work / "wavs", hp.sample_rate)
    _, secs = cli_output(preprocess.main, [
        "--hp_file", str(hp_file), "--num_workers", str(PREPROCESS_WORKERS)],
        work)
    n_mels = len(list((work / "data" / "mel").glob("*.npy")))
    print(f"train path (a): preprocess of {TRAIN_UTTS} utterances -> "
          f"{n_mels} mels in {secs:.1f} s", flush=True)
    if n_mels != TRAIN_UTTS:
        fail(f"preprocess wrote {n_mels} mels")

    paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id, base=work)
    opt = make_optimizer(hp.voc_lr, hp.voc_clip_grad_norm)
    state = restore_checkpoint("voc", paths,
                               new_train_state(seeded_model(dev), opt),
                               create_if_missing=True)
    train_set, test_set = get_vocoder_datasets(paths.data, B, False)
    np.random.seed(0)
    torch.cuda.synchronize()
    zero_decode_counts()
    t0 = time.perf_counter()
    voc_train_loop(paths, cfg, state, opt, train_set, test_set,
                   hp.voc_total_steps, lr=hp.voc_lr)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    decode_launches = count_main_decode()
    logged = [float(x) for x in re.findall(r"Loss: (\S+) \|",
                                           paths.voc_log.read_text())]
    print(f"\ntrain path (b): voc_train_loop to step {state.step} "
          f"({len(train_set)} batches of {B} x {T} an epoch) in {secs:.1f} "
          f"s with 2 checkpoints; logged mean losses {logged}; decode "
          f"launches {decode_launches} | {card}", flush=True)
    if state.step != hp.voc_total_steps:
        fail(f"the loop stopped at step {state.step}")
    if not logged or not np.isfinite(logged).all():
        fail("a loss the loop fetched is not finite")
    if decode_launches != 2:
        fail(f"the auditions launched the decode kernel {decode_launches} "
             "times, want 2")
    test_id = test_set.dataset.metadata[0]      # the first audition's
    want_len = len(np.load(paths.quant / f"{test_id}.npy"))
    auditions = sorted(paths.voc_output.glob("0k_steps_1_gen_batched_*.wav"))
    if len(auditions) != 1:
        fail(f"auditions written: {auditions}")
    pcm, sr = wavio.read_wav_raw(auditions[0])
    lsb = float(np.std(pcm)) * 32768
    print(f"train path (b): audition {auditions[0].name}: int16 "
          f"{is_pcm16(auditions[0])}, {pcm.shape[0]} samples at {sr} Hz "
          f"(utterance {want_len}), std {lsb:.0f} LSB", flush=True)
    if not (is_pcm16(auditions[0]) and sr == hp.sample_rate
            and pcm.shape == (want_len,) and lsb > 10):
        fail("the audition WAV is not int16 of the utterance's length, or "
             "is silence")
    for name in ("latest", "wave_step0K"):
        for kind in ("weights", "optim"):
            if not (paths.voc_checkpoints / f"{name}_{kind}.msgpack").exists():
                fail(f"missing {name}_{kind}.msgpack")
    blob = load_pytree(paths.voc_latest_weights)
    mine = to_jax_variables(state.model)
    for tree in ("params", "batch_stats"):
        stack = [(blob[tree], mine[tree])]
        while stack:
            a, b = stack.pop()
            if isinstance(b, dict):
                if set(a) != set(b):
                    fail(f"written {tree} keys differ")
                stack += [(a[k], b[k]) for k in b]
            elif not np.array_equal(a, b):
                fail(f"the written {tree} differ from the model's")
    if int(blob["step"]) != hp.voc_total_steps:
        fail(f"written step {blob['step']}")
    print("train path (b): latest and wave_step0K pairs written; the "
          "latest weights equal the model's", flush=True)

    hp40 = work / "hp_train40.py"
    hp40.write_text(hp_file.read_text() + "voc_total_steps = 40\n")
    out, secs = cli_output(train_wavernn.main, [
        "--hp_file", str(hp40), "--device", str(dev)], work)
    start = re.search(r"Start Step \|\n.*\n\|.*\|\s+(\d+)\s+\|", out)
    print(f"train path (c): train_wavernn in process in {secs:.1f} s: "
          + " | ".join(l.strip() for l in out.splitlines()
                       if "Restoring" in l or "Training Complete" in l),
          flush=True)
    if "Restoring from latest checkpoint" not in out:
        fail("train_wavernn did not restore the latest pair")
    if start is None or int(start.group(1)) != hp.voc_total_steps:
        fail(f"train_wavernn did not start at step {hp.voc_total_steps}")
    step40 = int(load_pytree(paths.voc_latest_weights)["step"])
    if step40 != 40:
        fail(f"train_wavernn stopped at step {step40}")
    mel = paths.mel / f"{test_id}.npy"
    cli_output(gen_wavernn.main, [
        "--hp_file", str(hp40), "--file", str(mel), "--output_dir",
        str(work / "gen"), "--device", str(dev)], work)
    wavs = sorted((work / "gen").glob("*.wav"))
    if len(wavs) != 1:
        fail(f"gen_wavernn wrote {wavs}")
    x, sr = wavio.read_wav_raw(wavs[0])
    print(f"train path (d): gen_wavernn on the step-40 weights: "
          f"{wavs[0].name} parses, {x.shape[0]} samples at {sr} Hz",
          flush=True)
    if sr != hp.sample_rate or x.shape != (want_len,):
        fail(f"gen_wavernn WAV: sr {sr}, shape {x.shape}")

    # -- 26. training rate ---------------------------------------------------
    np.random.seed(1)
    train_set.num_workers = 0
    batch = batch_to(dev, *next(iter(train_set)))

    def timed_steps(state, step, n, masks_at=None):
        """n steps, each timed by CUDA events -> (ms list, losses)."""
        events, losses, masks = [], [], None
        for _ in range(n):
            if masks_at is not None:
                masks = masks_at(state, masks)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            _, loss, _ = step(state, *batch, masks)
            b.record()
            events.append((a, b))
            losses.append(loss)
        torch.cuda.synchronize()
        return ([a.elapsed_time(b) for a, b in events],
                [float(x) for x in losses], masks)

    opt = make_optimizer(hp.voc_lr, hp.voc_clip_grad_norm)
    state = new_train_state(seeded_model(dev), opt)
    step = make_train_step(opt, cfg.mode)
    _, warm_losses, _ = timed_steps(state, step, 3)
    ms, losses, _ = timed_steps(state, step, 20)
    ms_step = float(np.median(ms))
    print(f"voc_train_ms_per_step ({cfg.mode}, B={B} x {T}, "
          f"{num_params(state.model):.3f}M params, TF32 off): median "
          f"{ms_step:.2f} ms over 20 steps (min {min(ms):.2f}, max "
          f"{max(ms):.2f}) = {B * T / ms_step * 1e3:.0f} samples/s; loss "
          f"{warm_losses[0]:.4f} -> {losses[-1]:.4f} | {card}", flush=True)
    if not losses[-1] < warm_losses[0]:
        fail("the train step does not learn on the card")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_steps(state, step, 5)
        wall = time.perf_counter() - t0
    n_events, busy, gap = device_busy(prof)
    top = sorted(kernel_times(prof).items(), key=lambda kv: -kv[1][0])[:6]
    if n_events:
        print(f"train step x 5 under torch.profiler: wall {wall:.3f} s, "
              f"{n_events} device events, busy {busy / 1e6:.3f} s = "
              f"{busy / 1e6 / wall:.4f} of the wall time, longest idle gap "
              f"{gap / 1e3:.1f} ms | {card}", flush=True)
        for name, (us, n) in top:
            print(f"  {us / 1e3 / 5:9.2f} ms/step  {us / busy:.3f} of busy  "
                  f"{n // 5} launches/step  {name[:100]}")
    else:
        print("train step under torch.profiler: no device events recorded; "
              "busy share not measured", flush=True)

    # pruning on the warm state, in turns with the plain step
    pruner = Pruner(PruneConfig(start_step=state.step, prune_every=5,
                                ramp_steps=20))

    def masks_at(state, masks):
        if masks is None:
            masks = pruner.init_masks(state.model)
        return pruner.maybe_update(masks, state.model, state.step + 1)

    plain_ms, _, _ = timed_steps(state, step, 5)
    ms, losses, masks = timed_steps(state, step, 10, masks_at)
    sparsity = measured_sparsity(masks)
    params = dict(state.model.named_parameters())
    pruned = sum(int((m == 0).sum()) for m in masks.values())
    nonzero = sum(int((params[n][m == 0] != 0).sum())
                  for n, m in masks.items())
    plain_ms += timed_steps(state, step, 5)[0]
    print(f"pruned train step (masks every 5 steps, a 20-step ramp from "
          f"the first): median {float(np.median(ms)):.2f} ms over 10 steps "
          f"(mask updates at steps 5 and 10: {ms[4]:.2f}, {ms[9]:.2f} ms) "
          f"against {float(np.median(plain_ms)):.2f} ms for 10 plain steps "
          f"in turns; measured sparsity {sparsity:.4f} after 10 steps, "
          f"{pruned} pruned weights, {nonzero} of them nonzero; loss "
          f"{losses[-1]:.4f} | {card}", flush=True)
    if not (sparsity > 0 and nonzero == 0 and np.isfinite(losses).all()):
        fail("pruning did not zero the pruned weights")
    hp.reset()
    return {"decode_launches": decode_launches, "ms_per_step": ms_step}


# phases 31-33 train hparams.py's Tacotron at full width: the cut
# curriculum's sessions (r, lr, max_step, batch size), hparams.py's r, lr
# and batch sizes with max_step cut to two steps a session; the first run
# stops after session 1, the second resumes in session 2.  64 utterances
# are two whole batches of 32: session 1 sees every one, the attention
# example (the longest, the first of equals) included.
TTS_CUT_SCHEDULE = [(7, 1e-3, 2, 32), (5, 1e-4, 4, 32), (2, 1e-4, 6, 16)]
TTS_UTTS = 64
TTS_WORDS = ("the quick brown fox jumps over a lazy dog while seven small "
             "birds sing in the tall green trees near an old stone bridge "
             "and two children read their books").split()
TTS_PROBE = dict(B=16, L=100, T=600, r=2)    # tools/tts_train_probe.py's


def word_texts(n: int, seed: int = 0) -> list:
    """n seeded texts of 4-12 words of TTS_WORDS, capitalized, with a
    full stop."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(TTS_WORDS, int(rng.integers(4, 13))))
            .capitalize() + "." for _ in range(n)]


def in_process(main, argv, cwd: Path):
    """Run a CLI's ``main(argv)`` in this process from ``cwd``, with the
    hp singleton reset around it."""
    from wavernn_tpu_torch.config import hp

    here = os.getcwd()
    hp.reset()
    os.chdir(cwd)
    try:
        return main(argv)
    finally:
        os.chdir(here)
        hp.reset()


def cli_output(main, argv, cwd: Path):
    """``in_process(main, argv, cwd)`` with its standard output captured:
    returns (that output, seconds).  The caller's hp configuration is put
    back after it; an exception (SystemExit too) fails the smoke with the
    output's end.  A CLI run here saves a process start-up, CUDA's and the
    kernels' loading (~8-15 s a run)."""
    import io
    import traceback

    from wavernn_tpu_torch.config import hp

    saved = hp.snapshot()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            in_process(main, argv, cwd)
    except BaseException as e:
        fail(f"{main.__module__} {' '.join(argv)} raised {e!r}:\n"
             f"{buf.getvalue()[-2000:]}\n{traceback.format_exc()[-3000:]}")
    finally:
        if saved:
            hp.configure_from_dict(saved)
    return buf.getvalue(), time.perf_counter() - t0


def tts_training_phases(dev, card) -> dict:
    """Phases 31-33: the Tacotron train step on the card against the CPU,
    the Tacotron training path end to end (train_tacotron, resume, GTA,
    train_wavernn --gta, gen_wavernn --gta, gen_tacotron --save_attention,
    the TTS kernel on the trained weights) and the training rate.  Returns
    both kernels' launches on the path, the TTS kernel's max |d| on the
    trained weights and tts_train_ms_per_step."""
    import re
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wavernn_tpu_torch import (
        gen_tacotron, gen_wavernn, preprocess, train_tacotron, train_wavernn,
    )
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, draw_decoder_masks, from_jax_variables,
        init_variables, keep_mask,
    )
    from wavernn_tpu_torch.models.wavernn import num_params
    from wavernn_tpu_torch.ops import cuda_tts
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.text.symbols import symbols
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )
    from wavernn_tpu_torch.training.tacotron import make_tts_train_step
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    hp.reset()
    hp.configure(REPO / "hparams.py")
    cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
    cleaners, sample_rate = hp.tts_cleaner_names, hp.sample_rate
    tts_id, voc_id = hp.tts_model_id, hp.voc_model_id
    clip = hp.tts_clip_grad_norm
    hp.reset()
    v0 = init_variables(cfg, 0)

    # -- 31. the Tacotron train step on the card against the CPU ----------
    t_phase = time.perf_counter()
    B, L, T, r = 4, 40, 48, 2
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, cfg.num_chars, (B, L)))
    m = torch.from_numpy(rng.uniform(-4, 4, (B, T, cfg.n_mels)))
    g = torch.Generator().manual_seed(0)
    keep = 1.0 - cfg.dropout
    dec_masks = draw_decoder_masks(cfg, T // r, B, "cpu", g)
    enc_masks = [keep_mask((B, L, w), keep, "cpu", g)
                 for w in (2 * cfg.encoder_dims, cfg.encoder_dims)]

    def one_step(d, dt, **relu):
        """(loss, gradients, running statistics, secs) of one train-mode
        forward and backward on device d in dtype dt, the masks shared."""
        model = from_jax_variables(v0, cfg, d).to(dt).train()
        t0 = time.perf_counter()
        xd, md = x.to(d), m.to(d, dt)
        with relu_masks(**relu):
            m1, m2, _ = model(xd, md, r, True,
                              masks=[t.to(d) for t in dec_masks],
                              encoder_masks=[t.to(d) for t in enc_masks])
            loss = (m1 - md).abs().mean() + (m2 - md).abs().mean()
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        if d.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        stats = {n: b.cpu() for n, b in model.named_buffers()
                 if "running" in n}
        return float(loss.detach()), grads, stats, secs

    ref, runs = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        ref[side] = []                    # the float64 forward's ReLU masks
        runs[(side, 64)] = one_step(d, torch.float64, record=ref[side])
        seen = []
        runs[(side, 32)] = one_step(d, torch.float32, record=seen)
        runs[(side, "flips")] = [int((a != b).sum()) for a, b in
                                 zip(seen, ref[side])]
        runs[(side, "pinned")] = one_step(d, torch.float32,
                                          pinned=ref[side])
    rel = lambda a, b: float((a.double() - b.double()).norm()
                             / b.double().norm().clamp_min(1e-300))
    live = [n for n, t in runs[("cpu", 64)][1].items()
            if float(t.abs().max()) > 0]

    def gaps(a, b):
        """Per-tensor relative L2 of gradients a against b, worst first."""
        return sorted(((rel(a[n], b[n]), n) for n in live), reverse=True)

    def stats_gap(a, b):
        return max(float((a[n].double() - b[n].double()).abs().max())
                   for n in b)

    l64, g64, s64, secs64 = runs[("card", 64)]
    c64, cg64, cs64, csecs64 = runs[("cpu", 64)]
    l32, g32, s32, secs32 = runs[("card", 32)]
    c32, cg32, cs32, _ = runs[("cpu", 32)]
    _, pg32, _, _ = runs[("card", "pinned")]
    _, cpg32, _, _ = runs[("cpu", "pinned")]
    d64 = gaps(g64, cg64)
    d32 = gaps(g32, cg32)
    d32_64 = gaps(g32, cg64)
    dpin = gaps(pg32, cpg32)
    same_masks = all(bool((a.cpu() == b).all())
                     for a, b in zip(ref["card"], ref["cpu"]))
    flat = lambda gs: torch.cat([gs[n].double().flatten() for n in live])
    n_par = num_params(from_jax_variables(v0, cfg, "cpu"))
    print(f"tts train step card vs cpu ({n_par:.3f}M params, "
          f"B={B}, L={L}, T={T}, r={r}, dropout {cfg.dropout}, zoneout "
          f"masks shared, TF32 off): float64 loss {l64:.12f} / {c64:.12f} "
          f"(rel {abs(l64 - c64) / c64:.3g}), worst gradient {d64[0][0]:.3g}"
          f" ({d64[0][1]}), BatchNorm stats max|d| {stats_gap(s64, cs64):.3g}"
          f"; float32 loss rel {abs(l32 - c32) / c32:.3g}, stats max|d| "
          f"{stats_gap(s32, cs32):.3g}, gradients rel L2 all together "
          f"{rel(flat(g32), flat(cg32)):.3g}, per tensor worst "
          + ", ".join(f"{a:.3g} ({n})" for a, n in d32[:4])
          + f"; float32 card vs float64 cpu worst {d32_64[0][0]:.3g} "
          f"({d32_64[0][1]}); ReLU masks flipped against the float64 "
          f"forward's: card {sum(runs[('card', 'flips')])}, cpu "
          f"{sum(runs[('cpu', 'flips')])} of "
          f"{sum(int(t.numel()) for t in ref['cpu'])} (float64 masks equal "
          f"{same_masks}); with every mask pinned: worst tensor "
          f"{dpin[0][0]:.3g} ({dpin[0][1]}); one step {secs64:.2f} s "
          f"float64 / {secs32:.2f} s float32 on the card, {csecs64:.2f} s "
          f"float64 on the CPU | {card}", flush=True)
    print("  float32 gradient gap per tensor, card vs cpu (rel L2): "
          + ", ".join(f"{n} {a:.2e}" for a, n in d32), flush=True)
    if not (abs(l64 - c64) <= 1e-12 * c64 and d64[0][0] <= 1e-9
            and stats_gap(s64, cs64) <= 1e-9 and same_masks
            and abs(l32 - c32) <= 1e-5 * c32 and stats_gap(s32, cs32) <= 1e-5
            and dpin[0][0] <= 1e-4 and d32[0][0] <= 1e-4):
        fail("the Tacotron train step on the card disagrees with the CPU")
    print(f"phase 31 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()

    # -- 32. the Tacotron training path end to end -------------------------
    work = SMOKE_DIR / "tts_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    texts = word_texts(TTS_UTTS)
    synthetic_corpus(work / "wavs", sample_rate, texts)
    base = dict(wav_path=str(work / "wavs"), data_path=str(work / "data"),
                tts_checkpoint_every=2, latest_save_min_interval_s=0.0,
                voc_total_steps=2, voc_checkpoint_every=2,
                voc_gen_at_checkpoint=1, voc_test_samples=2)

    def hp_file(name, **kw):
        path = work / name
        path.write_text(
            "import runpy\n"
            f"globals().update({{k: v for k, v in runpy.run_path("
            f"{str(REPO / 'hparams.py')!r}).items() "
            "if not k.startswith('__')})\n"
            + "".join(f"{k} = {v!r}\n" for k, v in {**base, **kw}.items()))
        return path

    hp1 = hp_file("hp_tts1.py", tts_schedule=TTS_CUT_SCHEDULE[:1])
    hp3 = hp_file("hp_tts3.py", tts_schedule=TTS_CUT_SCHEDULE)

    def run(main, *args):
        return cli_output(main, list(args), work)

    _, secs = run(preprocess.main, "--hp_file", str(hp3),
                  "--num_workers", str(PREPROCESS_WORKERS))
    print(f"tts train path (a): preprocess of {TTS_UTTS} text/audio pairs "
          f"in {secs:.1f} s", flush=True)
    tts_dir = work / "checkpoints" / f"{tts_id}.tacotron"
    lrs = []
    for i, path in enumerate((hp1, hp3)):
        out, secs = run(train_tacotron.main, "--hp_file", str(path),
                        "--device", str(dev))
        sessions = re.findall(r"\| Steps with r=(\d+) ", out)
        step = int(load_pytree(tts_dir / "latest_weights.msgpack")["step"])
        opt = load_pytree(tts_dir / "latest_optim.msgpack")["opt_state"]
        lrs.append(float(opt["1"]["hyperparams"]["learning_rate"]))
        restored = "Restoring from latest checkpoint" in out
        print(f"tts train path (b{i + 1}): train_tacotron in {secs:.1f} s: "
              f"sessions r={sessions}, restored {restored}, stored step "
              f"{step}, learning rate {lrs[-1]:.3g}; "
              + " | ".join(l.strip() for l in out.splitlines()
                           if "Loss:" in l)[-300:] + f" | {card}",
              flush=True)
        want = (["7"], False, 2) if i == 0 else (["5", "2"], True, 6)
        if (sessions, restored, step) != want:
            fail(f"train_tacotron run {i + 1}: sessions {sessions}, "
                 f"restored {restored}, step {step}; want {want}")
    if lrs != [float(np.float32(1e-3)), float(np.float32(1e-4))]:
        fail(f"the stored learning rates {lrs} are not the sessions'")
    for name in ("latest", "taco_step0K"):
        for kind in ("weights", "optim"):
            if not (tts_dir / f"{name}_{kind}.msgpack").exists():
                fail(f"missing {name}_{kind}.msgpack")
    plots = {sub: sorted(p.name for p in (tts_dir / sub).iterdir())
             for sub in ("attention", "mel_plots")}
    if not all(plots.values()):
        fail(f"no training plots: {plots}")
    gta = sorted((work / "data" / "gta").glob("*.npy"))
    mels = sorted((work / "data" / "mel").glob("*.npy"))
    bad = [p.name for p, q in zip(gta, mels)
           if np.load(p).shape != np.load(q).shape
           or not np.isfinite(np.load(p)).all()]
    print(f"tts train path (c): checkpoints {sorted(p.name for p in tts_dir.glob('*.msgpack'))}, "
          f"plots {plots}, GTA mels {len(gta)} of {len(mels)}", flush=True)
    if len(gta) != TTS_UTTS or [p.name for p in gta] != [
            p.name for p in mels] or bad:
        fail(f"the GTA export does not cover every utterance ({bad})")

    out, secs = run(train_wavernn.main, "--hp_file", str(hp3), "--gta",
                    "--device", str(dev))
    voc_dir = work / "checkpoints" / f"{voc_id}.wavernn"
    voc_step = int(load_pytree(voc_dir / "latest_weights.msgpack")["step"])
    print(f"tts train path (d): train_wavernn --gta to step {voc_step} in "
          f"{secs:.1f} s: " + " | ".join(
              l.strip()[:80] for l in out.splitlines()
              if "Gen Rate" in l or "Training Complete" in l), flush=True)
    if voc_step != 2:
        fail(f"train_wavernn --gta stopped at step {voc_step}")

    torch.cuda.synchronize()
    zero_decode_counts()
    t0 = time.perf_counter()
    wavs = in_process(gen_wavernn.main, [
        "--hp_file", str(hp3), "--gta", "--samples", "2", "--output_dir",
        str(work / "gen_gta"), "--device", str(dev)], work)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    voc_launches = count_main_decode()
    lens = [wavio.read_wav_raw(w)[0].shape for w in wavs]
    print(f"tts train path (e): gen_wavernn --gta on the GTA test set: "
          f"{[w.name for w in wavs]} {lens} in {secs:.2f} s, decode "
          f"launches {voc_launches} | {card}", flush=True)
    if len(wavs) != 2 or voc_launches != 2 or any(
            n != (TRAIN_SAMPLES,) for n in lens):
        fail("gen_wavernn --gta did not vocode the GTA test set through "
             "the decode kernel")

    text = texts[0]
    torch.cuda.synchronize()
    cuda_tts.tts_decode.launches = 0
    zero_decode_counts()
    t0 = time.perf_counter()
    (wav_path,) = in_process(gen_tacotron.main, [
        "--input_text", text, "--hp_file", str(hp3), "--save_attention",
        "--output_dir", str(work / "gen_tts"), "--device", str(dev),
        "wavernn"], work)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tts_launches = cuda_tts.tts_decode.launches
    tts_voc_launches = count_main_decode()
    voc_launches += tts_voc_launches
    attn = np.load(wav_path.parent / f"{wav_path.stem}_attention.npy")
    pcm, sr = wavio.read_wav_raw(wav_path)
    print(f"tts train path (f): gen_tacotron --save_attention from the "
          f"step-6 checkpoint: {wav_path.name}, {pcm.shape[0]} samples at "
          f"{sr} Hz, attention {attn.shape} in {secs:.2f} s; launches: tts "
          f"{tts_launches}, decode {tts_voc_launches} | {card}",
          flush=True)
    seq = text_to_sequence(text, cleaners)
    if (tts_launches == 0 or tts_voc_launches == 0
            or attn.shape[1] != len(seq) or pcm.size == 0):
        fail("gen_tacotron did not run the trained model through the TTS "
             "kernel")

    blob = load_pytree(tts_dir / "latest_weights.msgpack")
    trained = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    packed, enc, encp = tts_kernel_inputs(dev, cfg, trained, seq, 64, 2)
    trained_err = tts_compare(dev, "trained step-6 weights, r=2", packed,
                              enc, encp, 200)
    print(f"phase 32 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()

    # -- 33. tts_train_ms_per_step ---------------------------------------
    Bp, Lp, Tp, rp = (TTS_PROBE[k] for k in ("B", "L", "T", "r"))
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.integers(1, 60, (Bp, Lp))).to(dev)
    mp = torch.from_numpy(rng.uniform(-4, 4, (Bp, Tp, cfg.n_mels)).astype(
        np.float32)).to(dev)
    model = from_jax_variables(v0, cfg, dev).train()
    opt = make_optimizer(1e-4, clip)
    state = new_train_state(model, opt)
    step = make_tts_train_step(model, opt, rp)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def timed_steps(n):
        events, losses = [], []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            _, loss, _, _, _ = step(state, xp, mp, gen)
            b.record()
            events.append((a, b))
            losses.append(loss)
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in events], [float(l) for l in
                                                       losses]

    _, warm = timed_steps(1)
    ms, losses = timed_steps(5)
    ms_step = float(np.median(ms))
    print(f"tts_train_ms_per_step (B={Bp}, L={Lp}, T={Tp}, r={rp}, "
          f"{num_params(model):.3f}M params, dropout and zoneout on, TF32 "
          f"off): median {ms_step:.2f} ms over 5 steps (min {min(ms):.2f}, "
          f"max {max(ms):.2f}); loss {warm[0]:.4f} -> {losses[-1]:.4f} | "
          f"{card}", flush=True)
    if not np.isfinite(losses).all():
        fail("a Tacotron train step gave a non-finite loss")
    torch.cuda.synchronize()
    # the card's activity only: ~80 k kernels a step, and the host's op
    # events would multiply what the profiler has to collect
    n_prof = 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_steps(n_prof)
        wall = time.perf_counter() - t0
    n_events, busy, gap = device_busy(prof)
    by_name = kernel_times(prof)
    if n_events:
        print(f"tts train step x {n_prof} under torch.profiler: wall "
              f"{wall:.3f} s, {n_events} device events "
              f"({n_events // n_prof} a step), busy "
              f"{busy / 1e6:.3f} s = {busy / 1e6 / wall:.4f} of the wall "
              f"time, longest idle gap {gap / 1e3:.1f} ms | {card}",
              flush=True)
        for name, (us, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            print(f"  {us / 1e3 / n_prof:9.2f} ms/step  {us / busy:.3f} of "
                  f"busy  {n // n_prof} launches/step  {name[:100]}")
    else:
        print("tts train step under torch.profiler: no device events "
              "recorded; busy share not measured", flush=True)
    print(f"phase 33 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"tts_launches": tts_launches, "decode_launches": voc_launches,
            "max_abs_err": trained_err, "ms_per_step": ms_step,
            "tts_weights": tts_dir / "latest_weights.msgpack", "cfg": cfg,
            "work": work, "hp_file": hp3, "text": text}


# phases 34-36 run the data axis of parallel/: the decode kernel's row0,
# generation and serving over a local mesh (two shards on one card, and two
# cards where the machine has them), data-parallel training over ranks
MESH_FRAMES = (1920, 1200, 600, 300)   # the StreamServer's four sessions
ROW0_STEPS = 1024                      # phase 34: 16 rows x these steps


def parallel_phases(dev, card, cfg, golden, eval_mel, long_mel) -> dict:
    """Phases 34-36.  Returns the main path's decode launches (phase 35's
    serving runs) and the max |d| of phase 34 for each feed-forward
    variant."""
    import torch

    from wavernn_tpu_torch import gen_wavernn
    from wavernn_tpu_torch.infer.stream_server import StreamServer
    from wavernn_tpu_torch.ops import cuda_decode
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.parallel.mesh import make_mesh
    from wavernn_tpu_torch.tools import mesh_kernel_probe, multihost_smoke

    def make(mesh=None, **kw):
        kw = {"fold_bucket": 16, "input_dtype": "float16",
              "output_dtype": "int16", **kw}
        return Generator(cfg, golden, device=dev, mesh=mesh, **kw)

    # -- 34. the decode kernel with row0 ----------------------------------
    t_phase = time.perf_counter()
    gen = make()
    staged = gen.prestage(eval_mel, True, TARGET, OVERLAP)
    cond = gen.fold_conditioning(staged)[0][:16, :ROW0_STEPS].contiguous()
    gen._ensure_ff_scales(staged.mels_dev, 48)
    errs = {}
    for variant, packed in (("bf16 ff", gen.packed),
                            ("int8_ff", gen.packed_ff)):
        run = lambda c, row0=0, ref=False: (
            cuda_decode.decode_reference if ref else cuda_decode.decode)(
            packed, c, ROW0_STEPS, 1234, cfg.mode, cfg.n_classes, False,
            row0=row0)
        whole = run(cond)
        worst = []
        for k, b in ((4, 8), (9, 7)):
            part = cond[k:k + b].contiguous()
            got = run(part, k)
            d_plain = float((got - run(part, k, True)).abs().max())
            d_whole = float((got - whole[k:k + b]).abs().max())
            print(f"decode row0={k} [{variant}] rows {b} x {ROW0_STEPS} steps, "
                  f"sampling, golden MOL: max|d| vs plain(row0={k}) "
                  f"{d_plain}, vs rows [{k}, {k + b}) of the 16-row launch "
                  f"{d_whole}")
            if d_plain != 0.0 or d_whole != 0.0:
                fail(f"row0={k} [{variant}]: the kernel differs from its "
                     "plain version or from the whole launch's rows")
            worst.append(d_plain)
        errs[variant] = max(worst)
    del cond
    print(f"phase 34 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # -- 35. generation and serving over a mesh ----------------------------
    t_phase = time.perf_counter()
    meshes = [make_mesh({"data": 2}, devices=[dev, dev])]
    if torch.cuda.device_count() >= 2:
        meshes.append(make_mesh(devices=["cuda:0", "cuda:1"]))
    rng = np.random.default_rng(0)
    mels5 = [rng.uniform(0, 1, (80, 1920)).astype(np.float32)
             for _ in range(5)]
    rng = np.random.default_rng(11)
    sess_mels = [rng.uniform(0, 1, (80, f)).astype(np.float32)
                 for f in MESH_FRAMES]
    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)
    launches = 0

    def counted(fn):
        """(fn's result, its decode launches, wall s), the card
        synchronized; the launches count on the main path."""
        torch.cuda.synchronize()
        zero_decode_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, count_main_decode(), time.perf_counter() - t0

    for plan in meshes:
        n = plan.n_data
        for det in (False, True):
            mode = "deterministic" if det else "sampling"
            plain, meshed = (make(deterministic=det),
                             make(plan, deterministic=det))
            paths = {
                "one-shot": lambda g: [g(long_mel, True, seed=3, **geom)],
                "co-batched x5": lambda g: g.generate_batch(
                    g.prestage_batch(mels5, TARGET, OVERLAP), seed=4,
                    **geom),
                "stream g32/4": lambda g: list(g.stream(
                    long_mel, group=32, first_group=4, seed=5, **geom)),
                "StreamServer w64": lambda g: StreamServer(
                    g, group=16, width=64, capacity=4, seed=6,
                    **geom).run(sess_mels),
            }
            for g in (plain, meshed):       # warm: builds, calibrates
                paths["one-shot"](g)
            for name, fn in paths.items():
                (want, n_p, s_p), (got, n_m, s_m) = (counted(lambda: fn(
                    plain)), counted(lambda: fn(meshed)))
                launches += n_p + n_m
                equal = len(got) == len(want) and all(
                    np.array_equal(a, b) for a, b in zip(got, want))
                samples = sum(len(w) for w in want)
                print(f"mesh {plan.describe()} [{name}, {mode}]: "
                      f"byte-equal {equal}, launches {n_m} against {n_p} "
                      f"meshless; {samples / s_m / 1e3:.1f} kHz against "
                      f"{samples / s_p / 1e3:.1f} | {card}", flush=True)
                if not equal:
                    fail(f"mesh output differs from the meshless Generator "
                         f"[{name}, {mode}, {plan.describe()}]")
                if n_m != n * n_p:
                    fail(f"{n_m} decode launches over {n} shards against "
                         f"{n_p} meshless [{name}]")
    # the model axis: the fold rows split over the data axis, shard k on
    # the first device of model row k
    plan = make_mesh({"data": 2, "model": 2}, devices=[dev] * 4)
    for det in (False, True):
        mode = "deterministic" if det else "sampling"
        plain, meshed = (make(deterministic=det),
                         make(plan, deterministic=det))
        one_shot = lambda g: g(long_mel, True, seed=3, **geom)
        for g in (plain, meshed):
            one_shot(g)
        (want, n_p, s_p), (got, n_m, s_m) = (counted(lambda: one_shot(
            plain)), counted(lambda: one_shot(meshed)))
        launches += n_p + n_m
        equal = np.array_equal(got, want)
        print(f"mesh {plan.describe()} [one-shot, {mode}]: byte-equal "
              f"{equal}, launches {n_m} against {n_p} meshless; "
              f"{len(want) / s_m / 1e3:.1f} kHz against "
              f"{len(want) / s_p / 1e3:.1f} | {card}", flush=True)
        if not equal:
            fail(f"the (data 2, model 2) mesh's output differs from the "
                 f"meshless Generator [{mode}]")
        if n_m != plan.n_data * n_p:
            fail(f"{n_m} decode launches over the data axis of "
                 f"{plan.describe()} against {n_p} meshless")
    del plain, meshed
    if launches == 0:
        fail("phase 35 launched no decode kernel")

    # the CLI and the probe through the tool, two shards on one card
    out_dir = SMOKE_DIR / "cli_mesh_out"
    out, _ = cli_output(gen_wavernn.main, [
        "--file", str(SMOKE_DIR / "eval_mel.npy"), "--voc_weights",
        str(GOLDEN), "--output_dir", str(out_dir), "--hp_file",
        str(REPO / "hparams.py"), "--device", str(dev), "--mesh",
        "--mesh_devices", f"{dev},{dev}"], REPO)
    print("cli --mesh: " + " | ".join(out.strip().splitlines()[-3:]))
    (meshed_wav,) = out_dir.glob("__eval_mel__*.wav")
    (plain_wav,) = (SMOKE_DIR / "cli_out").glob("__eval_mel__*.wav")
    same = meshed_wav.read_bytes() == plain_wav.read_bytes()
    print(f"cli --mesh: {meshed_wav.name} byte-equal to phase 5's meshless "
          f"WAV: {same}")
    if not same:
        fail("gen_wavernn --mesh differs from gen_wavernn")
    # the probe and the launcher of phase 36 in process: each subprocess
    # would only add its own start-up
    try:
        mesh_kernel_probe.main([])
    except SystemExit as e:
        fail(str(e))
    print(f"phase 35 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # -- 36. data-parallel and tensor-parallel training -------------------
    t_phase = time.perf_counter()
    groups = ((["--backend", "gloo"], "two gloo ranks on one card"),
              (["--backend", "nccl", "--processes", "1"],
               "a world of one under NCCL"),
              (["--backend", "gloo", "--processes", "2", "--model", "2"],
               "data 1 x model 2, gloo, one card"))

    def run_group(argv):
        # the launcher waits on its workers, so the groups run at once
        try:
            return multihost_smoke.main(
                ["--device", "cuda", "--size", "full", "--timeout", "400"]
                + argv)
        except RuntimeError as e:
            return e

    summaries = concurrently(run_group, [argv for argv, _ in groups])
    for (_, what), summary in zip(groups, summaries):
        if isinstance(summary, RuntimeError):
            fail(f"multihost_smoke ({what}): {summary}")
        for w in summary["workers"]:
            for key, r in w.items():
                if isinstance(r, dict):
                    print(f"train step [{what}, rank {w['rank']} of "
                          f"{w['world']}, {w['backend']}, {key}, full "
                          f"width]: loss {r['loss']:.6f} (one process "
                          f"{r['single_loss']:.6f}), max|d| loss "
                          f"{r['loss_diff']:.3g} params "
                          f"{r['param_diff']:.3g} statistics "
                          f"{r['stats_diff']:.3g}"
                          + (f" (float32 rounding: the one-process step "
                             f"{r['single_param_diff_to_float64']:.3g} "
                             f"from float64)" if key.endswith("32")
                             else "")
                          + (f"; {r['sharded']} parameters sharded, "
                             f"shards exact {r['shards_exact']}, weights "
                             f"file max|d| {r['tree_diff']:.3g}"
                             if "sharded" in r else "")
                          + f"; {r['ms']:.1f} ms a step against "
                          f"{r['single_ms']:.1f} (three groups at once) | "
                          f"{card}", flush=True)
    print(f"phase 36 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "errs": errs}


# phases 37-39: the DeepMind WaveRNN and NB1, the checkpoint converters,
# quick_start
NB1_SR = 24_000          # NB1's sample rate: one second, 23,999 steps
DM_T = 2_000             # phase 37's card-against-CPU window
DM_DRAW_T = 300          # generation steps, CUDA graph against eager
DM_EAGER_T = 2_400       # eager generation steps timed
NB1_TIMED = 5            # NB1 steps timed by CUDA events
QS_TEXT = ("Scientists at the CERN laboratory say they have discovered a "
           "new particle.")


def tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def weights_phases(dev, card, cfg, golden, long_mel, tts_weights) -> dict:
    """Phases 37-39.  Returns the decode kernel's launches on the main
    path (phases 38-39) and the TTS kernel's (phase 39)."""
    import copy
    import shutil
    import zipfile

    import torch

    from wavernn_tpu_torch import quick_start
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.examples import nb1_sine_wave
    from wavernn_tpu_torch.models import deepmind_wavernn as dm
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, init_variables,
    )
    from wavernn_tpu_torch.ops import cuda_tts
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.text.symbols import symbols
    from wavernn_tpu_torch.tools import (
        convert_torch_checkpoint, export_torch_checkpoint,
    )
    from wavernn_tpu_torch.training.state import Adam
    from wavernn_tpu_torch.utils.checkpoints import load_pytree, save_pytree

    # -- 37. the DeepMind WaveRNN and NB1 ----------------------------------
    t_phase = time.perf_counter()
    model = dm.DeepMindWaveRNN(dm.DeepMindWaveRNNConfig(),
                               torch.Generator().manual_seed(0))
    py, ct, tc, tf = nb1_sine_wave.sine_batch(NB1_SR)
    window = [torch.from_numpy(a[:, :DM_T]) for a in (py, ct, tc, tf)]
    on_card = copy.deepcopy(model).to(dev)
    cpu64 = copy.deepcopy(model).double()
    with torch.no_grad():
        got = on_card(window[0].to(dev), window[1].to(dev))
        want = cpu64.forward_reference(window[0].double(), window[1].double())
    fwd_err = max(float((g.cpu().double() - w).abs().max())
                  for g, w in zip(got, want))

    def loss_and_grads(m, d, dt):
        m.zero_grad()
        loss = nb1_sine_wave.nb1_loss(
            m, *(a.to(d, dt) for a in window[:2]),
            *(a.to(d) for a in window[2:]))
        loss.backward()
        return float(loss.detach()), {n: p.grad.cpu().double()
                             for n, p in m.named_parameters()}

    l_card, g_card = loss_and_grads(on_card, dev, torch.float32)
    l_cpu, g_cpu = loss_and_grads(cpu64, "cpu", torch.float64)
    gaps = {n: float((g_card[n] - g_cpu[n]).abs().max()) for n in g_cpu}
    worst = max(gaps, key=gaps.get)
    print(f"deepmind hidden 896, NB1 sine, T={DM_T}: fused forward on the "
          f"card (float32, TF32 off) against the plain cell loop on the CPU "
          f"(float64): max|d| logits {fwd_err:.3g}; NB1 loss {l_card:.6f} "
          f"against {l_cpu:.6f}, gradients max|d| {gaps[worst]:.3g} "
          f"({worst}; largest gradient "
          f"{max(float(g.abs().max()) for g in g_cpu.values()):.3g})",
          flush=True)
    if fwd_err > 1e-4 or abs(l_card - l_cpu) > 1e-4 or gaps[worst] > 1e-4:
        fail("the DeepMind WaveRNN on the card disagrees with the CPU")
    del cpu64, got, want

    opt = Adam(1e-3)
    opt_state = opt.init(on_card)
    batch = [torch.from_numpy(a).to(dev) for a in (py, ct, tc, tf)]
    nb1_sine_wave.train_step(on_card, opt, opt_state, batch)     # warm
    ms = []
    for _ in range(NB1_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        nb1_sine_wave.train_step(on_card, opt, opt_state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    print(f"nb1_ms_per_step (B=1, T={NB1_SR - 1}, hidden 896, median of "
          f"{NB1_TIMED}, CUDA events): {float(np.median(ms)):.2f} "
          f"{[round(x, 2) for x in ms]} | {card}", flush=True)
    del opt_state, batch

    # generation: the CUDA graph against the eager steps, then both timed
    draws = [dm._draw(on_card, DM_DRAW_T, torch.Generator().manual_seed(2),
                      batch=2, graphed=graphed) for graphed in (False, True)]
    same = all(torch.equal(a, b) for a, b in zip(draws[0][:2], draws[1][:2]))
    d_logits = max(float((a - b).abs().max())
                   for a, b in zip(draws[0][2:], draws[1][2:]))
    print(f"deepmind generation, 2 rows x {DM_DRAW_T} steps: CUDA graph "
          f"against the eager steps: classes equal {same}, logits max|d| "
          f"{d_logits:.3g}", flush=True)
    if not same or d_logits > 1e-5:
        fail("the graphed DeepMind generation differs from the eager one")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dm._draw(on_card, DM_EAGER_T, torch.Generator().manual_seed(1),
             graphed=False)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wav = dm.generate(on_card, NB1_SR, torch.Generator().manual_seed(1))
    secs = time.perf_counter() - t0
    print(f"deepmind generate (CUDA graph of {dm.GRAPH_STEPS} steps): "
          f"{wav.shape[0]} samples in {secs:.2f} s = "
          f"{wav.shape[0] / secs:.1f} samples/s; eager steps: {DM_EAGER_T} "
          f"in {eager_s:.2f} s = {DM_EAGER_T / eager_s:.1f} samples/s | "
          f"{card}", flush=True)
    if (wav.shape != (NB1_SR,) or not np.isfinite(wav).all()
            or np.abs(wav).max() > 1.0):
        fail(f"deepmind generate gave {wav.shape} {wav.dtype}")

    out = SMOKE_DIR / "nb1" / "nb1_sine.wav"
    t0 = time.perf_counter()
    res = nb1_sine_wave.main(["--steps", "10", "--sample_rate", str(NB1_SR),
                              "--out", str(out), "--device", str(dev)])
    secs = time.perf_counter() - t0
    losses = res["losses"]
    x, sr = wavio.read_wav_raw(out)
    print(f"nb1 example, 10 steps at {NB1_SR} Hz on {dev}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} in "
          f"{secs:.1f} s with generation; {out.name}: {x.shape[0]} samples "
          f"at {sr} Hz | {card}", flush=True)
    if (not np.isfinite(losses).all() or not losses[-1] < losses[0]
            or x.shape != (NB1_SR,) or sr != NB1_SR):
        fail("the NB1 example did not train or write its WAV")
    print(f"phase 37 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # -- 38. the converters at full width ----------------------------------
    t_phase = time.perf_counter()
    work = SMOKE_DIR / "convert"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    hp_file = str(REPO / "hparams.py")
    hp.reset()
    hp.configure(hp_file)
    tts_cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
    hp.reset()
    taco = dict(init_variables(tts_cfg, 0), step=np.asarray(6, np.int32))
    save_pytree(taco, work / "tacotron.msgpack")
    converted = {}
    for model_kind, src in (("wavernn", GOLDEN),
                            ("tacotron", work / "tacotron.msgpack")):
        pyt, back = work / f"{model_kind}.pyt", work / f"{model_kind}_back.msgpack"
        t0 = time.perf_counter()
        in_process(export_torch_checkpoint.main,
                   [model_kind, str(src), str(pyt), "--hp_file", hp_file], work)
        in_process(convert_torch_checkpoint.main,
                   [model_kind, str(pyt), str(back), "--hp_file", hp_file],
                   work)
        secs = time.perf_counter() - t0
        got, want = load_pytree(back), load_pytree(src)
        g, w = dict(tree_leaves(got)), dict(tree_leaves(want))
        bad = [k for k in w if k != ("step",) and (
            k not in g or g[k].dtype != w[k].dtype
            or not np.array_equal(g[k], w[k]))]
        print(f"{model_kind} at full width: export -> .pyt "
              f"({pyt.stat().st_size} bytes, "
              f"{len(torch.load(pyt, weights_only=True))} tensors) -> "
              f"convert in {secs:.2f} s: {len(w) - 1} leaves, {len(bad)} "
              f"differ, step {int(got['step'])} {got['step'].dtype} "
              f"(source {int(want['step'])} {want['step'].dtype})",
              flush=True)
        if bad or g.keys() != w.keys() or int(got["step"]) != int(
                want["step"]) or got["step"].dtype != np.int64:
            fail(f"{model_kind}: export then convert is not the identity "
                 f"({bad[:5]})")
        converted[model_kind] = {"params": got["params"],
                                 "batch_stats": got["batch_stats"]}

    gen = Generator(cfg, golden, device=dev, fold_bucket=16,
                    deterministic=True, input_dtype="float16",
                    output_dtype="int16")
    torch.cuda.synchronize()
    zero_decode_counts()
    want = gen(long_mel, True, TARGET, OVERLAP, mu_law=False)
    gen.update_variables(converted["wavernn"])
    got = gen(long_mel, True, TARGET, OVERLAP, mu_law=False)
    torch.cuda.synchronize()
    conv_launches = count_main_decode()
    same = got.dtype == want.dtype == np.int16 and np.array_equal(got, want)
    print(f"converted golden MOL through the decode kernel, deterministic, "
          f"f16 in, int16 out, {long_mel.shape[1]}-frame mel: "
          f"{got.shape[0]} samples byte-equal to the golden's own tree: "
          f"{same}; decode launches {conv_launches}", flush=True)
    if not same or conv_launches < 2:
        fail("the converted vocoder differs from the golden through the "
             "decode kernel")
    del gen
    print(f"phase 38 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # -- 39. quick_start end to end ----------------------------------------
    t_phase = time.perf_counter()
    work = SMOKE_DIR / "quick_start"
    shutil.rmtree(work, ignore_errors=True)
    (work / "pretrained").mkdir(parents=True)
    for zip_name, weights in ((quick_start.VOC_ZIP, GOLDEN),
                              (quick_start.TTS_ZIP, tts_weights)):
        with zipfile.ZipFile(work / zip_name, "w") as zf:
            zf.write(weights, "latest_weights.msgpack")
    torch.cuda.synchronize()
    cuda_tts.tts_decode.launches = 0
    zero_decode_counts()
    t0 = time.perf_counter()
    written = in_process(quick_start.main, ["-i", QS_TEXT, "--hp_file",
                                            hp_file, "--device", str(dev)],
                         work)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tts_launches = cuda_tts.tts_decode.launches
    qs_launches = count_main_decode()
    x, sr = wavio.read_wav_raw(work / written[0])
    frames = x.shape[0] // cfg.hop_length + 1
    print(f"quick_start -i on the card (golden MOL, phase 32's step-6 "
          f"Tacotron): {written[0]}: {frames} frames -> {x.shape[0]} "
          f"samples at {sr} Hz in {secs:.2f} s = "
          f"{x.shape[0] / secs / 1e3:.1f} kHz; launches: tts "
          f"{tts_launches}, decode {qs_launches} | {card}", flush=True)
    if (written != [Path(f"quick_start/__input_{QS_TEXT[:10]}_0k.wav")]
            or tts_launches == 0 or qs_launches == 0 or sr != 22050
            or x.size == 0 or x.shape[0] % cfg.hop_length):
        fail("quick_start did not speak through both kernels")
    print(f"phase 39 done in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"decode_launches": conv_launches + qs_launches,
            "tts_launches": tts_launches}


def int8_variant_phases(dev, card, cfg, golden, raw_cfg, tiny_raw, eval_mel,
                        raw_mel, main_cond, T: int, long_mel,
                        tts_train, bf16_spans: dict) -> dict:
    """Phases 40-42: the two opt-in kernel variants, int8_gates of the
    decode kernel and int8_lstm of the Tacotron kernel: each against its
    plain version and timed, the ``gen_int8`` path (``gen_wavernn --int8``,
    ``gen_tacotron --int8``, the daemon from an hp file that sets
    ``gen_int8``) and one text -> wav through both; int8_lstm's span per
    phase beside ``bf16_spans`` (phase 6's ``tools.tts_phase_spans``
    record).  Returns both kernels' records."""
    import threading

    import torch

    from wavernn_tpu_torch import gen_tacotron, gen_wavernn, serve
    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.infer.pipeline import mel_from_linear
    from wavernn_tpu_torch.infer.tacotron import TTSGenerator
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, init_variables,
    )
    from wavernn_tpu_torch.ops import cuda_decode, cuda_tts
    from wavernn_tpu_torch.ops.decode import Generator
    from wavernn_tpu_torch.ops.tts_decode import (
        LSTM_MATRICES, MATRICES, tts_decode_reference,
    )
    from wavernn_tpu_torch.text import text_to_sequence
    from wavernn_tpu_torch.tools import tts_phase_spans
    from wavernn_tpu_torch.tools.http_serve_probe import post
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    geom = dict(target=TARGET, overlap=OVERLAP, mu_law=False)
    t_phase = time.perf_counter()

    # -- 40. int8_gates against its plain version -------------------------
    errs, launches = [], 0
    for tag, mcfg, v, mel, (target, overlap) in (
            ("golden MOL", cfg, golden, eval_mel, (TARGET, OVERLAP)),
            ("tiny RAW", raw_cfg, tiny_raw, raw_mel, (1000, 12))):
        gen = Generator(mcfg, v, device=dev, fold_bucket=16, int8_gates=True)
        staged = gen.prestage(mel, batched=True, target=target,
                              overlap=overlap)
        cond = gen.fold_conditioning(staged)[0][:16, :1024].contiguous()
        if cond.shape[:2] != (16, 1024):
            fail(f"conditioning {tuple(cond.shape)} too small")
        for det in (True, False):
            seed = 0 if det else 1234
            n_c = cuda_decode.decode.launches_cluster
            out_k = cuda_decode.decode(gen.packed, cond, 1024, seed,
                                       mcfg.mode, mcfg.n_classes, det)
            torch.cuda.synchronize()
            if cuda_decode.decode.launches_cluster != n_c + 1:
                fail("int8_gates did not launch on the cluster design")
            out_p = cuda_decode.decode_reference(gen.packed, cond, 1024,
                                                 seed, mcfg.mode,
                                                 mcfg.n_classes, det)
            d = (out_k - out_p).abs()
            first = float(d[:, :64].max())
            agree = float((d <= 2e-2).float().mean())
            ok = (first <= 1e-3 and agree >= 0.99) if det else first <= 1e-2
            kind = "deterministic" if det else "sampling"
            print(f"int8_gates kernel vs plain [{tag} {kind}] rows 16 steps "
                  f"1024: first-64 max|d| {first:.3g}, within 2e-2 "
                  f"{agree:.5f}, max|d| {float(d.max()):.3g} -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok or not torch.isfinite(out_k).all():
                fail(f"the int8_gates kernel disagrees with its plain "
                     f"version [{tag} {kind}]")
            errs.append(float(d.max()))

    # timed: the kernel at the main path's shape (48 x 12,100, sampling)
    # on the cluster design and the row design (the A/B arm), the plain
    # version at 16 x 1,024 of the same conditioning (at the full shape it
    # takes ~35 s a run): plain, cluster, row, row, cluster
    gen_g = Generator(cfg, golden, device=dev, fold_bucket=16,
                      input_dtype="float16", output_dtype="int16",
                      int8_gates=True)
    head = main_cond[:16, :1024].contiguous()

    def run_c():
        return cuda_decode.decode(gen_g.packed, main_cond, T, 7, "MOL",
                                  cfg.n_classes, False)

    def run_r():
        return cuda_decode.decode(gen_g.packed, main_cond, T, 7, "MOL",
                                  cfg.n_classes, False, design="row")

    def run_p():
        return cuda_decode.decode_reference(gen_g.packed, head, 1024, 7,
                                            "MOL", cfg.n_classes, False)

    outs, times = timed_in_order((run_p, run_c, run_r, run_r, run_c))
    for design, run in (("cluster", run_c), ("row", run_r)):
        d = (outs[run][:16, :1024] - outs[run_p]).abs()
        if design == "cluster":
            errs.append(float(d.max()))
        print(f"int8_gates kernel vs plain [main path rows 0-15, steps "
              f"0-1023, sampling, {design} design]: max|d| "
              f"{float(d.max()):.3g}", flush=True)
        if float(d[:, :64].max()) > 1e-2 or not torch.isfinite(
                outs[run]).all():
            fail(f"the int8_gates kernel ({design} design) disagrees with "
                 f"its plain version at the main shape")
    g_ms = float(np.mean(times[run_c]))
    gr_ms = float(np.mean(times[run_r]))
    gp_ms = float(np.mean(times[run_p]))
    g_bound = decode_bound(gen_g.packed, main_cond.shape[0], T,
                           main_cond.shape[2])
    print(f"int8_gates decode time at {main_cond.shape[0]} x {T}: cluster "
          f"design {[round(x, 3) for x in times[run_c]]} ms "
          f"({g_ms * 1e3 / T:.2f} us/step), row design "
          f"{[round(x, 3) for x in times[run_r]]} ms ({gr_ms * 1e3 / T:.2f} "
          f"us/step); plain at 16 x 1024 {[round(x, 1) for x in times[run_p]]}"
          f" ms ({gp_ms * 1e3 / 1024:.2f} us/step); bound "
          f"{g_bound[0]:.3f} ms ({g_bound[1]}) | {card}", flush=True)
    del outs, head
    # where int8_gates' step goes on the cluster design: the spans
    # instantiation at the main path's rows, 2,048 steps (phase 3's for
    # int8_ff)
    cond_s = main_cond[:, :2048].contiguous()
    out_s, spans = cuda_decode.decode_cluster_spans(gen_g.packed, cond_s, 2048,
                                                    7, "MOL", 30, False)
    if not torch.equal(out_s, cuda_decode.decode(gen_g.packed, cond_s, 2048,
                                                 7, "MOL", 30, False)):
        fail("the int8_gates spans instantiation differs from the kernel")
    st = spans.cpu().numpy().astype(np.float64)[64:2047]
    parts = np.median(np.diff(st, axis=1), axis=0)
    names = cuda_decode.CLUSTER_SPANS
    print(f"cluster design spans (int8_gates, {cond_s.shape[0]} rows x 2048, "
          f"CTA 0 of cluster 0, medians, us): step "
          f"{np.median(np.diff(st[:, 0])) / 1e3:.2f}; "
          + ", ".join(f"{names[i + 1]} {parts[i] / 1e3:.2f}"
                      for i in range(len(parts)))
          + f", sample {np.median(st[1:, 0] - st[:-1, -1]) / 1e3:.2f} | "
          f"{card}", flush=True)
    del cond_s, out_s, spans
    print(f"phase 40 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()

    # -- 41. the gen_int8 path at full width -------------------------------
    def gates_run(what: str, n_want: int = 1) -> int:
        n_g = cuda_decode.decode.launches_int8_gates
        n = count_main_decode()
        if n_g < n_want or n_g != n:
            fail(f"{what}: {n} decode launches, {n_g} of int8_gates")
        return n

    out_dir = SMOKE_DIR / "int8_gates_cli"
    mel_path = SMOKE_DIR / "long_mel.npy"
    np.save(mel_path, long_mel)
    torch.cuda.synchronize()
    zero_decode_counts()
    t0 = time.perf_counter()
    wav = in_process(gen_wavernn.main, [
        "--file", str(mel_path), "--voc_weights", str(GOLDEN), "--hp_file",
        str(REPO / "hparams.py"), "--output_dir", str(out_dir), "--device",
        str(dev), "--int8"], REPO)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches += gates_run("gen_wavernn --int8")
    x, sr = wavio.read_wav_raw(wav)
    n_want = (long_mel.shape[1] - 1) * cfg.hop_length
    print(f"gen_wavernn --int8 --file ({long_mel.shape[1]} frames): "
          f"{wav.name}, {x.shape[0]} samples at {sr} Hz in {secs:.2f} s, "
          f"int8_gates launches {cuda_decode.decode.launches_int8_gates} | "
          f"{card}", flush=True)
    if x.shape != (n_want,) or not np.std(x) > 0.01:
        fail(f"gen_wavernn --int8 wrote {x.shape} samples, want {n_want}")

    work, text = tts_train["work"], tts_train["text"]
    torch.cuda.synchronize()
    cuda_tts.tts_decode.launches = 0
    zero_decode_counts()
    t0 = time.perf_counter()
    (wav,) = in_process(gen_tacotron.main, [
        "--input_text", text, "--hp_file", str(tts_train["hp_file"]),
        "--output_dir", str(work / "gen_tts_int8"), "--device", str(dev),
        "--int8", "wavernn"], work)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_tts = cuda_tts.tts_decode.launches
    launches += gates_run("gen_tacotron --int8")
    x, sr = wavio.read_wav_raw(wav)
    print(f"gen_tacotron --int8 wavernn from the step-6 checkpoint: "
          f"{wav.name}, {x.shape[0]} samples at {sr} Hz in {secs:.2f} s; "
          f"launches: tts {n_tts}, int8_gates "
          f"{cuda_decode.decode.launches_int8_gates} | {card}", flush=True)
    if n_tts == 0 or x.size == 0:
        fail("gen_tacotron --int8 did not run through both kernels")

    meta = json.loads((TACO_DIR / "tiny_tacotron_meta.json").read_text())
    hp_int8 = SMOKE_DIR / "hp_tts_int8.py"
    hp_int8.write_text(tts_hp_file(meta).read_text() + "gen_int8 = True\n")
    from wavernn_tpu_torch.config import hp

    hp.reset()
    service, httpd = serve.setup(serve.parse_args([
        "--hp_file", str(hp_int8), "--tts_weights",
        str(TACO_DIR / "tiny_tacotron.msgpack"), "--voc_weights",
        str(GOLDEN), "--port", "0", "--no_warmup", "--deterministic",
        "--slot_seconds", "10", "--device", str(dev)]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        voc = service.server.pipeline.voc
        if not voc.int8_gates:
            fail("the daemon from an hp file with gen_int8 = True built no "
                 "int8_gates vocoder")
        torch.cuda.synchronize()
        zero_decode_counts()
        body, _, secs = post(httpd.server_address[1], "/synthesize",
                             meta["eval_text"])
        torch.cuda.synchronize()
        launches += gates_run("the daemon's /synthesize")
        pcm = pcm_of(body, cfg.sample_rate)
        print(f"daemon (hp file with gen_int8 = True): /synthesize "
              f"{len(pcm)} samples in {secs:.3f} s, int8_gates launches "
              f"{cuda_decode.decode.launches_int8_gates} | {card}",
              flush=True)
        if len(pcm) == 0 or len(pcm) % cfg.hop_length:
            fail(f"the daemon's /synthesize gave {len(pcm)} samples")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        hp.reset()
    hp.configure(REPO / "hparams.py")       # configured through phase 42

    print(f"phase 41 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()

    # -- 42. int8_lstm -----------------------------------------------------
    full = TacotronConfig()
    seq60 = [int(i) for i in np.random.default_rng(0).integers(
        1, full.num_chars, 60)]
    packed, enc, encp = tts_kernel_inputs(dev, full, init_variables(full, 0),
                                          seq60, 64, 2, int8_lstm=True)
    lstm_err = tts_compare(dev, "int8_lstm, full width, r=2", packed, enc,
                           encp, 750, exact=True)

    def timed(fn):
        return tts_timed(dev, fn, packed, enc, encp, 750)

    kernel = lambda *a: cuda_tts.tts_decode(*a, int8_lstm=True)
    timed(kernel)  # warm
    times = {kernel: [], tts_decode_reference: []}
    for fn in (tts_decode_reference, kernel, kernel, tts_decode_reference):
        times[fn].append(timed(fn))
    l_ms = float(np.mean(times[kernel]))
    lp_ms = float(np.mean(times[tts_decode_reference]))
    L, D = enc.shape[0], packed["W_q"].shape[0]
    macs_i8 = sum(packed[k].numel() for k in LSTM_MATRICES)
    macs = (sum(packed[k].numel() for k in MATRICES
                if k not in ("M_loc", "v")) - macs_i8
            + L * (packed["M_loc"].numel() + 2 * D))
    l_bound = bound([(2 * macs * 750, PEAK_BF16),
                     (2 * macs_i8 * 750, PEAK_INT8)],
                    nbytes(*packed.values(), enc, encp)
                    + 750 * (2 * full.n_mels + L + 1) * 4)
    plan = cuda_tts.tts_smem_plan(D, D // 2, full.lstm_dims, full.n_mels, 2,
                                  L, torch.cuda.get_device_properties(
                                      dev).multi_processor_count,
                                  int8_lstm=True)
    print(f"int8_lstm tts decode time at L {L}, r=2, 750 steps: kernel "
          f"{[round(x, 3) for x in times[kernel]]} ms ({l_ms * 1e3 / 750:.2f}"
          f" us/step), plain {[round(x, 1) for x in times[tts_decode_reference]]}"
          f" ms ({lp_ms * 1e3 / 750:.2f} us/step); bound {l_bound[0]:.4f} ms "
          f"({l_bound[1]}); {plan['bytes']} bytes of shared memory per CTA "
          f"on {plan['grid']} CTAs | {card}", flush=True)
    del packed, enc, encp

    # where int8_lstm's step goes, beside phase 6's bf16 spans
    spans = tts_phase_spans.phase_spans(
        *tts_phase_spans.kernel_inputs(64, dev, int8_lstm=True), 750)
    if spans["max_abs_err"] != 0.0:
        fail("the int8_lstm spans launch disagrees with the plain version")
    for name, rec in (("bf16 (phase 6)", bf16_spans),
                      ("int8_lstm", spans)):
        ph, step_us = rec["phase_us"], rec["us_per_step"]
        lstm = ph["lstm1"] + ph["lstm2"]
        first = ph["prenet1"] + ph["prenet2"] + ph["attn_gru"]
        print(f"tts spans [{name}], L 64, 750 steps: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ph.items())
            + f" us; {step_us:.2f} us/step; the LSTM phases {lstm:.2f} us "
            f"({lstm / step_us:.3f} of the step), phases 1-3 {first:.2f} "
            f"us | {card}", flush=True)

    # the trained step-6 Tacotron: each kernel variant's mel against the
    # float32 plain decoder
    blob = load_pytree(tts_train["tts_weights"])
    trained = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    tcfg = tts_train["cfg"]
    seq = text_to_sequence(text, ["english_cleaners"])
    mels, tts_launches = {}, 0
    for name, kw_t in (("float32 plain", dict(backend="plain")),
                       ("bf16 kernel", dict(backend="kernel")),
                       ("int8_lstm kernel", dict(backend="kernel",
                                                 int8_lstm=True))):
        cuda_tts.tts_decode.launches_int8_lstm = 0
        mels[name] = TTSGenerator(tcfg, trained, dev, steps=800, **kw_t)(
            seq, r=2)[0]
        tts_launches += cuda_tts.tts_decode.launches_int8_lstm
    ref = mels["float32 plain"]
    deltas = {}
    for name in ("bf16 kernel", "int8_lstm kernel"):
        n = min(ref.shape[1], mels[name].shape[1])
        d = np.abs(mels[name][:, :n] - ref[:, :n])
        deltas[name] = (float(d.mean()), float(d.max()))
    print(f"trained step-6 Tacotron, {len(seq)} symbols, r=2: frames "
          + ", ".join(f"{k} {m.shape[1]}" for k, m in mels.items())
          + "; mel |d| to the float32 plain decoder (mean / max): "
          + ", ".join(f"{k} {a:.5f} / {b:.5f}" for k, (a, b) in
                      deltas.items()) + f" | {card}", flush=True)
    if tts_launches == 0:
        fail("TTSGenerator(int8_lstm=True) did not launch the int8_lstm "
             "kernel")

    # one text -> wav through both int8 variants
    blob = load_pytree(TACO_DIR / "tiny_tacotron.msgpack")
    taco = {"params": blob["params"], "batch_stats": blob["batch_stats"]}
    tts = TTSGenerator(TacotronConfig(**meta["dims"]), taco, dev, steps=400,
                       backend="kernel", int8_lstm=True)
    voc = Generator(cfg, golden, device=dev, fold_bucket=16,
                    input_dtype="float16", output_dtype="int16",
                    int8_gates=True)
    torch.cuda.synchronize()
    cuda_tts.tts_decode.launches_int8_lstm = 0
    zero_decode_counts()
    t0 = time.perf_counter()
    _, lin, _ = tts(text_to_sequence(meta["eval_text"], ["english_cleaners"]),
                    r=meta["r"])
    wav = voc(mel_from_linear(lin), batched=True, **geom)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_lstm = cuda_tts.tts_decode.launches_int8_lstm
    tts_launches += n_lstm
    launches += gates_run("text -> wav through both int8 variants")
    print(f"text -> wav through int8_lstm and int8_gates: {lin.shape[1]} "
          f"frames -> {len(wav)} int16 samples in {secs:.3f} s; launches: "
          f"int8_lstm {n_lstm}, int8_gates "
          f"{cuda_decode.decode.launches_int8_gates} | {card}", flush=True)
    if n_lstm == 0 or wav.dtype != np.int16 or len(wav) != (
            lin.shape[1] - 1) * cfg.hop_length:
        fail("text -> wav did not run through both int8 variants")
    print(f"phase 42 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    hp.reset()
    return {
        "int8_gates": {"launches": launches, "max_abs_err": max(errs),
                       "ms": g_ms, "plain_ms": gp_ms,
                       "plain_shape": "16 x 1024",
                       "bound_ms": g_bound[0], "bound_by": g_bound[1]},
        "int8_lstm": {"launches": tts_launches, "max_abs_err": lstm_err,
                      "ms": l_ms, "plain_ms": lp_ms, "bound_ms": l_bound[0],
                      "bound_by": l_bound[1]},
    }


def quality_tool_phases(dev, card, mcd_of: dict, tts_ms_step: float) -> dict:
    """Phases 43-47: the quality and golden tools in process at cut sizes,
    each one's JSON checked finite, its kernels' launches read and the
    files it wrote loaded.  Returns the TTS kernel's launches (bf16 and
    int8_lstm) and the decode kernel's, which also go to
    ``MAIN_DECODE``."""
    import tempfile

    import torch

    from wavernn_tpu_torch.ops import cuda_tts
    from wavernn_tpu_torch.tools import (
        check_mel_parity, kernel_quality, non_finite, train_golden,
        tts_kernel_parity, tts_train_probe,
    )
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    def run(phase: int, tool, argv) -> dict:
        t0 = time.perf_counter()
        rec = tool.main(argv)
        bad = non_finite(rec)
        print(f"phase {phase}: {tool.__name__.rsplit('.', 1)[1]} "
              f"{' '.join(argv)} in {time.perf_counter() - t0:.1f} s | "
              f"{card}", flush=True)
        if bad:
            fail(f"phase {phase}: non-finite numbers at {bad}")
        return rec

    # -- 43. check_mel_parity ----------------------------------------------
    rec = run(43, check_mel_parity, [])
    if not rec["ok"] or rec["worst_numpy_vs_torch_mcd"] >= 0.1:
        fail(f"mel pipelines diverge: {rec}")

    hp_short = SMOKE_DIR / "hp_short_folds.py"
    hp_short.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"{k} = {v!r}\n" for k, v in SHORT_FOLDS.items()))

    # -- 44. kernel_quality on the golden MOL -------------------------------
    torch.cuda.synchronize(dev)
    zero_decode_counts()
    rec = run(44, kernel_quality, [
        "--weights", str(GOLDEN), "--eval_mel",
        str(REPO / "bench_assets" / "golden_eval_mel.npy"), "--seeds", "3",
        "--hp_file", str(hp_short)])
    n = count_main_decode()
    decode_launches = n
    got = rec["kernel_launches"]
    n_bf = got["launches"] - got["launches_int8_ff"] - got[
        "launches_int8_gates"]
    if min(n_bf, got["launches_int8_ff"], got["launches_int8_gates"]) < 4 \
            or n != got["launches"]:
        fail(f"kernel_quality's decode launches: {got} ({n} counted)")
    std = rec["det_signal_std"]
    print(f"  decode quality on the golden eval mel ({rec['eval_frames']} "
          f"frames, folds {SHORT_FOLDS}): deterministic mean |sample diff| "
          f"to the float32 scan (signal std {std:.5f}): " + ", ".join(
              f"{k} {rec[f'det_absdiff_{k}']:.6f}"
              for k in kernel_quality.KERNEL_VARIANTS) + f" | {card}")
    print(f"  MCD means over seeds 0-2 (float32 in): "
          + ", ".join(f"{k} {rec[f'mcd_{k}_mean']:.4f}"
                      for k in kernel_quality.VARIANTS)
          + "; at target 11,000 / overlap 550, float16 in: " + ", ".join(
              f"{k} {m:.4f}" for k, m in mcd_of.items())
          + " (phases 15, 30; gate 892.40)", flush=True)
    for k in kernel_quality.KERNEL_VARIANTS:
        if not 0 < rec[f"det_absdiff_{k}"] < std:
            fail(f"kernel_quality's {k} |sample diff| is out of range")

    # -- 45. tts_kernel_parity --int8 --train 50 ----------------------------
    torch.cuda.synchronize(dev)
    cuda_tts.tts_decode.launches = 0
    cuda_tts.tts_decode.launches_int8_lstm = 0
    rec = run(45, tts_kernel_parity, ["--int8", "--train", "50"])
    n_lstm = cuda_tts.tts_decode.launches_int8_lstm
    n_tts = cuda_tts.tts_decode.launches - n_lstm
    print(f"  frames plain {rec['frames_plain']}, kernel "
          f"{rec['frames_kernel']}, int8_lstm {rec['frames_kernel_int8']}; "
          f"mel |d| mean / max {rec['mel_mean_abs_diff']:.5f} / "
          f"{rec['mel_max_abs_diff']:.5f} (int8_lstm "
          f"{rec['mel_mean_abs_diff_int8']:.5f} / "
          f"{rec['mel_max_abs_diff_int8']:.5f}); frames/s plain "
          f"{rec['frames_per_s_plain']:.1f}, kernel "
          f"{rec['frames_per_s_kernel']:.1f}, int8_lstm "
          f"{rec['frames_per_s_kernel_int8']:.1f}; loss after 50 steps "
          f"{rec['final_train_loss']:.4f}; TTS launches {n_tts} + "
          f"{n_lstm} int8_lstm", flush=True)
    if min(n_tts, n_lstm, rec["kernel_launches"],
           rec["kernel_launches_int8"]) == 0:
        fail("tts_kernel_parity did not run both TTS kernel variants")

    # -- 46. tts_train_probe at 16 100 600 ----------------------------------
    rec = run(46, tts_train_probe, ["16", "100", "600", "--passes", "1",
                                    "--calls", "2"])
    full = rec["full_step"]["ms"]
    print(f"  full step {full:.2f} ms = {full / tts_ms_step:.3f} x phase "
          f"33's {tts_ms_step:.2f}; kernels a step "
          f"{rec['full_step']['kernels']}; dropout/zoneout share "
          f"{rec['shares']['dropout_zoneout']['ms']:.2f} ms (train forward "
          f"{rec['forward_train']['ms']:.2f}, without dropout and zoneout "
          f"{rec['forward_train_nodrop']['ms']:.2f})", flush=True)

    # -- 47. train_golden full (20 steps) and taco-pin ----------------------
    with tempfile.TemporaryDirectory(dir=SMOKE_DIR) as tmp:
        out = Path(tmp)
        torch.cuda.synchronize(dev)
        zero_decode_counts()
        rec = run(47, train_golden, ["--which", "full", "--steps", "20",
                                     "--hp_file", str(hp_short),
                                     "--out", str(out)])
        n = count_main_decode()
        decode_launches += n
        blob = load_pytree(out / "wavernn_mol_golden.msgpack")
        mel = np.load(out / "golden_eval_mel.npy")
        meta = json.loads((out / "golden_meta.json").read_text())
        print(f"  loss after 20 steps {rec['final_loss']:.4f}; MCD at "
              f"{SHORT_FOLDS}: scan "
              f"{meta['mcd_scan_mean']:.4f} (spread "
              f"{meta['mcd_scan_spread']:.4f}), kernel "
              f"{meta['mcd_kernel_mean']:.4f}; decode launches {n}; "
              f"{len(blob['params'])} parameter groups, step "
              f"{int(blob['step'])}, eval mel {mel.shape}", flush=True)
        if n < 3 or mel.shape != (80, 1200) or int(blob["step"]) != 20:
            fail("train_golden --which full wrote unexpected files")
        rec = run(47, train_golden, ["--which", "taco-pin", "--from",
                                     str(TACO_DIR), "--out", str(out)])
        want = json.loads((TACO_DIR / "tiny_tacotron_meta.json").read_text(
        ))["pinned_gates_cpu_xla"]
        d = float(np.abs(np.load(out / "tiny_tacotron_mel.npy") - np.load(
            TACO_DIR / "tiny_tacotron_mel.npy")).max())
        print(f"  taco-pin mel max |d| to the committed pin {d:.3g}",
              flush=True)
        if d > 1e-3 or abs(rec["mel_gt_l1"] - want["mel_gt_l1"]) > 1e-3 \
                or any(rec[k] != v for k, v in want.items()
                       if k != "mel_gt_l1"):
            fail("train_golden --which taco-pin disagrees with the pins")
    return {"tts_launches": n_tts, "int8_lstm_launches": n_lstm,
            "decode_launches": decode_launches}


# phases 48-53: the examples, cut as the module docstring says
EXAMPLE_STEPS = 20           # phases 49-51's training steps
E2E_TEXTS, E2E_TTS_STEPS, E2E_VOC_STEPS = 64, 30, 20     # phase 53


def example_phases(dev, card) -> dict:
    """Phases 48-53.  Returns the decode kernel's launches (also added to
    the main path's tally) and the TTS kernel's."""
    import shutil

    import torch

    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.examples import (
        e2e_tts, nb2_fit_single_sample, nb3_fit_long_sample,
        nb4_alternative_model, pruning_example, serving_demo,
    )
    from wavernn_tpu_torch.models.wavernn import WaveRNN
    from wavernn_tpu_torch.ops import cuda_tts
    from wavernn_tpu_torch.pruning import Pruner, measured_sparsity

    work = SMOKE_DIR / "examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = {"decode": 0, "tts": 0}

    def phase(n, what, fn, kernels=()):
        """Run ``fn`` in process with both counters set to 0 just before,
        the hp singleton cleared around it; ``kernels`` must have risen.
        Returns fn's result."""
        torch.cuda.synchronize()
        zero_decode_counts()
        cuda_tts.tts_decode.launches = 0
        t0 = time.perf_counter()
        out = in_process(fn, None, work)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_dec = count_main_decode()
        n_tts = cuda_tts.tts_decode.launches
        launches["decode"] += n_dec
        launches["tts"] += n_tts
        print(f"phase {n} ({what}) in {secs:.1f} s: decode launches "
              f"{n_dec}, Tacotron kernel launches {n_tts} | {card}",
              flush=True)
        for k, got in (("decode", n_dec), ("tts", n_tts)):
            if k in kernels and got == 0:
                fail(f"phase {n} ({what}) launched no {k} kernel")
        return out

    def pcm_check(n, path, want_len):
        x, sr = wavio.read_wav_raw(path)
        ok = (sr == 22050 and x.shape == (want_len,)
              and np.isfinite(x).all() and float(np.std(x)) > 0)
        print(f"phase {n}: {path.name}: {x.shape[0]} samples at {sr} Hz "
              f"(want {want_len}), std {float(np.std(x)):.4f}", flush=True)
        if not ok:
            fail(f"phase {n}: {path} is not {want_len} samples of audio")

    # -- 48. pruning_example, uncut ----------------------------------------
    res = phase(48, "pruning_example, 300 steps",
                lambda _: pruning_example.main(["--device", str(dev)]))
    cfg = pruning_example.tiny_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        fresh = WaveRNN(cfg)
    pruner = Pruner(pruning_example.PRUNE)
    want = [(s, measured_sparsity(pruner.compute(fresh, s)))
            for s in range(25, 301, 25)]
    print(f"phase 48: sparsity every 25 steps {res['sparsity']}; losses "
          f"{res['losses'][[0, 99, 199, 299]]}", flush=True)
    if res["sparsity"] != want or want[1][1] != 0.0:
        fail(f"phase 48: sparsity {res['sparsity']}, the schedule's {want}")
    if not np.isfinite(res["losses"]).all():
        fail("phase 48: a loss is not finite")

    # -- 49. nb2, 20 steps at full width -----------------------------------
    nb3_fit_long_sample.synth_corpus(work / "nb2", 22050, 3.0, 1)
    wav = work / "nb2" / "long_000.wav"
    res = phase(49, f"nb2_fit_single_sample, {EXAMPLE_STEPS} steps",
                lambda _: nb2_fit_single_sample.main([
                    "--wav", str(wav), "--steps", str(EXAMPLE_STEPS),
                    "--device", str(dev)]), ("decode",))
    frames = min(241, nb2_fit_single_sample.GEN_FRAMES)   # 3 s: 241 hops
    print(f"phase 49: losses {res['losses'][::5]} (nb2 holds no loss check)",
          flush=True)
    pcm_check(49, res["path"], (frames - 1) * 275)
    if not np.isfinite(res["losses"]).all():
        fail("phase 49: a loss is not finite")

    # -- 50. nb3 at full size, cut ------------------------------------------
    res = phase(50, f"nb3_fit_long_sample --full_size, {EXAMPLE_STEPS} steps",
                lambda _: nb3_fit_long_sample.main([
                    "--full_size", "--minutes", "0.25", "--steps",
                    str(EXAMPLE_STEPS), "--num_workers", "1", "--workspace",
                    str(work / "nb3"), "--device", str(dev)]), ("decode",))
    print(f"phase 50: loss {res['loss0']:.4f} -> {res['loss1']:.4f}; the "
          f"loss-drop check (>= 0.5) skipped: it is set for 300 steps",
          flush=True)
    paths = res["paths"]
    gen = [p for p in res["auditions"] if "_gen_" in p.name]
    target = [p for p in res["auditions"] if p.name.endswith("_target.wav")]
    if res["loss_gate"] or len(gen) != 1 or len(target) != 1:
        fail(f"phase 50: auditions {res['auditions']}")
    # the audition is (mel frames - 1) x hop samples: its utterance's
    # length rounded down to whole hops
    n_target = wavio.read_wav_raw(target[0])[0].shape[0]
    pcm_check(50, gen[0], n_target // 275 * 275)
    if not (paths.voc_latest_weights.exists()
            and len(list(paths.mel.glob("*.npy"))) == 12):
        fail("phase 50: no latest weights or not 12 preprocessed mels")

    # -- 51. nb4 at full size, cut ------------------------------------------
    res = phase(51, f"nb4_alternative_model --full_size, {EXAMPLE_STEPS} "
                "steps", lambda _: nb4_alternative_model.main([
                    "--full_size", "--steps", str(EXAMPLE_STEPS),
                    "--num_workers", "1", "--workspace", str(work / "nb4"),
                    "--device", str(dev)]), ("decode",))
    print(f"phase 51: MOL loss {res['loss0']:.4f} -> {res['loss1']:.4f}; "
          f"the loss-drop check (>= 0.3) skipped: it is set for 150 steps; "
          f"{len(res['wav'])} samples", flush=True)
    if (len(res["dataset"]) != 8 or res["loss_gate"]
            or not np.isfinite(res["wav"]).all()
            or len(res["wav"]) != (2 * 22050 // 275) * 275
            or not res["path"].exists()):
        fail("phase 51: part A or B did not hold")

    # -- 52. serving_demo ---------------------------------------------------
    res = phase(52, "serving_demo", lambda _: serving_demo.main(
        ["--device", str(dev)]), ("decode", "tts"))
    lens = [len(w) for w in res["batched"]]
    print(f"phase 52: mels {[m.shape for m in res['mels']]}, waveforms "
          f"{lens}, server launches {res['launches']}, health "
          f"{res['health']}", flush=True)
    if (lens != [len(w) for w in res["manual"]]
            or any(len(w) != (m.shape[1] - 1) * 275
                   for w, m in zip(res["served"], res["mels"]))):
        fail("phase 52: the sections' waveforms differ in length")

    # -- 53. e2e_tts, cut -----------------------------------------------------
    ws = work / "e2e"

    def e2e(_):
        with contextlib.redirect_stdout(sys.stderr):   # the CLIs' tables
            e2e_tts.run_pipeline(ws, E2E_VOC_STEPS, E2E_TTS_STEPS, str(dev),
                                 e2e_tts.TRAIN_TEXTS[:E2E_TEXTS],
                                 num_workers=1)
        return e2e_tts.measure_gates(ws)

    gates = phase(53, f"e2e_tts, {E2E_TEXTS} texts, {E2E_TTS_STEPS} "
                  f"Tacotron and {E2E_VOC_STEPS} vocoder steps", e2e,
                  ("decode", "tts"))
    print(f"phase 53: gates {json.dumps(gates)}; not held (0.85 / 0.7 / 0.4 "
          f"/ 0.6): they are set for 6,000 Tacotron and 3,000 vocoder steps "
          f"on 1,200 texts", flush=True)
    nums = [u[k] for u in gates["utterances"] for k in (
        "attn_monotone", "attn_coverage", "attn_sharpness",
        "spectral_match", "audio_s")]
    if len(gates["utterances"]) != 3 or not np.isfinite(nums).all() or min(
            u["audio_s"] for u in gates["utterances"]) <= 0:
        fail("phase 53: the gates are not three utterances' finite numbers")
    return launches


# phase 54: the trainer's JAX options, sequence-chunked BPTT (k = 5
# chunks of 275 + 128 samples of each 1,375-sample window) and bf16 GRU
# matmuls; the CLI run's steps, then each timed arm's warm-up and timed
# steps (the bf16 arms run their recurrences step by step from Python)
OPTION_CHUNKS, OPTION_WARMUP, OPTION_CLI_STEPS = 5, 128, 3
OPTION_WARM, OPTION_TIMED = 2, 4


def train_option_phases(dev, card, f32_ms: float) -> dict:
    """Phase 54: ``train_wavernn`` with ``voc_seq_chunks``,
    ``voc_chunk_warmup`` and ``voc_compute_dtype`` at full width on phase
    25's corpus, the four arms' ms/step beside phase 26's float32 figure
    (``f32_ms``), and each option held against a known result.  Returns
    the decode kernel's launches (also added to the main path's tally)."""
    import dataclasses
    import re
    import shutil

    import torch

    from wavernn_tpu_torch import gen_wavernn, train_wavernn
    from wavernn_tpu_torch.config import hp
    from wavernn_tpu_torch.data.dataset import get_vocoder_datasets
    from wavernn_tpu_torch.dsp import wavio
    from wavernn_tpu_torch.models.wavernn import (
        GRUCell, WaveRNN, WaveRNNConfig, gru_sequence_low, load_jax_variables,
    )
    from wavernn_tpu_torch.ops.rnn import low_product, low_product_reference
    from wavernn_tpu_torch.paths import Paths
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )
    from wavernn_tpu_torch.training.wavernn import batch_to, make_train_step
    from wavernn_tpu_torch.utils.checkpoints import load_pytree

    t_phase = time.perf_counter()
    work = SMOKE_DIR / "train_options"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    data = SMOKE_DIR / "train" / "data"          # phase 25's corpus
    overrides = dict(data_path=str(data), voc_total_steps=OPTION_CLI_STEPS,
                     voc_checkpoint_every=OPTION_CLI_STEPS,
                     voc_gen_at_checkpoint=1, voc_test_samples=2,
                     voc_seq_chunks=OPTION_CHUNKS,
                     voc_chunk_warmup=OPTION_WARMUP,
                     voc_compute_dtype="bfloat16")
    hp_file = work / "hp_options.py"
    hp_file.write_text(
        "import runpy\n"
        f"globals().update({{k: v for k, v in runpy.run_path("
        f"{str(REPO / 'hparams.py')!r}).items() if not k.startswith('__')}})\n"
        + "".join(f"{k} = {v!r}\n" for k, v in overrides.items()))

    # -- (a) the CLI from a fresh checkpoint, one audition ----------------
    torch.cuda.synchronize()
    zero_decode_counts()
    out, secs = cli_output(train_wavernn.main, [
        "--hp_file", str(hp_file), "--device", str(dev)], work)
    launches = count_main_decode()
    losses = [float(x) for x in re.findall(r"Loss: (\S+) \|", out)]
    hp.reset()
    hp.configure(hp_file)
    cfg = WaveRNNConfig.from_hp(hp)
    B, T = hp.voc_batch_size, hp.voc_seq_len
    paths = Paths(hp.data_path, hp.voc_model_id, hp.tts_model_id, base=work)
    blob = load_pytree(paths.voc_latest_weights)
    print(f"phase 54 (a): train_wavernn with voc_seq_chunks "
          f"{cfg.seq_chunks}, voc_chunk_warmup {cfg.chunk_warmup}, "
          f"voc_compute_dtype {cfg.compute_dtype!r} (chunked at {T}: "
          f"{cfg.chunks(T)}), {OPTION_CLI_STEPS} steps of {B} x {T} in "
          f"{secs:.1f} s: losses {losses}, decode launches {launches}, "
          f"written step {int(blob['step'])} | {card}", flush=True)
    if not (cfg.chunks(T) and cfg.compute_dtype == "bfloat16"):
        fail("phase 54: the hp file's options did not reach the config")
    if not losses or not np.isfinite(losses).all():
        fail("phase 54: a loss of the options' run is not finite")
    if launches != 1:
        fail(f"phase 54: the audition launched the decode kernel {launches} "
             "times, want 1")
    if int(blob["step"]) != OPTION_CLI_STEPS:
        fail(f"phase 54: written step {blob['step']}")
    model = WaveRNN(cfg)
    load_jax_variables(model, blob)
    train_set, test_set = get_vocoder_datasets(paths.data, B, False)
    mel = paths.mel / f"{test_set.dataset.metadata[0]}.npy"
    zero_decode_counts()
    cli_output(gen_wavernn.main, [
        "--hp_file", str(hp_file), "--file", str(mel), "--output_dir",
        str(work / "gen"), "--device", str(dev)], work)
    gen_launches = count_main_decode()
    wavs = sorted((work / "gen").glob("*.wav"))
    if len(wavs) != 1 or gen_launches < 1:
        fail(f"phase 54: gen_wavernn wrote {wavs}, {gen_launches} launches")
    pcm, sr = wavio.read_wav_raw(wavs[0])
    print(f"phase 54 (a): the written weights load; gen_wavernn on them: "
          f"{wavs[0].name}, {pcm.shape[0]} samples at {sr} Hz, finite "
          f"{bool(np.isfinite(pcm).all())}", flush=True)
    if sr != hp.sample_rate or not np.isfinite(pcm).all() or not len(pcm):
        fail("phase 54: gen_wavernn's WAV on the options' weights")

    # -- (b) the four arms on one fixed batch ------------------------------
    np.random.seed(2)
    train_set.num_workers = 0
    batch = batch_to(dev, *next(iter(train_set)))
    plain_cfg = dataclasses.replace(cfg, seq_chunks=1, compute_dtype=None)
    arms = {"float32": plain_cfg,
            f"chunked k={cfg.seq_chunks}": dataclasses.replace(
                plain_cfg, seq_chunks=cfg.seq_chunks),
            "bf16": dataclasses.replace(plain_cfg,
                                        compute_dtype=cfg.compute_dtype),
            f"chunked k={cfg.seq_chunks} + bf16": cfg}
    arm_ms = {}
    for name, acfg in arms.items():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            m = WaveRNN(acfg).to(dev)
        opt = make_optimizer(hp.voc_lr, hp.voc_clip_grad_norm)
        state = new_train_state(m, opt)
        step = make_train_step(opt, acfg.mode)
        events, arm_losses = [], []
        for i in range(OPTION_WARM + OPTION_TIMED):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            _, loss, _ = step(state, *batch)
            b.record()
            events.append((a, b))
            arm_losses.append(loss)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in events[OPTION_WARM:]]
        arm_losses = [float(x) for x in arm_losses]
        arm_ms[name] = float(np.median(ms))
        print(f"voc_train_ms_per_step [{name}] ({acfg.mode}, B={B} x {T}, "
              f"TF32 off): median {arm_ms[name]:.2f} ms over {OPTION_TIMED} "
              f"steps (min {min(ms):.2f}, max {max(ms):.2f}) beside phase "
              f"26's float32 {f32_ms:.2f} ms; loss {arm_losses[0]:.6f} -> "
              f"{arm_losses[-1]:.6f} | {card}", flush=True)
        if not (np.isfinite(arm_losses).all()
                and arm_losses[-1] < arm_losses[0]):
            fail(f"phase 54: the [{name}] arm does not learn")
        del state, m

    # -- (c) each option against a known result ----------------------------
    # chunking: with w_hh zeroed and the update gate killed (h_t = n_t) the
    # GRUs have no memory, so the chunked forward equals the unchunked one
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        base = WaveRNN(plain_cfg)
    H = plain_cfg.rnn_dims
    with torch.no_grad():
        for cell in (base.rnn1, base.rnn2):
            cell.weight_hh.zero_()
            cell.bias_hh[H:2 * H] = -60.0
            cell.bias_ih[H:2 * H] = -60.0
    outs = []
    for acfg in (arms[f"chunked k={cfg.seq_chunks}"], plain_cfg):
        m = WaveRNN(acfg)
        m.load_state_dict(base.state_dict())
        with torch.no_grad():
            outs.append(m.to(dev).train()(batch[0][:4], batch[2][:4]))
    d_chunk = float((outs[0] - outs[1]).abs().max())
    print(f"phase 54 (c): memoryless GRUs, chunked (k={cfg.seq_chunks}, "
          f"warmup {cfg.chunk_warmup}) against unchunked forward, B=4 x "
          f"{T}: max|d| {d_chunk:.3g} (tolerance 1e-5)", flush=True)
    if not d_chunk <= 1e-5:
        fail("phase 54: the chunked forward differs from the unchunked one")
    # bf16: the GRU sequence on the card's product against its plain
    # version (the float32 matmul of the rounded operands), at the shape
    # rnn2 sees with both options: B*k rows of warmup + T/k steps
    rows, steps = B * cfg.seq_chunks, cfg.chunk_warmup + T // cfg.seq_chunks
    gen = torch.Generator().manual_seed(0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cell = GRUCell(H + cfg.aux_dims, H).to(dev)
    x = torch.randn(rows, steps, H + cfg.aux_dims, generator=gen).to(dev)
    cot = torch.randn(rows, steps, H, generator=gen).to(dev)
    res, secs = [], []
    for product in (low_product, low_product_reference):
        cell.zero_grad()
        xg = x.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys = gru_sequence_low(cell, xg, cfg.compute_dtype, product)
        (ys * cot).sum().backward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        res.append([ys.detach(), xg.grad] + [p.grad.clone()
                                             for p in cell.parameters()])
    rel = lambda u, v: float((u - v).norm() / v.norm())
    d_out = rel(res[0][0], res[1][0])
    d_grad = max(rel(u, v) for u, v in zip(res[0][1:], res[1][1:]))
    print(f"phase 54 (c): bf16 GRU sequence ({rows} x {steps}, {H} wide), "
          f"the card's product (torch.mm bf16 -> float32) against its plain "
          f"version: outputs rel L2 {d_out:.3g} (tolerance 1e-3), worst "
          f"gradient rel L2 {d_grad:.3g} (tolerance 5e-3; a state "
          f"element's bf16 rounding may flip where the float32 sums "
          f"differ in order); forward + backward {secs[0]:.2f} s / "
          f"{secs[1]:.2f} s | {card}", flush=True)
    if not (d_out <= 1e-3 and d_grad <= 5e-3):
        fail("phase 54: the bf16 GRU sequence on the card's product "
             "disagrees with its plain version")
    hp.reset()
    print(f"phase 54: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"decode_launches": launches + gen_launches, "ms": arm_ms}


if __name__ == "__main__":
    main()
