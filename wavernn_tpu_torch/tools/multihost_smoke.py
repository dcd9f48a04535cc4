"""Data-parallel training across processes, run and held against one
process (ports ``tools/multihost_smoke.py``).

    python -m wavernn_tpu_torch.tools.multihost_smoke [--device cpu|cuda]
        [--backend gloo|nccl] [--processes 2] [--model 1]
        [--size tiny|full]

The launcher spawns ``--processes`` workers with torchrun's environment
contract (``MASTER_ADDR=localhost``, a free ``MASTER_PORT``, ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``).  Each worker joins the process group
through ``parallel.distributed.maybe_initialize_distributed``, the
library's own path, checks that an all-reduce of ones gives the world
size, and runs one data-parallel train step of each model (the vocoder
and Tacotron) on its rows of a seeded global batch
(``shard_batch_fn`` and the train step with its world plan).  It also runs
the single-process step on the whole global batch, on the same device
from the same seeded model, in float32 and in float64, and prints one
JSON line: both losses, the largest |d| of the loss, of every updated
parameter and of the BatchNorm running statistics, and each step's ms.
The launcher fails unless every rank reports the same finite loss and the
|d|s are within :data:`TOL` (1e-5), and prints one JSON line.  In float64
every |d| is held, in float32 the loss's and the statistics'.  A world of
one must be bit-equal in both.

``--model k`` lays the ranks out as the mesh ``{"data": processes / k,
"model": k}`` and shards both models' parameters over the model axis
(``parallel.tensor_parallel.shard_params``): the tensor-parallel step is
held against the one-process step as the data-parallel one is, on the
full parameters gathered after the step.  Each rank also checks that
every shard it stores is exactly its slice of the gathered parameter, and
that its ``TrainState.weights_tree`` and ``optim_tree`` have the
one-process trees' leaves and shapes, the optimizer tree reading back
into the sharded state as the moments it holds (``shards_exact``,
``tree_layout_equal``, ``tree_diff``, ``optim_layout_equal``,
``optim_round_trip``).

The float32 parameters are printed, not held: Adam's first update is
``lr * g / (|g| + 1e-8)``, so a parameter whose gradient is ~1e-9, a sum
of far larger terms that cancel, moves by up to ``lr * |dg| / 1e-8`` when
the same terms are summed in another order (per rank, then over the
ranks).  Each float32 record gives that gap beside
``single_param_diff_to_float64``, the single-process float32 step's own
distance from the float64 step: on the tiny Tacotron on the CPU 7.2e-5
against 4.9e-5, while float64 holds the two steps within 1e-13.

``--size tiny`` is the JAX package's tiny RAW vocoder (global batch 8)
and tiny Tacotron (B 8, L 12, T 20, r 2); ``--size full`` is
``hparams.py``'s vocoder (MOL, global batch 8 of ``voc_seq_len``) and
Tacotron (B 4, L 40, T 48, r 2), each with ``hparams.py``'s learning rate
and clip.  Devices: CPU ranks run on gloo; with ``--device cuda`` rank k
takes ``cuda:k`` under NCCL (which refuses two ranks on one card), while
under gloo every rank shares ``cuda:0`` and the plan stages its
collectives through the host.  The workers run with deterministic
algorithms, so that a world of one can be bit-equal to one process.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from wavernn_tpu_torch.tools import REPO

TINY_VOC = dict(rnn_dims=32, fc_dims=32, bits=8, pad=2,
                upsample_factors=(2, 2), feat_dims=8, compute_dims=8,
                res_out_dims=8, res_blocks=1, hop_length=4, sample_rate=1000,
                mode="RAW")
TINY_TTS = dict(embed_dims=16, num_chars=40, encoder_dims=16,
                decoder_dims=32, n_mels=16, fft_bins=16, postnet_dims=16,
                encoder_K=3, lstm_dims=32, postnet_K=3, num_highways=2)
MASK_SEED = 7
TOL = 1e-5          # the largest |d| held against the single-process step


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def vocoder_case(size: str):
    """(make_model(dev), make_step(optimizer, plan), global batch, lr,
    clip) of the vocoder at ``size``."""
    from wavernn_tpu_torch.models.wavernn import WaveRNN, WaveRNNConfig
    from wavernn_tpu_torch.training.wavernn import make_train_step

    if size == "tiny":
        cfg, seq_len, lr, clip = (WaveRNNConfig(**TINY_VOC),
                                  4 * TINY_VOC["hop_length"], 1e-3, 4.0)
    else:
        from wavernn_tpu_torch.config import hp

        hp.configure(REPO / "hparams.py")
        cfg, seq_len = WaveRNNConfig.from_hp(hp), hp.voc_seq_len
        lr, clip = hp.voc_lr, hp.voc_clip_grad_norm
        hp.reset()
    B = 8
    mel_win = seq_len // cfg.hop_length + 2 * cfg.pad
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (B, seq_len)).astype(np.float32)
    y = (rng.integers(0, cfg.n_classes, (B, seq_len)) if cfg.mode == "RAW"
         else rng.uniform(-1, 1, (B, seq_len)).astype(np.float32))
    mels = rng.uniform(0, 1, (B, mel_win, cfg.feat_dims)).astype(np.float32)

    def make_model(dev):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return WaveRNN(cfg).to(dev)

    def make_step(optimizer, plan):
        step = make_train_step(optimizer, cfg.mode, plan)
        return lambda state, x, y, m: step(state, x, y, m)[1]

    return make_model, make_step, (x, y, mels), lr, clip


def tacotron_case(size: str):
    """:func:`vocoder_case` for Tacotron; the masks come from a generator
    seeded with :data:`MASK_SEED` on the model's device."""
    from wavernn_tpu_torch.models.tacotron import (
        TacotronConfig, from_jax_variables, init_variables,
    )
    from wavernn_tpu_torch.training.tacotron import make_tts_train_step

    if size == "tiny":
        cfg, (B, L, T, r), lr, clip = (TacotronConfig(**TINY_TTS),
                                       (8, 12, 20, 2), 1e-3, None)
    else:
        from wavernn_tpu_torch.config import hp
        from wavernn_tpu_torch.text.symbols import symbols

        hp.configure(REPO / "hparams.py")
        cfg = TacotronConfig.from_hp(hp, num_chars=len(symbols))
        lr, clip = hp.tts_schedule[0][1], hp.tts_clip_grad_norm
        hp.reset()
        B, L, T, r = 4, 40, 48, 2
    rng = np.random.default_rng(0)
    x = rng.integers(1, cfg.num_chars, (B, L))
    m = rng.uniform(-4, 4, (B, T, cfg.n_mels)).astype(np.float32)
    variables = init_variables(cfg, 0)

    def make_model(dev):
        return from_jax_variables(variables, cfg, dev)

    def make_step(optimizer, plan):
        holder = {}

        def step(state, x, m):
            model = state.model
            if "step" not in holder:
                holder["step"] = make_tts_train_step(model, optimizer, r,
                                                     plan)
            dev = next(model.parameters()).device
            gen = torch.Generator(device=dev).manual_seed(MASK_SEED)
            return holder["step"](state, x.long(), m, gen)[1]

        return step

    return make_model, make_step, (x, m), lr, clip


CASES = {"vocoder": vocoder_case, "tacotron": tacotron_case}


def run_step(case, dev: torch.device, dtype: torch.dtype, plan=None):
    """One train step from the seeded model in ``dtype``: (loss, {param},
    {running statistic}, ms, state), on the whole global batch without a
    plan, on this rank's rows with one, its parameters sharded over a
    plan's model axis.  The parameters are the full ones, by plain name."""
    from wavernn_tpu_torch.parallel.mesh import shard_batch_fn
    from wavernn_tpu_torch.parallel.tensor_parallel import (
        full_parameters, shard_params,
    )
    from wavernn_tpu_torch.training.state import (
        make_optimizer, new_train_state,
    )

    make_model, make_step, batch, lr, clip = case
    model = make_model(dev).to(dtype)
    if plan is not None:
        shard_params(plan, model)
    optimizer = make_optimizer(lr, clip)
    state = new_train_state(model, optimizer)
    step = make_step(optimizer, plan)
    batch = tuple(a.astype(torch.empty((), dtype=dtype).numpy().dtype)
                  if a.dtype.kind == "f" else a for a in batch)
    if plan is None:
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in batch)
    else:
        batch = shard_batch_fn(plan)(*batch)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    loss = float(step(state, *batch))
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        params = {n: p.detach().cpu() for n, p in
                  full_parameters(model).items()}
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()
             if "running" in n}
    return loss, params, stats, ms, state


def max_diff(a: dict, b: dict) -> float:
    return max(float((a[n].double() - b[n].double()).abs().max()) for n in a)


def tensor_parallel_checks(state, params: dict, single_state) -> dict:
    """Whether every shard a rank stores is exactly its slice of the
    gathered parameter; how the state's weights file compares with the
    one-process state's (the same leaves and shapes, and the largest |d|
    of their values); whether its optimizer file has the one-process
    file's leaves and shapes, and reads back into the sharded state as
    the moments it holds."""
    from wavernn_tpu_torch.parallel.tensor_parallel import (
        plain_name, sharded_parameters,
    )

    shards = sharded_parameters(state.model)
    own = dict(state.model.named_parameters())
    exact = all(torch.equal(own[n].detach().cpu(),
                            g.shard_of(params[plain_name(n)]))
                for n, g in shards.items())
    flat = lambda t, p="": ({k: v for kk, vv in t.items()
                             for k, v in flat(vv, f"{p}/{kk}").items()}
                            if isinstance(t, dict) else {p: np.asarray(t)})
    shapes = lambda t: {k: v.shape for k, v in t.items()}
    tree, ref = flat(state.weights_tree()), flat(single_state.weights_tree())
    layout = shapes(tree) == shapes(ref)
    diff = max(float(np.abs(tree[k].astype(np.float64)
                            - ref[k].astype(np.float64)).max())
               for k in ref) if layout else float("inf")
    optim = state.optim_tree()
    held = state.opt_state
    state.load_optim_tree(optim)
    round_trip = all(torch.equal(held.mu[n].float(), state.opt_state.mu[n])
                     and torch.equal(held.nu[n].float(),
                                     state.opt_state.nu[n])
                     for n in held.mu)
    return {"sharded": len(shards), "shards_exact": bool(exact),
            "tree_layout_equal": bool(layout), "tree_diff": diff,
            "optim_layout_equal": shapes(flat(optim))
            == shapes(flat(single_state.optim_tree())),
            "optim_round_trip": bool(round_trip)}


def worker(args) -> None:
    import torch.distributed as dist

    from wavernn_tpu_torch import set_float32_policy
    from wavernn_tpu_torch.parallel import distributed
    from wavernn_tpu_torch.parallel.mesh import all_reduce_sum, world_mesh

    set_float32_policy()
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if args.device == "cpu":
        torch.set_num_threads(1)
        name = "cpu"
    else:
        name = (f"cuda:{distributed.local_rank()}" if args.backend == "nccl"
                else "cuda:0")
    distributed.maybe_initialize_distributed(args.backend, name)
    if not dist.is_initialized():
        raise RuntimeError("no process group was started")
    dev = distributed.rank_device(name)
    world = dist.get_world_size()
    plan = world_mesh({"data": world // args.model, "model": args.model},
                      device=dev)
    ones = float(all_reduce_sum(torch.ones(1, device=dev), plan))
    out = {"rank": plan.rank, "world": world, "n_data": plan.n_data,
           "n_model": plan.n_model, "data_rank": plan.data_rank,
           "model_rank": plan.model_rank, "device": str(dev),
           "backend": dist.get_backend(), "all_reduce_ones": ones}
    if ones != plan.n_data:
        raise RuntimeError(f"all_reduce(ones) = {ones} over the data group "
                           f"of {plan.n_data}")
    for model, case_of in CASES.items():
        case = case_of(args.size)
        run_step(case, dev, torch.float32)        # warm-up
        single = {}
        for dtype in (torch.float64, torch.float32):
            loss_1, params_1, stats_1, ms_1, state_1 = single[dtype] = \
                run_step(case, dev, dtype)
            loss_w, params_w, stats_w, ms_w, state_w = run_step(
                case, dev, dtype, plan)
            rec = out[f"{model}_{str(dtype)[6:]}"] = {
                "loss": loss_w, "single_loss": loss_1,
                "loss_diff": abs(loss_w - loss_1),
                "param_diff": max_diff(params_w, params_1),
                "stats_diff": max_diff(stats_w, stats_1),
                "ms": ms_w, "single_ms": ms_1,
            }
            if plan.n_model > 1:
                rec.update(tensor_parallel_checks(state_w, params_w,
                                                  state_1))
        # float32 rounding's own reach: the single-process float32 step
        # against the float64 one
        out[f"{model}_float32"]["single_param_diff_to_float64"] = max_diff(
            single[torch.float32][1], single[torch.float64][1])
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def launch(args) -> dict:
    """Run the workers and check what they print; returns the summary."""
    port = free_port()
    base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(args.processes), WAVERNN_TPU_DISTRIBUTED="1",
                CUBLAS_WORKSPACE_CONFIG=":4096:8",
                PYTHONPATH=os.pathsep.join(
                    [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]))
    cmd = [sys.executable, "-m", "wavernn_tpu_torch.tools.multihost_smoke",
           "--worker", "--device", args.device, "--backend", args.backend,
           "--size", args.size, "--model", str(args.model)]
    procs = [subprocess.Popen(cmd, env=dict(base, RANK=str(k),
                                            LOCAL_RANK=str(k)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(REPO))
             for k in range(args.processes)]
    try:
        outs = [p.communicate(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker exited {p.returncode}; stderr tail:\n"
                               f"{err[-3000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    tol = TOL if args.processes > 1 else 0.0
    for key in (k for k in results[0] if k.split("_")[0] in CASES):
        losses = {r[key]["loss"] for r in results}
        if len(losses) != 1 or not np.isfinite(list(losses)[0]):
            raise RuntimeError(f"{key}: the ranks' losses differ or are not "
                               f"finite: {sorted(losses)}")
        held = ("loss_diff", "stats_diff") + (
            ("param_diff",) if key.endswith("64") or tol == 0.0 else ())
        for r in results:
            worst = max(r[key][k] for k in held)
            if not worst <= tol:
                raise RuntimeError(f"{key}: rank {r['rank']} is {worst:.3g} "
                                   f"from the single-process step (tol "
                                   f"{tol}): {r[key]}")
            if args.model > 1 and not (r[key]["sharded"] > 0 and all(
                    r[key][k] for k in ("shards_exact", "tree_layout_equal",
                                        "optim_layout_equal",
                                        "optim_round_trip"))):
                raise RuntimeError(f"{key}: rank {r['rank']}'s shards or "
                                   f"weights tree are wrong: {r[key]}")
    summary = {"ok": True, "tol": tol, "workers": results}
    print(json.dumps(summary), flush=True)
    return summary


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--worker", action="store_true",
                        help="run as one rank (the launcher sets this)")
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--model", type=int, default=1,
                        help="ranks on the model axis (tensor parallelism); "
                             "must divide --processes")
    parser.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    parser.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                        help="default: gloo on the CPU, nccl on CUDA")
    parser.add_argument("--size", choices=["tiny", "full"], default="tiny")
    parser.add_argument("--timeout", type=float, default=600.0,
                        help="seconds each worker may take")
    args = parser.parse_args(argv)
    if args.backend is None:
        args.backend = "gloo" if args.device == "cpu" else "nccl"
    if args.model < 1 or args.processes % args.model:
        parser.error(f"--model {args.model} must divide --processes "
                     f"{args.processes}")
    if args.device == "cuda" and not args.worker \
            and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but CUDA is not "
                           "available (use --device cpu)")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.worker:
        worker(args)
        return None
    return launch(args)


if __name__ == "__main__":
    main()
