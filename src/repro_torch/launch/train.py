"""Fault-tolerant training driver.

Counterpart of ``repro.launch.train``, on one device or one process a
rank of a ``(data, model)`` mesh:

    python -m repro_torch.launch.train --arch lm-100m --steps 20 \\
        --batch 8 --seq-len 512
    python -m repro_torch.launch.train --device cpu --arch minitron-8b \\
        --smoke --steps 10 --batch 2 --seq-len 32 \\
        --checkpoint-dir /tmp/ckpt --checkpoint-every 3 --fail-at 6
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch lm-100m --data 2 --model 2 \\
        --checkpoint-dir /tmp/ckpt

* **checkpoint/restart** — async atomic checkpoints every N steps; on
  start the latest checkpoint (params, optimizer state, step) is restored
  and the data pipeline resumes from the next step (step-indexed
  batches).  The checkpoints are the reference's format and keys.
* **elastic re-mesh** — checkpoints hold full host arrays; a restart on
  another mesh restores each rank's slices under the current one.
* **straggler monitor** — EWMA step-time outlier detection, logged.
* **--fail-at** — fault injection: exit 17 after that step, on every
  rank once the checkpoint is written, to exercise the restart path end
  to end.

The model trains on float32 master weights, cast to bf16 at every use;
attention runs through K7 and its backward K7b on the card (on each
rank's heads when sharded).  Only the ``lm`` family is accepted, as in
the reference.  ``--device`` is ``cuda`` by default (a missing card is an
error) and ``cpu`` on request, where every kernel wrapper runs its plain
version.

Under ``torchrun`` the ranks form a ``(data, model)`` mesh
(``--data`` defaults to the world size over ``--model``; a grid that is
not the world size is an error): FSDP and DP over ``data``, TP and EP
over ``model`` (``transformer.make_train_step(cfg, rules)``), each rank
holding its slices of the params and the optimiser state and its rows of
each batch; rank 0 alone logs.  ``--batch`` is any size, as the
reference's: the rows are cut over the batch axes ``batch_spec`` keeps
(fewer of them, or none, where the batch does not divide) and whole on
the ranks of the others (``TokenPipeline(rules=)``).  Without ``torchrun`` it is one process on
one device, the one-device step.

The ``lm-100m`` arch is the end-to-end example config (~100M params).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.distributed.sharding import P, full_like, rules_for_mesh
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.launch.mesh import init_from_env, make_host_mesh
from repro_torch.models import transformer
from repro_torch.optim import OptState, adamw_init, cosine_schedule

LM_100M = transformer.LMConfig(
    name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_head=64, d_ff=2048, vocab=32768, tie_embeddings=True,
    rope_theta=10_000.0, mlp_act="swiglu")


def resolve_config(arch: str, smoke: bool) -> transformer.LMConfig:
    if arch == "lm-100m":
        return LM_100M
    try:
        rec = configs.get(arch)
    except KeyError as e:
        raise SystemExit(f"train.py drives LM archs; {e.args[0]}") from e
    if rec.family != "lm":
        raise SystemExit(f"train.py drives LM archs; {arch} is "
                         f"{rec.family} (see examples/ for other families)")
    return rec.smoke if smoke else rec.full


def main(argv=None) -> dict:
    """Train; returns {first_loss, last_loss, steps_run, start_step} as the
    reference does, with each step's ``losses``, ``grad_norms`` and wall
    seconds (``step_s``) beside them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--data", type=int, default=0, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="fault injection: sys.exit at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.arch, args.smoke)
    device = init_from_env(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    data = args.data or max(1, world // args.model)
    if data * args.model != world:
        raise SystemExit(f"--data {data} --model {args.model} is a mesh of "
                         f"{data * args.model} ranks; the world has {world} "
                         f"(launch {data * args.model} ranks with torchrun)")
    rules = None
    if world > 1:
        mesh = make_host_mesh(data=data, model=args.model, device=device)
        rules = rules_for_mesh(mesh)
    rank0 = rules is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    where = mesh.describe() if rules is not None else str(device)
    say(f"training {cfg.name} on {where} "
        f"({cfg.param_count() / 1e6:.1f}M params, "
        f"{cfg.active_param_count() / 1e6:.1f}M active)")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    tp = rules.tp if rules is not None else 1
    params = transformer.init_params(cfg, gen, device, dtype=torch.float32,
                                     ep=tp, vocab_pad_to=tp, rules=rules)
    opt = adamw_init(params)
    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    step_fn = transformer.make_train_step(cfg, rules, lr=lr,
                                          batch_size=args.batch)

    specs = None
    if rules is not None:
        pspecs = transformer.param_specs(cfg, rules)
        specs = {"params": pspecs, "opt": OptState(P(), pspecs, pspecs)}
    ckpt = (CheckpointManager(args.checkpoint_dir, rules=rules, specs=specs)
            if args.checkpoint_dir else None)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state = {"params": params, "opt": opt}
        like = full_like(state, specs, rules) if rules is not None else state
        step, restored = ckpt.restore_latest(like, device)
        params, opt = restored["params"], restored["opt"]
        start_step = step + 1
        say(f"restored checkpoint at step {step}; resuming "
            f"from {start_step} on {where}")

    pipe = TokenPipeline(seed=args.seed, batch=args.batch,
                         seq_len=args.seq_len, vocab=cfg.vocab, device=device,
                         rules=rules)
    monitor = StragglerMonitor(
        on_warn=lambda s, dt, mu: say(
            f"  [straggler] step {s}: {dt * 1e3:.0f}ms "
            f"vs mean {mu * 1e3:.0f}ms"))

    it = pipe.iter_from(start_step)
    losses, grad_norms, step_s = [], [], []
    for step in range(start_step, args.steps):
        batch = next(it)
        t0 = time.perf_counter()
        monitor.start()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))      # waits for the step
        monitor.stop(step)
        step_s.append(time.perf_counter() - t0)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {grad_norms[-1]:.3f} "
                f"({monitor.mean_step_time * 1e3:.0f} ms/step)")
        if ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            ckpt.save_async(step, {"params": params, "opt": opt})
        if args.fail_at and step == args.fail_at:
            say(f"[fault injection] dying at step {step}")
            if ckpt is not None:
                ckpt.wait()
            if rules is None:
                sys.exit(17)
            # Every rank at once, past the barrier of ``wait``: torchrun
            # kills the ranks still tearing down when the first exits.
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(17)
    it.close()                            # the prefetch thread joined
    if ckpt is not None:
        ckpt.wait()                       # the last async write first
        ckpt.save(args.steps - 1, {"params": params, "opt": opt})
    if losses:
        say(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
            f"{len(losses)} steps")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps_run": len(losses), "start_step": start_step,
            "losses": losses, "grad_norms": grad_norms, "step_s": step_s}


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        # Past a barrier every rank leaves at once, as at --fail-at: a rank
        # still joining its gloo threads when a peer has gone can abort
        # (std::terminate), and torchrun then fails the whole run.
        dist.barrier()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
