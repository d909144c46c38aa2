"""Fault-tolerant training driver.

Counterpart of ``repro.launch.train``, on one device:

    python -m repro_torch.launch.train --arch lm-100m --steps 20 \\
        --batch 8 --seq-len 512
    python -m repro_torch.launch.train --device cpu --arch minitron-8b \\
        --smoke --steps 10 --batch 2 --seq-len 32 \\
        --checkpoint-dir /tmp/ckpt --checkpoint-every 3 --fail-at 6

* **checkpoint/restart** — async atomic checkpoints every N steps; on
  start the latest checkpoint (params, optimizer state, step) is restored
  and the data pipeline resumes from the next step (step-indexed
  batches).  The checkpoints are the reference's format and keys.
* **straggler monitor** — EWMA step-time outlier detection, logged.
* **--fail-at** — fault injection: exit 17 after that step, to exercise
  the restart path end to end.

The model trains on float32 master weights, cast to bf16 at every use;
attention runs through K7 and its backward K7b on the card.  Only the
``lm`` family is accepted, as in the reference.  ``--device`` is ``cuda``
by default (a missing card is an error) and ``cpu`` on request, where
every kernel wrapper runs its plain version.  The reference's mesh axes
(``--data``, ``--model``) are accepted only at 1: the sharded LM path is
not ported (ROADMAP, Queue 1, the sharded LM path).

The ``lm-100m`` arch is the end-to-end example config (~100M params).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.straggler import StragglerMonitor
from repro_torch.models import transformer
from repro_torch.optim import adamw_init, cosine_schedule

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

    if args.data not in (0, 1) or args.model != 1:
        raise SystemExit(
            f"--data {args.data} --model {args.model}: the port trains on "
            f"one device; the sharded LM path (ROADMAP, Queue 1) is not "
            f"ported")
    device = resolve_device(args.device)
    cfg = resolve_config(args.arch, args.smoke)
    print(f"training {cfg.name} on {device} "
          f"({cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.active_param_count() / 1e6:.1f}M active)")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, device, dtype=torch.float32)
    opt = adamw_init(params)
    lr = cosine_schedule(args.lr, args.warmup, args.steps)
    step_fn = transformer.make_train_step(cfg, lr=lr)

    ckpt = (CheckpointManager(args.checkpoint_dir)
            if args.checkpoint_dir else None)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        step, restored = ckpt.restore_latest({"params": params, "opt": opt},
                                             device)
        params, opt = restored["params"], restored["opt"]
        start_step = step + 1
        print(f"restored checkpoint at step {step}; resuming "
              f"from {start_step} on {device}")

    pipe = TokenPipeline(seed=args.seed, batch=args.batch,
                         seq_len=args.seq_len, vocab=cfg.vocab, device=device)
    monitor = StragglerMonitor(
        on_warn=lambda s, dt, mu: print(
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
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {grad_norms[-1]:.3f} "
                  f"({monitor.mean_step_time * 1e3:.0f} ms/step)")
        if ckpt is not None and (step + 1) % args.checkpoint_every == 0:
            ckpt.save_async(step, {"params": params, "opt": opt})
        if args.fail_at and step == args.fail_at:
            print(f"[fault injection] dying at step {step}")
            if ckpt is not None:
                ckpt.wait()
            sys.exit(17)
    if ckpt is not None:
        ckpt.wait()                       # the last async write first
        ckpt.save(args.steps - 1, {"params": params, "opt": opt})
    if losses:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{len(losses)} steps")
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps_run": len(losses), "start_step": start_step,
            "losses": losses, "grad_norms": grad_norms, "step_s": step_s}


if __name__ == "__main__":
    main()
