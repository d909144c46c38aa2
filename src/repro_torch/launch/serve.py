"""Serving launcher over the port's serving subsystem (DESIGN.md §7, §11, §14).

Counterpart of ``repro.launch.serve``.  Every mode fronts its engine with
the servers' protocol (submit / poll / drain and ``metrics()``):

* ``--mode bnn`` — a paper network (``--network``) behind an
  :class:`~repro_torch.serving.server.InferenceServer`, each bucket built
  (and on the card captured) before traffic, with async double-buffered
  dispatch (``--sync`` for the blocking baseline) and, with ``--shard``,
  data-parallel row shards over the visible cards (only when there are
  two or more; one card serves unsharded);
* ``--workload`` — a registered workload (``repro_torch.workloads``):
  images of any size go through its preprocess hook and the server
  returns decoded predictions (top-k labels, NMS'd boxes);
* ``--workloads a:3,b`` — each entry (``name[:weight]``) a weighted-fair
  lane of one :class:`~repro_torch.serving.multiplex.MultiTenantServer`;
* ``--mode lm`` — continuous-batching decode through
  :class:`~repro_torch.serving.lm_server.LMServer` (the reference's demo
  config, weights drawn from a numpy seed); under ``torchrun`` with N
  ranks, sharded over a ``(1, N)`` mesh (``launch.mesh``), or ``(D, N /
  D)`` with ``--data D`` (each data rank the cache rows of its slots),
  every rank serving the same requests on its shards and rank 0
  printing;
* ``--export-artifact PATH`` / ``--artifact PATH`` — export each
  bucket's frozen executor, or boot the server from such a directory with
  no tuning, planning or building;
* ``--journal PATH`` — the durable request journal: accepted submits are
  journaled before they enter the queue, and a boot over an existing
  journal replays what a crashed process left unresolved;
* ``--fault-storm`` — the reference's seed-7 plan (transient device
  faults and latency spikes at ``server.device``) while the requests flow.

``--device`` is ``cuda`` by default (a missing card is an error) and
``cpu`` on request, where every kernel wrapper runs its plain version.

    python -m repro_torch.launch.serve --workload alexnet_imagenet \\
        --requests 16
    python -m repro_torch.launch.serve --device cpu \\
        --workload alexnet_imagenet --variant tiny --requests 4 --fault-storm
    python -m repro_torch.launch.serve --workload alexnet_imagenet \\
        --export-artifact /tmp/alex.art
    python -m repro_torch.launch.serve --workload alexnet_imagenet \\
        --artifact /tmp/alex.art --journal /tmp/alex.jsonl
    python -m repro_torch.launch.serve --workloads \\
        alexnet_imagenet:3,yolov2_tiny_voc --requests 8
    python -m repro_torch.launch.serve --mode lm --requests 4
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --mode lm --requests 4
    python -m repro_torch.launch.serve --workload alexnet_imagenet --sync
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.distributed.pipeline import visible_cards
from repro_torch.distributed.sharding import DataParallel, rules_for_mesh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import paper_nets, transformer
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import InferenceServer, PhoneBitEngine, buckets_for
from repro_torch.serving.lm_server import LMServer


def _print_metrics(tag: str, m: dict) -> None:
    lat = (f"p50 {m['p50_ms']:.1f} ms, p95 {m['p95_ms']:.1f} ms"
           if m.get("p50_ms") is not None else "no latency samples")
    thr = (f"{m['throughput']:.1f}/s" if m.get("throughput") else "n/a")
    print(f"[{tag}] served {m['served']} (dropped {m['dropped']}), "
          f"{lat}, throughput {thr}")
    # The resilience counters, printed only when one is nonzero.
    res = {k: m[k] for k in ("retries", "errors", "rejected", "degraded")
           if m.get(k)}
    if res:
        mode = f", mode {m['mode']}" if m.get("mode") else ""
        print(f"[{tag}] resilience: "
              + ", ".join(f"{k} {v}" for k, v in res.items()) + mode)


def _mode_kw(args) -> dict:
    """The engine's own default mode unless one was asked for."""
    return {"matmul_mode": args.matmul_mode} if args.matmul_mode else {}


def serve_bnn(args) -> dict:
    from repro_torch import workloads
    from repro_torch.workloads.workload import checkpoint_params

    workload = None
    if args.workload:
        workload = workloads.get(args.workload, variant=args.variant,
                                 input_hw=args.input_hw or None,
                                 device=args.device, **_mode_kw(args))
        engine, (h, w) = workload.engine, workload.input_hw
        print(f"{workload.name}: packed model "
              f"{workload.model_bytes / 2**20:.1f} MiB, input {h}x{w}, "
              f"task {workload.task}, mode {engine.matmul_mode}, "
              f"device {engine.device}")
    else:
        spec, (h, w, _) = paper_nets.get(args.network)
        if args.input_hw:        # fully-conv nets serve any resolution
            h = w = args.input_hw
        engine = PhoneBitEngine.from_trained(
            checkpoint_params(spec), spec, (h, w), device=args.device,
            **_mode_kw(args))
        print(f"{args.network}: packed model "
              f"{engine.model_bytes / 2**20:.1f} MiB, input {h}x{w}, mode "
              f"{engine.matmul_mode}, device {engine.device}")
    buckets = buckets_for(args.batch)
    if args.export_artifact:
        # The offline half of zero-warm-up serving: write each bucket's
        # frozen executor and the tuner's table, then exit.
        kw = {"workload": workload.name} if workload else {}
        meta = engine.export_artifact(args.export_artifact, buckets, **kw)
        print(f"[bnn] exported artifact {args.export_artifact} (buckets "
              f"{sorted(int(b) for b in meta['buckets'])}, mode "
              f"{meta['mode']})")
        return meta

    placement = None
    if args.shard:
        # The reference's guard: shard only over two or more devices.
        cards = visible_cards() if engine.device.type == "cuda" else ()
        if len(cards) > 1:
            placement = DataParallel(cards)
            print(f"[bnn] data-parallel over {len(cards)} cards")
        else:
            print(f"[bnn] --shard with {len(cards)} visible card(s): "
                  f"serving unsharded")
    if args.sync:
        print("[bnn] sync dispatch (blocking baseline)")
    journal = None
    if args.journal:
        from repro_torch.serving.recovery import (RequestJournal,
                                                  replay_journal)
        journal = RequestJournal(args.journal)
    server = InferenceServer(
        engine, max_batch=args.batch, max_wait_s=0.0, buckets=buckets,
        preprocess=workload.preprocess_hook if workload else None,
        max_queue=args.max_queue or None, watchdog_s=args.watchdog_s,
        artifact=args.artifact, journal=journal,
        async_dispatch=not args.sync, placement=placement)
    if journal is not None:
        # Requests a previous process journaled but never resolved are
        # resubmitted first.
        replayed = replay_journal(server, args.journal)
        if replayed:
            print(f"[bnn] journal {args.journal}: replaying "
                  f"{len(replayed)} unresolved request(s)")
    if args.artifact:
        rep = server.artifact_report
        print(f"[bnn] artifact {args.artifact}: loaded buckets "
              f"{rep['loaded']}, missed {dict(rep['missed'])}")
    else:
        built = server.compile_buckets()
        print(f"built buckets {list(built)} in "
              f"{sum(built.values()):.2f}s")
    builds = engine.build_count

    plan = None
    if args.fault_storm:
        # The resilience layer end to end: seeded transient device faults
        # and latency spikes while the requests flow.
        from repro_torch.serving.faults import FaultPlan, FaultSpec, install

        plan = install(FaultPlan([
            FaultSpec("server.device", "device_fault", times=2),
            FaultSpec("server.device", "device_fault", rate=0.1, after=2),
            FaultSpec("server.device", "latency_spike", rate=0.1,
                      duration_s=0.002),
        ], seed=7))
        print("[bnn] fault storm installed (seed 7)")

    rng = np.random.default_rng(0)
    # Workload requests arrive off the network's size, through the
    # preprocess hook; raw-engine requests arrive network-sized.
    req_hw = (h + h // 2, w * 2) if workload else (h, w)
    reqs = [server.submit(rng.integers(0, 256, (*req_hw, 3),
                                       dtype=np.uint8),
                          deadline_s=args.deadline_s)
            for _ in range(args.requests)]
    server.drain()
    if plan is not None:
        from repro_torch.serving import faults

        faults.uninstall()
        demotions = (len(server.health.demotions)
                     if server.health is not None else 0)
        print(f"[bnn] storm: {len(plan.log)} faults injected, "
              f"{demotions} demotions")
    if journal is not None:
        journal.close()
    m = server.metrics()
    _print_metrics("bnn", m)
    print(f"[bnn] executors built while serving: "
          f"{engine.build_count - builds}")
    if workload is not None:
        first = next((r for r in reqs if r.result is not None), None)
        if first is not None:
            preds = workload.format(first.result)
            print(f"[bnn] request 0 -> {len(preds)} predictions; "
                  f"top: {preds[:3]}")
    if not all(r.done for r in reqs):
        raise RuntimeError("a request did not resolve")
    return m


def serve_multi(args) -> dict:
    """Multi-tenant serving: each ``--workloads`` entry (name[:weight]) a
    weighted-fair lane of one MultiTenantServer."""
    from repro_torch import workloads
    from repro_torch.serving import MultiTenantServer

    mux = MultiTenantServer(max_batch=args.batch, max_wait_s=0.0,
                            buckets=buckets_for(args.batch),
                            max_queue=args.max_queue or None,
                            watchdog_s=args.watchdog_s)
    wls = {}
    for entry in args.workloads.split(","):
        name, _, w = entry.strip().partition(":")
        weight = float(w) if w else 1.0
        wl = workloads.get(name, variant=args.variant,
                           input_hw=args.input_hw or None,
                           device=args.device, **_mode_kw(args))
        wls[name] = wl
        mux.add_workload(name, wl, weight=weight)
        print(f"[mux] tenant {name}: weight {weight}, "
              f"input {wl.input_hw[0]}x{wl.input_hw[1]}, task {wl.task}")

    rng = np.random.default_rng(0)
    reqs = {name: [] for name in wls}
    for _ in range(args.requests):
        for name, wl in wls.items():
            h, w = wl.input_hw
            reqs[name].append(mux.submit(
                name, rng.integers(0, 256, (h + h // 2, w * 2, 3),
                                   dtype=np.uint8),
                deadline_s=args.deadline_s))
    mux.drain()
    m = mux.metrics()
    for name in wls:
        _print_metrics(f"mux:{name}", m["tenants"][name])
    ledger = ", ".join(
        f"{name} {f['dispatched_rows']} rows (w={f['weight']})"
        for name, f in m["fairness"].items())
    print(f"[mux] fairness: {ledger}")
    if not all(r.done for rs in reqs.values() for r in rs):
        raise RuntimeError("a request did not resolve")
    return m


#: The reference launcher's demo LM.
LM_DEMO = transformer.LMConfig(
    name="lm-serve-demo", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
    d_head=32, d_ff=512, vocab=1024, tie_embeddings=True)


def lm_params(cfg: transformer.LMConfig, seed: int, device,
              rules=None) -> dict:
    """``cfg``'s parameters drawn from a numpy seed at the reference's
    scales (matrices N(0, 1/fan_in), embedding and head N(0, 0.02²),
    norms 1); with ``rules`` the rank's shards, the experts and the vocab
    padded to the model axis as the reference's ``serve_lm`` pads
    them."""
    rng = np.random.default_rng(seed)
    layers = {}
    for name, shape, fan_in in transformer._layer_shapes(cfg):
        full = (cfg.n_layers, *shape)
        layers[name] = (rng.standard_normal(full) / math.sqrt(fan_in)
                        if fan_in else np.ones(full))
    tree = {"embed": rng.standard_normal((cfg.vocab, cfg.d_model)) * 0.02,
            "layers": layers, "final_norm": np.ones(cfg.d_model)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = rng.standard_normal((cfg.d_model, cfg.vocab)) \
            * 0.02
    if rules is None:
        return transformer.params_from_numpy(tree, cfg, device)
    return transformer.params_from_numpy(
        tree, cfg, device, ep=rules.tp, vocab_pad_to=rules.tp, rules=rules)


def serve_lm(args) -> dict:
    """The demo LM behind ``LMServer``: on one device, or under torchrun on
    a ``(1, world)`` mesh, as the reference's ``serve_lm``, or on
    ``(args.data, world / args.data)``."""
    cfg = LM_DEMO
    device = mesh_lib.init_from_env(args.device)
    rules = None
    lead = True
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        if world % args.data:
            raise SystemExit(f"--data {args.data} does not divide the "
                             f"world of {world} ranks")
        mesh = mesh_lib.make_host_mesh(
            data=args.data, model=world // args.data, device=device)
        rules = rules_for_mesh(mesh)
        lead = mesh.rank == 0
        if lead:
            print(f"[lm] {mesh.describe()}")
    journal = None
    if args.journal:
        from repro_torch.serving.recovery import (RequestJournal,
                                                  replay_journal)
        # One journal a rank: every rank replays the same requests.
        jpath = args.journal if lead else f"{args.journal}.rank{mesh.rank}"
        journal = RequestJournal(jpath)
    server = LMServer(cfg, lm_params(cfg, 0, device, rules),
                      n_slots=args.batch, max_seq=args.max_seq,
                      max_queue=args.max_queue or None, device=device,
                      journal=journal, rules=rules)
    if journal is not None:
        replayed = replay_journal(server, jpath)
        if replayed and lead:
            print(f"[lm] journal {args.journal}: replaying "
                  f"{len(replayed)} unresolved request(s)")
    rng = np.random.default_rng(0)
    reqs = [server.submit([int(t) for t in rng.integers(1, cfg.vocab, 8)],
                          max_new=args.max_new, deadline_s=args.deadline_s)
            for _ in range(args.requests)]
    server.drain()
    if journal is not None:
        journal.close()
    if not all(r.done for r in reqs):
        raise RuntimeError("a request did not resolve")
    m = server.metrics()
    toks = sum(len(r.result) for r in reqs if r.result)
    if lead:
        _print_metrics("lm", m)
        print(f"[lm] {toks} tokens, kv utilization "
              f"{m['kv_utilization']:.0%}")
    if rules is not None:
        torch.distributed.destroy_process_group()
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("bnn", "lm"), default="bnn")
    ap.add_argument("--network", default="yolov2-tiny")
    ap.add_argument("--workload", default=None,
                    help="serve a registered workload (repro_torch."
                         "workloads, e.g. yolov2_tiny_voc): preprocess "
                         "hook and decoded predictions")
    ap.add_argument("--workloads", default=None, metavar="A[:W],B[:W]",
                    help="multi-tenant serving: comma-separated workload "
                         "names, each optionally :weighted, one "
                         "weighted-fair lane an entry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a missing card is an error) or "
                         "cpu (every kernel's plain version)")
    ap.add_argument("--matmul-mode", default=None,
                    help="the engine's serving mode (default: the "
                         "engine's own, cuda_direct_pool)")
    ap.add_argument("--variant", default="paper",
                    help="workload variant (paper | tiny)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--input-hw", type=int, default=0,
                    help="override the input resolution (fully-conv nets; "
                         "0 = the paper's)")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous dispatch (baseline; default is "
                         "async double-buffered)")
    ap.add_argument("--shard", action="store_true",
                    help="data-parallel batch sharding over the visible "
                         "cards (two or more)")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission: submits beyond this queue "
                         "depth resolve rejected (0 = unbounded)")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="bound each device readback; a stalled batch "
                         "resolves error instead of hanging")
    ap.add_argument("--fault-storm", action="store_true",
                    help="install the seeded fault plan (transient device "
                         "faults and latency spikes) to show retry and "
                         "degradation; bnn mode only")
    ap.add_argument("--data", type=int, default=1,
                    help="lm mode under torchrun: the mesh's data axis "
                         "(the slots' rows cut over it), the model axis "
                         "the rest of the ranks")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--export-artifact", default=None, metavar="PATH",
                    help="export each bucket's frozen executor and the "
                         "tuner's table to this directory and exit")
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="boot the server from an exported artifact (no "
                         "tuning, planning or building)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="durable request journal (JSONL write-ahead "
                         "log): accepted submits reach the disk before "
                         "they enqueue; at boot, requests a crashed "
                         "process left unresolved are replayed")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the serving spans and write a Chrome/"
                         "Perfetto trace-event JSON here")
    args = ap.parse_args(argv)
    tracer = obs_trace.install() if args.trace_out else None
    try:
        if args.workloads:
            return serve_multi(args)
        if args.mode == "bnn":
            return serve_bnn(args)
        return serve_lm(args)
    finally:
        if tracer is not None:
            obs_trace.uninstall()
            tracer.export(args.trace_out)
            print(f"wrote {len(tracer.events)} trace events to "
                  f"{args.trace_out}")


if __name__ == "__main__":
    main()
