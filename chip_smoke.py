#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build    — compile the CUDA kernel library from ``csrc/`` with nvcc
              (sm_90a), print the card's name and power limit, check the
              region planner's shared-memory budget against the card's
              opt-in limit per block, and print K7's and K7b's main
              kernel's registers and shared memory a block (K7b's local
              memory a thread must be 0: nothing spilled) and K5's cluster
              size C (with how many clusters of 16, 8 and 4 the card holds
              at once);
2. kernels  — every kernel of the serving paths (K4 bitplane_pack, K3
              direct_conv_bn_binarize and its bit-plane variant
              direct_conv_bn_binarize_planes, K2 fused_matmul_bn_binarize,
              K5 chain_conv, K1 xnor_popcount_matmul and its bit-plane
              variant xnor_popcount_matmul_planes, K6 mxu_pm1_matmul)
              against its plain PyTorch version on the card, bit-exact, at
              AlexNet's batch-8 shapes and at edge cases (K4 also at C in
              {1, 8, 31, 32, 33, 64, 100, 200}, at pixel counts no
              multiple of its 256-pixel blocks and from inputs that start
              off a 16-byte boundary), with thresholds
              that give a mix of output bits (a share of 0.2 to 0.8 set; for
              K1 and K6, whose counts the threshold follows on the main path,
              0.3 to 0.7); K5 at AlexNet's region (batch 8 and 1), tiled
              cases (one with 3 images a cluster and a last block of 1),
              YOLOv2-Tiny's conv4-conv8 region and a region whose later
              stages have fewer rows than C (shared out by words); K1 at
              conv1 with random plane weights (the generic weighted
              kernel); the bit-plane variants of K3 and K1 on
              converter-structured filters (each tap's sign words in all 8
              planes) at AlexNet conv1 (pool and no pool), YOLOv2-Tiny conv1
              (416², 3x3, pad 1, 16 filters), input pad bits set and a
              ragged first-layer K1 case, each also against the generic
              plain version on the weighted words; K6 at conv2, fc6, fc7
              and batch 1 at fc6, at words with pad bits, ragged tiles, k_valid
              past 2^24, a W below the cluster split its planner would
              take, N not a multiple of the swapped tile and 12 rows; K2
              also at conv2's im2col shape, a ragged 37x48x13 case split
              over a cluster, M 12 and M 17 (every route of
              ``pm1_gemm.plan_pm1``);
3. serve    — paper AlexNet (227x227x3, 1000 classes, numpy-seeded random
              weights) behind ``InferenceServer``, once per serving path:
              ``cuda_direct_pool`` (launches per forward K4 1, K3's
              bit-plane variant 1 for conv1, K3 4, K2 2), ``cuda_chain`` (K4
              1, K5 1, K2 2, no K3) and ``cuda_pm1`` (K4 1, K1's bit-plane
              variant 1 for conv1, K6 6, no K2, K3 or K5).  Each bucket is
              one CUDA graph of the forward and the head.  The executors
              are built first; then the counted run: the server's boot,
              which captures every bucket, and mixed-size raw images in
              mixed group sizes through buckets (1, 2, 4, 8).  Every row
              equals ``cross_check`` on the same padded batch (the graph's
              raw output against the flat oracle) and the captured output
              the eager executor's; ``build_count`` and ``capture_count``
              stay flat; the wrapper launches over the boot are the
              captured forwards (warm-up calls and the captured one, per
              bucket) times the path's launches a forward, the traffic
              adds none (a replay calls no wrapper), and a torch.profiler
              trace of the traffic counts its replays' kernels: the groups
              served times the path's launches a forward; then a steady run
              of 64 images eager and captured, and the preprocess time per
              image (copy and resize on the card).  Under cuda_chain
              each bucket's region tile is tuned (``tune_chains``), and
              every tile the sweep timed is held against K5's plain
              version (also YOLOv2-Tiny's two regions below); under
              cuda_direct_pool one batch of 8 is served again with tracing
              on: equal rows, a Chrome export that passes
              ``validate_trace``, the span names printed;
   profile  — one AlexNet forward and head at bucket 8 per path, eager
              then captured: host wall time, device time per kernel
              (torch.profiler), the busy share, peak device memory;
4. detect   — paper YOLOv2-Tiny at 416² for one batch of 2 through the
              engine and ``detect_head`` on each path, one captured graph,
              the same images on every path, cross-checked, equal to the
              eager executor's and the four paths' rows equal (launches
              counted over the capture and in the profile of 10 replays);
              under
              ``cuda_direct_pool`` a bucket-8 forward and head profiled as
              AlexNet's are;
              (conv1 through a bit-plane variant on the first three:
              ``cuda_chain``: K4 1, K3's 1, K5 2; ``cuda_pm1``: K4 1,
              K1's 1, K6 7; ``cuda_popcount``: K4 1, K2 8, one a conv
              node of the executor, conv1 on its weighted kernel);
   multiplex — paper AlexNet and YOLOv2-Tiny as two lanes of one
              ``MultiTenantServer`` at weights 3:1, saturated: device rows
              48:16 over 8 ticks, every row equal to its lane's
              ``cross_check``;
   faults   — the resilience layer on paper AlexNet at 227², buckets
              (1, 8) captured under ``cuda_chain``, with a seeded fault
              plan: a latency spike past the watchdog resolves ``error``
              (``retry=None``) and the next batch is served; two dispatch
              faults demote bucket 8 to ``cuda_direct_pool``, whose rung is
              captured at its next dispatch (bucket 1 stays); the demoted
              traffic's traced replays launch exactly that path's kernels
              and no K5; after the probe interval a probe promotes the
              bucket and K5 launches again; an ``executor.call`` and a
              ``server.device`` fault at bucket 1 are retried and served;
              every row equals ``cross_check``, the wrappers count the
              captures of both rungs from the servers' boot (K4, K5, K3 and
              its bit-plane variant, K2).  Every other phase's servers
              report no retry, no demotion and every bucket at its base
              mode;
   placement — multi-device serving on one card's terms (every device
              list names cuda:0): paper AlexNet behind
              ``InferenceServer(placement=Pipelined((cuda:0, cuda:0)))``
              under ``cuda_direct_pool``, ``cuda_chain`` and ``cuda_pm1``,
              each bucket captured as one graph a stage: the stage report
              (nodes, costs, boundary) printed, launches over the boot =
              the captured forwards x ``WANT_LAUNCHES`` summed over the
              stages, the traffic's traced replays = its groups x
              ``WANT_LAUNCHES``, rows == the single-device
              ``cross_check``, the staged graphs' output == the
              single-device graph's bit for bit, ``build_count`` and
              ``capture_count`` flat; YOLOv2-Tiny (416², 3 stages, bucket
              2) and VGG16 (224², 4 stages, bucket 1) under
              ``cuda_direct_pool`` likewise, their launches a forward
              summed over the stages == the single-device forward's;
              ``ReplicaGroup(engine, [cuda:0] * 2)`` of AlexNet serving
              64 mixed requests (rows == ``cross_check``, counts flat,
              packed tensors shared, output buffers apart), then a plan
              matching ``{"tenant": "r1"}`` at ``server.device`` demotes
              r1's bucket 8 alone and unpinned traffic routes to r0; the
              group's served/s over 2,048 unpinned requests; served/s at
              bucket 8 over 4,096 requests a run, async dispatch against
              the blocking baseline (printed, not asserted); (in the lm phase, before
              minitron is freed) ``LMReplicaGroup`` of minitron-8b FULL,
              2 lanes x 4 slots over one params dict, serving the 8
              requests, then lm1's decode faults outlast its restore: its
              sequences migrate to lm0 by replay prefill (its time
              printed) with their emitted prefixes kept verbatim, every
              request served, no K7 launch;
5. trained  — paper AlexNet built from seeded float params
              (``bnn_model.to_graph``): the unfused graph (``assign_layouts``)
              on the card, K4 1, K1's bit-plane variant 1 and K1 6, against
              ``default_pipeline`` of the same graph under
              ``cuda_direct_pool`` (K3's variant 1): packed tails equal bit
              for bit, float heads within 1e-3 and the same top-5, both
              within 1e-3 of ``float_forward``;
   train    — the training path: (a) K7's forward with its lse and K7b,
              its backward, against their plain versions on the card at
              lm-100m's layer (B 8, S 512, H 12, KV 4, hd 64, causal),
              minitron-8b's prefill layer (B 2, S 2048, hd 128) and at S
              512, and edge cases of K7b's 64-row, 128-key tiles (ragged,
              non-causal with Sq != Skv, G = 1, G = 4 over five key tiles),
              each of dq, dk, dv within ``K7B_TOL`` · (1 + |plain|) and
              also against autograd of the float32
              ``reference_attention``, and a second call equal to the first
              bit for bit (dq's fixed summation order); K7's output with
              the lse equal to its serving output bit for bit; (b) lm-100m
              at full width
              through ``repro_torch.launch.train.main`` in this process:
              20 AdamW steps at batch 8, sequence 512, each layer
              checkpointed (K7 24 launches a step, the forward and the
              recompute, and K7b 12; every loss finite; ms a step,
              tokens/s, peak memory, first -> last loss), step 0's loss
              and gradient norm against the same step with K7/K7b swapped
              for their plain versions, one step profiled by kernel, then
              a crash at step 6 (``--fail-at 6 --checkpoint-every 3``, exit
              17) and the restart from step 5's checkpoint, its losses at
              steps 6-9 against an uninterrupted run's within 1e-3
              relative; lm-100m at train_4k's sequence of 4,096 from its
              published batch of 256 halved until a step fits (each cut
              printed beside the peak its arithmetic predicts: the cross
              entropy's float32 logits set it), 3 steps (ms a step,
              tokens/s, the peak beside the predicted one); (c)
              paper AlexNet (227², ``paper_nets.alexnet_spec()``) trained
              10 AdamW steps with the STE sign on synthetic class
              prototypes (``examples/train_bnn.py``'s recipe, batch 8),
              then ``PhoneBitEngine.from_trained`` under
              ``cuda_direct_pool`` on 64 images: argmax equal to
              ``float_forward``'s on the trained params, the head within
              ``BNN_HEAD_TOL`` of it, K4, K3 and K2 counted; K7 and K7b
              also at every attention layer of the zoo (hd 64 and the
              padded widths 80 and 72, non-causal, H 16 = KV):
              ViT-L/16's and ViT-H/14's at 224 and 384 (S 197, 257, 577,
              730), DiT-L/2's and DiT-XL/2's at train_256, gen_fast and
              gen_1024 (S 256, 1024, 4096), and a ragged S 100 at hd 72,
              each K7b case's second call equal bit for bit;
   zoo      — the vision and diffusion archs at full width and depth,
              one at a time (device memory before, peak after; random
              weights from a seeded generator on the card), every train
              step checkpointing each layer or block (ViT and the
              convnets "nothing", DiT its configs' "dots") at the
              published batches: ViT-L/16 and ViT-H/14 serve_b1 and
              serve_b128 at 224 (bf16 weights), 3 AdamW steps at cls_224
              (batch 256; float32 masters) and 3 at cls_384 (batch 64, the
              position table resized: 577 and 730 tokens); DiT-L/2 and
              DiT-XL/2 (adaLN-zero leaves drawn N(0, 0.02²) so that
              attention reaches the output) sampling gen_fast (512², batch
              16, all 4 DDIM steps) and 2 of gen_1024's 50 steps (batch 4,
              4,096 tokens), 3 AdamW steps at train_256 (batch 256) and 3
              at train_1024 (batch 32, 4,096 tokens) on ``LatentPipeline``
              batches; ConvNeXt-B serve_b1, serve_b128 and 3 AdamW steps
              at cls_224 and at cls_384; EfficientNet-B7 serve_b1,
              serve_b128 at 224 and batch 1 at its native 600 (eval-mode
              BN), 3 SGDM steps at cls_224 and at cls_384, every BN
              statistic moved.  A train cell one card cannot hold halves
              its batch until a step fits, each cut printed.  Each train
              cell prints ms a step (step 0 the warm-up), images or
              latents a second, device memory before the model and the
              peak beside the peak its arithmetic predicts.  K7 launches
              once a layer a forward or sample step and twice a layer a
              train step (the forward and the remat's recompute), K7b once
              a layer a train step (ConvNeXt and EfficientNet neither),
              counted by the wrappers and in one profiled train step at
              cls_224 or train_256; every output, loss and sampled latent
              finite, the parameters moved; for ViT-H/14 (hd 80) and
              DiT-XL/2 (hd 72) step 0 at batch 2 through K7/K7b against
              the same step through their plain versions (loss within
              2e-3, gradient norm within 1e-2, one forward's output within
              4e-2 of max |plain|) and with remat against the same step
              without it (the same loss and gradient-norm limits, the
              largest differences printed); ms a forward and images/s, ms
              a sample step, beside the card's name and power limit;
6. lm       — K7 flash_attention against its plain version on the card
              at minitron-8b's prefill layer (B 2, S 2048, H 32, KV 8, hd
              128, bf16, causal), at granite-moe-3b-a800m's (H 24, hd 64),
              at each one's layer on one rank of the [shard] phase's tp 4
              (H 8, KV 2, hd 128; H 6, KV 2, hd 64) and at edge cases of
              its 128-row, 128-key tiles (non-causal, G = 1 at S 512 and
              256, part of one tile, ragged tiles at S 100 and 129,
              non-causal Sq 100 against Skv 300; at hd 64 ragged S 100,
              S 129 non-causal with G = 1, Sq 100 against Skv 300) within
              the stated tolerance,
              and its refusal of float32 (the kernel takes bf16, the LM
              path's dtype); then minitron-8b at full width and depth
              (32 layers, d_model 4096, vocab 256,000; bf16 weights drawn on
              the card from a seeded generator): ``make_prefill_step`` at
              B 2, S 2048 (K7 32 launches, tokens/s, K7's share of the
              device time, peak memory); the same prompt fed token by token
              through ``make_decode_step`` into a fresh cache, at the depth
              of the first 8 layers (a step costs ~39 ms at 32: the full
              depth would hold the phase past a minute; the step
              ``LMServer`` captures), its last logits
              and cache rows held against the prefill of those 8 layers (no
              K7 launch in the decode); full-depth decode steps at B 4, eager
              and captured (``LMServer``'s step as one CUDA graph), timed
              and profiled (host wall, device time, busy share, peak
              memory); ``LMServer`` answering 8 requests through the
              captured step (4 slots, max_seq 256; one over-long prompt
              rejected; no K7 launch), and an eager server giving the same
              tokens; the captured server again with ``checkpoint_every=8``
              under ``lm.step`` faults that spend the retries (a restore
              into the captured step's buffers, the ticks since replayed)
              and one cadence snapshot fault: the same tokens, each
              snapshot's host and device time and bytes, the restore's
              time; captured logits equal to eager ones bit for bit at
              every position of a generated sequence on the first 8
              layers;
   moe      — once minitron's weights are freed, qwen3-moe-30b-a3b,
              granite-moe-3b-a800m and command-r-35b in turn at full width
              and depth (bf16 weights drawn on the card, the MoE router
              float32; device memory allocated printed before each, peak
              memory after): ``make_prefill_step`` at B 2, S 2048 (K7 48,
              32 and 40 launches, finite logits and cache, tokens/s, K7's
              share of the device time); for the two MoE archs layer 0's
              MoE on the prefill's 4,096 normed tokens at a capacity factor
              that drops nothing against the dense ``moe_reference``
              (relative max error within ``LM_LOGIT_BOUND``), and at the
              published 1.25 the kept assignments and their destinations
              equal to a host recount of the same ids, exactly; the
              full-depth decode step on 4 slots captured and eager, logits
              equal bit for bit at every position of one generated
              sequence, the captured step's host wall and device time; qwen3
              ``LMServer`` (captured) serving the 8 requests (no K7
              launch);
7. autotune — engines under ``matmul_mode="auto"`` (a temporary cache
              file): paper AlexNet and YOLOv2-Tiny tuned at bucket 8 then
              1, VGG16 (224²) at 1; each node's winner, tile and sweep
              beside the default path's time; each bucket's output ==
              ``cross_check`` and its launches those of its winners; no
              plain backend wins; bucket 1 reuses bucket 8's winners
              (``xfer_hit``), and at bucket 1 a fresh sweep times each
              transferred K3 winner beside the fastest; a second engine
              re-times nothing; each tuned bucket captured (launches counted
              over the capture and in 10 replays); AlexNet's tuned forward
              profiled;
   artifact — paper AlexNet booted live in this process under ``"auto"``
              (the tuner's caches emptied, so it tunes) and
              ``cuda_direct_pool``, exported at buckets (1, 2, 4, 8),
              captured and serving 8 images; a fresh interpreter
              (``python3 -c``, repro_torch alone) boots a server from each
              artifact and serves the same images: every bucket loaded and
              captured, no tuner outcome, no nvcc build, ``build_count``
              flat, rows equal to the live boot's; both boot-to-result
              times printed; the fresh process also replays a request
              journal the live boot left with 3 unresolved submits, each
              result equal to the exporter's row;
8. timing   — each kernel at AlexNet's batch-8 shapes (CUDA events
              around one call, warmed up, median; and the device time a
              call, torch.profiler's kernel time over 20 calls / 20)
              beside its plain version and its bound —
              K4 also at bucket 1; K3 and K1 at conv1 in both variants
              (the bit-plane variant on the main path, the generic
              weighted kernel off it); K5
              also at every cluster size the card can schedule; K1 and K6
              also beside one library call on the unpacked +-1 operands; K7
              at minitron's and granite's prefill layers (hd 128 and 64,
              causal) and at ViT-H/14's serve_b128 layer (B 128, S 257,
              hd 80) and DiT-XL/2's gen_fast layer (B 16, S 1024, hd 72),
              non-causal, beside ``F.scaled_dot_product_attention`` on
              the same tensors (the bound counts Sq·Skv pairs at the true
              width there); K7b at lm-100m's layer, minitron-8b's prefill
              layer and the two zoo layers, each launch's device time (the
              D pre-pass and the main kernel), beside SDPA's backward with
              each backend pinned
              (``sdpa_kernel``: flash, cuDNN, memory-efficient; K/V
              expanded to H heads where a backend takes no GQA), the
              backward of one forward repeated;
9. shard    — the sharded LM serving path (``launch.mesh``, ``Rules``):
              minitron-8b (tensor-parallel) and granite-moe-3b-a800m
              (expert-parallel, 10 experts a rank, capacity factor E/k = 5
              so nothing drops; the drops at the published 1.25 printed
              for layer 0) at full width and depth, the weights drawn once
              here and handed to 4 ranks through CUDA IPC, each keeping its
              slices; the ranks share the card on a (1, 4) mesh over gloo,
              every collective staged through pinned host memory (the
              backend printed); each rank's prefill at B 2, S 2048 into a
              cache of 2304 (576 positions a rank; K7 32 launches a rank,
              on its 8 or 6 q heads) and 16 teacher-forced decode steps (no
              K7), held against the one-device path on the same weights:
              max |sharded - single| / max |single| and argmax agreement
              within ``SHARD_LIMITS`` (minitron-8b 4% and 0.95;
              granite-moe-3b-a800m 7% and 0.90: its bf16 logits are
              near-tied at the top, and its one-device path a row at a
              time misses 4% and 0.95 against itself), that one-device
              floor within the same limits; the bytes each rank hands to
              collectives
              equal to ``shard_bytes``' arithmetic; a sharded ``LMServer``
              answering 8 requests with the same tokens on every rank; a
              two-lane ``LMReplicaGroup(cfg, rules, params)`` (minitron)
              whose lm1 decode faults past its restore, its flight
              migrated to lm0 with the emitted prefixes kept and the same
              migrations and tokens on every rank; ms a
              prefill and a decode step sharded and on one device, each
              rank's peak memory (times of host-staged collectives on one
              card, not of 4 cards over NVLink).  It runs after the
              timing phase, and its K7 launches join the ``kernels`` line;
10. shard train — the sharded LM train step
              (``transformer.make_train_step(cfg, rules)``: FSDP and DP over
              ``data``, TP and EP over ``model``, every gradient collective
              a differentiable op of ``distributed.sharding``) over 4 ranks
              sharing the card as in [shard], float32 weights drawn once
              here and handed over through CUDA IPC: lm-100m at full width
              and depth on (2, 2), B 8 x S 512, 4 steps, a checkpoint after
              step 2 (gathered on every rank, written by rank 0) and a
              resume on (4, 1) from it (the file equal to each rank's saved
              slices and to its restored ones bit for bit, the resumed
              step's loss within 2e-4 of the uninterrupted run's);
              granite-moe-3b-a800m at full width on (1, 4), its depth cut
              to 4 of 32 layers, capacity factor E/k, B 4 x S 512, 2 steps.
              Step 0 of each against the one-device step on the same
              weights and batch (the balance loss over the same 4 token
              shards): loss within 2e-4, gradient norm within 5e-3, every
              gathered gradient leaf within 3% (lm-100m) or 5% (granite;
              2% is below the bf16 noise of a 12-layer TP step, see
              ``SHARD_TRAIN_LEAF_TOL``), the one-device floor
              from two half batches printed beside and held to the same
              limit; the bytes each rank hands to collectives a step equal
              to ``shard_train_bytes``' arithmetic; K7 twice and K7b once a
              layer a step on each rank's heads (B 4, S 512, H 6, KV 2, hd
              64, also among the [kernels] K7 cases and the [train] K7b
              cases), every rank's launches joining the ``kernels`` line;
              ms a step sharded and on one device, each rank's peak memory
              (host-staged gloo collectives on one card, not 4 cards over
              NVLink);
11. shard zoo — the vision and diffusion zoo under ``rules``
              (``models.zoo_mesh``) over the same 4 ranks, float32 weights
              drawn once here: ViT-H/14, DiT-XL/2 and ConvNeXt-B each
              train 2 steps on (2, 2) at a cut batch of 8 (cls_224,
              train_256: DP, FSDP and TP at once, DiT's residual cut by
              tokens over ``model``) and serve on (1, 4) (a forward of 8;
              DiT one DDIM step of 4 at 512², 1,024 tokens), EfficientNet-B7
              trains 2 steps on (2, 2) at 4 × 600² with its batch norm
              synced over ``data`` (the running statistics equal on every
              data rank, bit for bit); the bytes each rank hands to
              collectives equal to ``shard_zoo_bytes``' arithmetic; K7
              twice and K7b once a layer a step, K7 once a layer a serving
              call, on each rank's heads (``SHARD_ZOO_LAYERS``, also among
              the [kernels] and [train] cases); step 0's loss and gathered
              gradient leaves and the serving output against one device,
              bf16 through K7/K7b beside the one-device floor from two
              half batches, held to ``SHARD_ZOO_BF16_LIMITS``, and the
              float32 check; ms a step and a serving call sharded and on
              one device, each rank's peak;
12. dryrun  — the port's tracer (``launch/cells.trace_step``: one run
              under ``FakeTensorMode`` on fake cuda tensors, K7/K7b
              through their fakes, over fake process groups) in 8 worker
              processes of this script, within 120 s, against what the
              phases above ran: FLOPs equal to ``FlopCounterMode`` around
              one real lm-100m [train] step and one ViT-H/14 serve_b128
              forward; each rank's bytes into collectives of [shard],
              [shard train] and [shard zoo] equal to their arithmetic;
              each one-device [zoo] train cell's peak within 10% of the
              measured one; DiT-XL/2 train_1024 past the card's memory at
              b32 and inside it at ``ZOO_CUTS``' b16; one cell of each
              production mesh (16×16, 2×16×16) traced.

[shard], [shard train] and [shard zoo] each hold a float32 step-0 check
beside their bf16 runs (``float32_check``: float32 compute on both
sides, TF32 off, attention through K7's and K7b's plain versions; an MoE
model's experts pinned to the one-device run's choice, ``moe_routing``):
logits or a forward's output within 1e-3 of one device's with argmax
agreement >= 0.99, every gathered gradient leaf within 1e-3 relative L2,
the loss within 1e-5 (``F32_CHECK``).

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from statistics import NormalDist

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Fails without the repository's src/ beside the script.
from repro_torch import workloads  # noqa: E402
from repro_torch import configs, data, optim, tree  # noqa: E402
from repro_torch.configs import minitron_8b  # noqa: E402
from repro_torch.core import (binary_conv, binary_ops, bitplanes,  # noqa: E402
                              bnn_model, layer_integration, packing)
from repro_torch.core.binary_conv import conv_out_size  # noqa: E402
from repro_torch.kernels import bitplane_pack as k4  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import chain_conv as k5  # noqa: E402
from repro_torch.kernels import direct_conv_bn_binarize as k3  # noqa: E402
from repro_torch.kernels import flash_attention as k7  # noqa: E402
from repro_torch.kernels import fused_conv_bn_binarize as k2  # noqa: E402
from repro_torch.kernels import mxu_pm1_matmul as k6  # noqa: E402
from repro_torch.kernels import xnor_popcount_matmul as k1  # noqa: E402
from repro_torch.launch import cells, train  # noqa: E402
from repro_torch.models import layers, moe, paper_nets  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import (GraphExecutor, assign_layouts,  # noqa: E402
                                 default_pipeline, regions)
from repro_torch.serving import PhoneBitEngine, faults  # noqa: E402
from repro_torch.serving.faults import (FaultPlan, FaultSpec,  # noqa: E402
                                        RetryPolicy)
from repro_torch.serving.lm_server import LMServer  # noqa: E402
from repro_torch.serving.recovery import RequestJournal  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, the dense int8
# tensor-core rate at which a ±1 product could run, and the dense bf16
# tensor-core rate (attention).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

BATCH = 8
# (name, (N, H, W, C), kernel, stride, pad, O, pool, first layer): C is the
# real input channel count; a first layer's input is 8 bit-planes of C.
ALEXNET_CONVS = [
    ("conv1", (BATCH, 227, 227, 3), 11, 4, 0, 96, (3, 2, (0, 0)), True),
    ("conv2", (BATCH, 27, 27, 96), 5, 1, 2, 256, (3, 2, (0, 0)), False),
    ("conv3", (BATCH, 13, 13, 256), 3, 1, 1, 384, None, False),
    ("conv4", (BATCH, 13, 13, 384), 3, 1, 1, 384, None, False),
    ("conv5", (BATCH, 13, 13, 384), 3, 1, 1, 256, (3, 2, (0, 0)), False),
]
CONV_EDGES = [
    ("O=48", (BATCH, 27, 27, 96), 5, 1, 2, 48, (3, 2, (0, 0)), False),
    ("C=40 pad bits", (BATCH, 27, 27, 40), 3, 1, 1, 64, None, False),
    ("yolo conv6 pool pad (0,1)", (BATCH, 13, 13, 256), 3, 1, 1, 512,
     (2, 1, (0, 1)), False),
    ("batch 1", (1, 27, 27, 96), 5, 1, 2, 256, (3, 2, (0, 0)), False),
]
# (name, M, N, W): AlexNet's packed_dense nodes at batch 8.  Their inputs
# (9216 and 4096 channels) fill every word, so K = 32·W bits.
ALEXNET_DENSE = [("fc6", BATCH, 4096, 288), ("fc7", BATCH, 4096, 128)]
# Every route of K2's planner (kernels/pm1_gemm.py plan_pm1): conv2's im2col
# shape on 64 x 64 wgmma tiles, unsplit; a ragged unswapped grid split over
# a cluster of 4 (slices of 3-4 words, 4-byte copies); batch 1 swapped; 12
# rows on the swapped 16-row tile; 17 rows, one past the swap, split over
# 2; and the weighted CUDA-core kernel.
DENSE_EDGES = [("N=48 weighted", 37, 48, 70), ("batch 1", 1, 4096, 288),
               ("conv2 im2col", 5832, 256, 75),
               ("ragged 37x48, 13 words", 37, 48, 13),
               ("M 12", 12, 4096, 288),
               ("M 17", 17, 4096, 288)]
# K3's bit-plane variant, on converter-structured filters: (name, (N, H, W,
# C), kernel, stride, pad, O, pool, input pad bits set).
PLANE_CONVS = [
    ("conv1", (BATCH, 227, 227, 3), 11, 4, 0, 96, (3, 2, (0, 0)), False),
    ("conv1 no pool", (BATCH, 227, 227, 3), 11, 4, 0, 96, None, False),
    ("yolo conv1", (2, 416, 416, 3), 3, 1, 1, 16, (2, 2, (0, 0)), False),
    ("conv1 batch 1, input pad bits set", (1, 227, 227, 3), 11, 4, 0, 96,
     (3, 2, (0, 0)), True),
    ("ragged O=40, pool pad (0,1)", (2, 29, 31, 3), 3, 1, 1, 40,
     (2, 1, (0, 1)), False),
]
# K5 regions: the stages the planner forms at the default budget.
# AlexNet's is conv1-conv5 with their pools, on the bit-plane entry;
# YOLOv2-Tiny's second is conv4-conv8 on conv3's pooled 52x52x64 map.
ALEXNET_CHAIN = (
    k5.StageSpec("conv", 11, 4, 0, 0, 96, True),
    k5.StageSpec("pool", 3, 2, 0, 0, 96),
    k5.StageSpec("conv", 5, 1, 2, 2, 256),
    k5.StageSpec("pool", 3, 2, 0, 0, 256),
    k5.StageSpec("conv", 3, 1, 1, 1, 384),
    k5.StageSpec("conv", 3, 1, 1, 1, 384),
    k5.StageSpec("conv", 3, 1, 1, 1, 256),
    k5.StageSpec("pool", 3, 2, 0, 0, 256))
YOLO_CHAIN = (
    k5.StageSpec("conv", 3, 1, 1, 1, 128), k5.StageSpec("pool", 2, 2, 0, 0, 128),
    k5.StageSpec("conv", 3, 1, 1, 1, 256), k5.StageSpec("pool", 2, 2, 0, 0, 256),
    k5.StageSpec("conv", 3, 1, 1, 1, 512), k5.StageSpec("pool", 2, 1, 0, 1, 512),
    k5.StageSpec("conv", 3, 1, 1, 1, 1024),
    k5.StageSpec("conv", 3, 1, 1, 1, 1024))
# A region whose later stages have fewer rows than a cluster has ranks:
# those stages are shared out by output words (2 or 4 here), so most ranks
# compute nothing there.
NARROW_CHAIN = (
    k5.StageSpec("conv", 3, 1, 1, 1, 64), k5.StageSpec("pool", 2, 2, 0, 0, 64),
    k5.StageSpec("conv", 3, 1, 1, 1, 128),
    k5.StageSpec("pool", 2, 2, 0, 0, 128))
# (name, (N, H, W, C) entry, C real channels per plane word when first,
# stages, tile)
CHAIN_CASES = [
    ("alexnet region", (BATCH, 227, 227, 3), ALEXNET_CHAIN, {}),
    ("alexnet region batch 1", (1, 227, 227, 3), ALEXNET_CHAIN, {}),
    ("alexnet region tiled 4x4, 2 images a block", (3, 227, 227, 3),
     ALEXNET_CHAIN, dict(block_h=4, block_w=4, block_n=2)),
    ("yolo conv4-conv8 region", (BATCH, 52, 52, 64), YOLO_CHAIN, {}),
    ("alexnet region tiled 3x3, 3 images a block, the last block 1",
     (7, 227, 227, 3), ALEXNET_CHAIN, dict(block_h=3, block_w=3, block_n=3)),
    ("rows below the cluster size from stage 1 on", (2, 16, 16, 64),
     NARROW_CHAIN, {}),
]
# Matmul-shaped cases of K1 and K6, (name, (N, H, W, C), kernel, stride,
# pad, O, first layer): the operands are the im2col rows of an (N, H, W, C)
# map (8 bit-planes of C when first) against O filters.  A dense layer is a
# 1x1 "conv" on (M, 1, 1, C).
ALEXNET_FC = [("fc6", (BATCH, 1, 1, 9216), 1, 1, 0, 4096, False),
              ("fc7", (BATCH, 1, 1, 4096), 1, 1, 0, 4096, False)]
ALEXNET_MATMULS = [c[:6] + c[7:] for c in ALEXNET_CONVS] + ALEXNET_FC
K1_CASES = [
    ALEXNET_MATMULS[0],                                  # conv1, plane weights
    ("first layer, ragged 84x33", (2, 13, 11, 5), 3, 2, 1, 33, True),
    ALEXNET_MATMULS[1],                                  # conv2
    ALEXNET_FC[0],                                       # fc6, split
    ("ragged 37x50, 13 words", (37, 1, 1, 416), 1, 1, 0, 50, False),
]
# K1's bit-plane variant: (name, (N, H, W, C), kernel, stride, pad, O).
PLANE_MATMULS = [
    ("conv1", (BATCH, 227, 227, 3), 11, 4, 0, 96),
    ("first layer, ragged 84x33", (2, 13, 11, 5), 3, 2, 1, 33),
]
K6_CASES = [
    ALEXNET_MATMULS[1],                                  # conv2
    ALEXNET_FC[0],                                       # fc6
    ("yolo conv2, 16 pad bits a word", (2, 208, 208, 16), 3, 1, 1, 32,
     False),
    ("ragged 65x70, 24 pad bits a position", (65, 3, 3, 40), 3, 1, 0, 70,
     False),
    ("k_valid 2^24 + 32", (8, 1, 1, 32 * ((1 << 19) + 1)), 1, 1, 0, 16,
     False),
    ALEXNET_FC[1],                                       # fc7
    ("batch 1 at fc6", (1, 1, 1, 9216), 1, 1, 0, 4096, False),
    ("W 2, below the cluster split", (8, 1, 1, 64), 1, 1, 0, 512, False),
    ("N 1000, not a multiple of the swapped tile", (8, 1, 1, 4096), 1, 1,
     0, 1000, False),
    ("12 rows at fc6, the swapped 16-row tile", (12, 1, 1, 9216), 1, 1, 0,
     4096, False),
]
# K7 cases, bf16: (name, B, Sq, Skv, H, KV, hd, causal).  The first four
# are the prefill layers the LM path gives K7, one for each LM arch:
# minitron-8b's (hd 128, G = H / KV = 4), granite-moe-3b-a800m's (hd 64,
# G = 3), qwen3-moe-30b-a3b's and command-r-35b's (hd 128, G = 8); the
# kernel tiles by 128 q rows and 128 keys.
FLASH_PREFILL = ("minitron prefill layer", 2, 2048, 2048, 32, 8, 128, True)
FLASH_PREFILL_64 = ("granite prefill layer", 2, 2048, 2048, 24, 8, 64, True)
# The K7 shapes the timing phase times.
FLASH_TIMED = (FLASH_PREFILL, FLASH_PREFILL_64)
# The zoo's attention layers, every (S, hd) the [zoo] phase runs them at
# (non-causal, H = KV = 16): ViT-L/16 (hd 64) and ViT-H/14 (hd 80) at 224
# (S 197, 257) and 384 (S 577, 730: ragged against the 128-row tiles),
# DiT-L/2 (hd 64) and DiT-XL/2 (hd 72) at train_256 (S 256), gen_fast (S
# 1024) and gen_1024 (S 4096, at its batch 4; K7b, which no sample step
# runs, at B 1); B 2 elsewhere.  The timing phase times ViT-H/14's and
# DiT-XL/2's at the serving batches (serve_b128: B 128; gen_fast: B 16).
ZOO_FLASH_VIT = ("ViT-H/14 layer", 2, 257, 257, 16, 16, 80, False)
ZOO_FLASH_VIT_384 = ("ViT-H/14 layer at 384, ragged", 2, 730, 730, 16, 16,
                     80, False)
ZOO_FLASH_DIT = ("DiT-XL/2 gen_fast layer", 2, 1024, 1024, 16, 16, 72,
                 False)
ZOO_FLASH_LAYERS = [
    ("ViT-L/16 layer", 2, 197, 197, 16, 16, 64, False),
    ("ViT-L/16 layer at 384, ragged", 2, 577, 577, 16, 16, 64, False),
    ZOO_FLASH_VIT, ZOO_FLASH_VIT_384,
    ("DiT-L/2 train_256 layer", 2, 256, 256, 16, 16, 64, False),
    ("DiT-L/2 gen_fast layer", 2, 1024, 1024, 16, 16, 64, False),
    ("DiT-XL/2 train_256 layer", 2, 256, 256, 16, 16, 72, False),
    ZOO_FLASH_DIT,
]
ZOO_GEN_1024 = [("DiT-L/2 gen_1024 layer", 4, 4096, 4096, 16, 16, 64, False),
                ("DiT-XL/2 gen_1024 layer", 4, 4096, 4096, 16, 16, 72,
                 False)]
ZOO_TIMED = (("ViT-H/14 serve_b128 layer", 128, 257, 257, 16, 16, 80,
              False),
             ("DiT-XL/2 gen_fast layer", 16, 1024, 1024, 16, 16, 72, False))
# The train steps' attention layers at the batches the [train] and [zoo]
# phases run them at: lm-100m at train_4k (S 4096, causal, hd 64, 32 key
# tiles; at B 1, where the plain version's float32 scores take 0.8 GB),
# ViT-H/14 at cls_224 (B 256, S 257) and cls_384 (B 64, S 730, ragged),
# DiT-XL/2 at train_256 (B 256, S 256).
TRAIN_LAYERS = [
    ("lm-100m train_4k layer", 1, 4096, 4096, 12, 4, 64, True),
    ("ViT-H/14 cls_224 train layer", 256, 257, 257, 16, 16, 80, False),
    ("ViT-H/14 cls_384 train layer, ragged", 64, 730, 730, 16, 16, 80,
     False),
    ("DiT-XL/2 train_256 train layer", 256, 256, 256, 16, 16, 72, False),
    # the [shard train] phase's layer on one rank: lm-100m's on (2, 2) and
    # granite-moe-3b-a800m's on (1, 4) both give B 4, H 6, KV 2, hd 64
    ("lm-100m / granite train layer, a tp rank's heads", 4, 512, 512, 6,
     2, 64, True),
]
# The zoo's attention layers on one rank of a mesh ([shard zoo]: non-causal,
# H = KV, each rank's H/tp heads over all the tokens): ViT-H/14 at cls_224
# on a tp-2 rank (B 4 of 8) and serving on a tp-4 rank (B 8), DiT-XL/2 at
# train_256 on tp 2 and 4 (B 4) and at gen_fast's 512² (S 1024) on tp 4
# (B 4), and the other two zoo attention archs' tp-4 layers: ViT-L/16 (hd
# 64, S 197) and DiT-L/2 (hd 64).
SHARD_ZOO_LAYERS = [
    ("ViT-H/14 cls_224 layer, a tp-2 rank's heads", 4, 257, 257, 8, 8, 80,
     False),
    ("ViT-H/14 serving layer, a tp-4 rank's heads", 8, 257, 257, 4, 4, 80,
     False),
    ("ViT-L/16 layer, a tp-4 rank's heads", 8, 197, 197, 4, 4, 64, False),
    ("DiT-XL/2 train_256 layer, a tp-2 rank's heads", 4, 256, 256, 8, 8,
     72, False),
    ("DiT-XL/2 train_256 layer, a tp-4 rank's heads", 4, 256, 256, 4, 4,
     72, False),
    ("DiT-XL/2 gen_fast layer, a tp-4 rank's heads", 4, 1024, 1024, 4, 4,
     72, False),
    ("DiT-L/2 train_256 layer, a tp-4 rank's heads", 4, 256, 256, 4, 4, 64,
     False),
    ("DiT-L/2 gen_fast layer, a tp-4 rank's heads", 4, 1024, 1024, 4, 4,
     64, False),
]
# The attention layers a rank runs where the batch axes hold LM slots or
# do not divide the batch: [shard]'s minitron-8b prefill on (2, 2)
# (one row a data rank, a tp-2 rank's 16 q and 4 KV heads; K7 alone: a
# prefill has no backward), [shard train]'s lm-100m at B 6 whole on each
# (4, 1) rank and 3 rows a rank of (2, 2, 1), [shard zoo]'s ViT-H/14 at a
# batch of 3 whole on each (2, 2) rank over a tp-2 rank's heads.
BATCH_AXES_PREFILL = ("minitron prefill layer, a (2, 2) rank: 1 row, tp-2 "
                      "heads", 1, 2048, 2048, 16, 4, 128, True)
BATCH_AXES_LAYERS = [
    ("lm-100m train layer, B 6 whole on a (4, 1) rank", 6, 512, 512, 12,
     4, 64, True),
    ("lm-100m train layer, 3 rows a (2, 2, 1) rank", 3, 512, 512, 12, 4,
     64, True),
    ("ViT-H/14 cls_224 layer, batch 3 whole on a tp-2 rank", 3, 257, 257,
     8, 8, 80, False),
]
FLASH_CASES = [
    FLASH_PREFILL,
    FLASH_PREFILL_64,
    ("qwen3 prefill layer", 2, 2048, 2048, 32, 4, 128, True),
    ("command-r prefill layer", 2, 2048, 2048, 64, 8, 128, True),
    ("hd 64, ragged last tile, S = 100", 1, 100, 100, 24, 8, 64, True),
    ("hd 64, S = 129, G = 1, non-causal", 1, 129, 129, 8, 8, 64, False),
    ("hd 64, non-causal Sq 100, Skv 300", 1, 100, 300, 24, 8, 64, False),
    ("non-causal", 2, 1024, 1024, 32, 8, 128, False),
    ("G = 1", 1, 512, 512, 8, 8, 128, True),
    ("S = 64, part of one tile", 2, 64, 64, 32, 8, 128, True),
    ("ragged last tile, S = 100", 1, 100, 100, 32, 8, 128, True),
    ("S = 129, a full tile and one row", 1, 129, 129, 32, 8, 128, True),
    ("non-causal Sq 100, Skv 300", 1, 100, 300, 32, 8, 128, False),
    ("G = 1, S = 256", 1, 256, 256, 8, 8, 128, True),
    # The [shard] phase's prefill layers on one rank of tp 4: its local
    # q and KV heads.
    ("minitron prefill layer, tp 4 rank", 2, 2048, 2048, 8, 2, 128, True),
    ("granite prefill layer, tp 4 rank", 2, 2048, 2048, 6, 2, 64, True),
] + ZOO_FLASH_LAYERS + ZOO_GEN_1024 + [
    # hd 72 (the padded hd-128 instantiation over zero-filled columns)
    # ragged inside one tile
    ("hd 72, ragged S 100", 1, 100, 100, 16, 16, 72, False),
]
FLASH_CASES += (TRAIN_LAYERS + SHARD_ZOO_LAYERS + [BATCH_AXES_PREFILL]
                + BATCH_AXES_LAYERS)
# K7 against its plain version, |kernel - plain| <= tol·(1 + |plain|):
# both round p to bf16, under different running maxima (the kernel's
# 128-key tiles against the plain version's 512-key blocks), and round the
# output once each, so they agree to a few bf16 steps (2^-8 relative).
FLASH_TOL = 1e-2
# The LM phase: minitron-8b prefill at B 2, S 2048 into a cache of 2304.
LM_BATCH, LM_SEQ, LM_MAX_SEQ = 2, 2048, 2304
# Prefill against the token-by-token decode of the same prompt, at the
# depth of the first LM_CHECK_LAYERS layers, as max |prefill - decode| /
# max |decode| for the last position's logits and for the cache's K/V
# rows.  The bound: the reference's own two paths agree to 1-1.5% at
# smoke size, this port's to 2.1% at depth 32 (PERF.md); bf16 rounds the
# two paths' matmuls differently at every layer.  A K7 fault (a wrong
# mask, KV head or tile) moves attention by O(1), far past it.
LM_CHECK_LAYERS = 8
LM_LOGIT_BOUND = 0.04
LM_CACHE_BOUND = 0.04
# LMServer: (prompt length, max_new) of 8 requests.  The server keeps one
# global position for all slots (the reference's simplification), which
# every prompt token and every tick advance; these fit in max_seq (176
# prompt tokens + 46 ticks < 256), so no request waits for the position to
# return to 0 and ``server.pos`` counts the run's decode steps.
LM_SERVER_SLOTS, LM_SERVER_MAX_SEQ = 4, 256
LM_REQUESTS = [(16, 16), (16, 16), (16, 16), (16, 16), (16, 20), (16, 24),
               (16, 32), (64, 32)]
# The MoE phase: the three other LM archs at full width and depth, each
# prefilled as minitron-8b is (B 2, S 2048; K7 once a layer), its decode
# step captured and held against the eager step bit for bit at every
# position of one generated sequence (a prompt of 4, 4 new tokens) on
# LM_SERVER_SLOTS slots; the MoE archs' layer 0 also against the dense
# oracle, and qwen3-moe-30b-a3b serves LM_REQUESTS.
MOE_PHASE_ARCHS = ("qwen3-moe-30b-a3b", "granite-moe-3b-a800m",
                   "command-r-35b")
MOE_SERVE_ARCH = "qwen3-moe-30b-a3b"
MOE_DECODE_PROMPT, MOE_DECODE_NEW = 4, 4
# moe_reference runs every expert on every token: it takes the prefill's
# tokens this many at a time (its result does not depend on the split).
MOE_ORACLE_CHUNK = 1024
# The [shard] phase: minitron-8b (dense, tensor-parallel) and
# granite-moe-3b-a800m (expert-parallel, 10 experts a rank) at full width
# and depth on a (1, SHARD_RANKS) mesh whose ranks share the card: the LM
# phase's prefill (B 2, S 2048 into a cache of 2304: 576 positions a rank)
# and SHARD_DECODE_STEPS teacher-forced decode steps, held against the
# one-device path on the same weights as max |sharded - single| / max
# |single| over every logit of the real vocab (the bound the LM phase
# holds prefill to against decode) with the reference test's argmax
# agreement bar; then a sharded LMServer answering SHARD_REQUESTS (prompt
# length, max_new; every request a prefill step, then one tick: a
# collective costs milliseconds there, so the phase keeps its steps few).
SHARD_RANKS = 4
SHARD_ARCHS = ("minitron-8b", "granite-moe-3b-a800m")
SHARD_DECODE_STEPS = 16
# Each model's limits as (max |sharded - single| / max |single|, argmax
# agreement).  minitron-8b: 4% and 0.95, the bound the LM phase holds
# prefill to against decode and the reference test's bar.
# granite-moe-3b-a800m misses those (on an H100 80GB HBM3 at 700 W:
# 4.77e-2 and 0.9118, each miss a near-tie 1-3 bf16 steps apart at the
# top; PERF.md §6), and so
# does its own one-device path run a row at a time against the batch of 2
# (3.07e-2, 0.9118: other matmul shapes, other bf16 roundings); it is held
# to 7% and 0.90, above both readings.  A wrong head, KV chunk or expert
# moves the logits by O(1), far past either.  The one-device row-at-a-time
# floor is held to the same limits: if it passes them, the check fails
# rather than loosen.
SHARD_LIMITS = {"minitron-8b": (0.04, 0.95),
                "granite-moe-3b-a800m": (0.07, 0.90)}
# The one-device path is warmed up on this many tokens first; the sharded
# one is not (its first call's set-up is small beside its collectives).
SHARD_WARM_SEQ = 256
SHARD_SLOTS, SHARD_SERVER_MAX_SEQ = 8, 64
# [shard]'s two-lane group (the dense arch only): LMReplicaGroup(cfg,
# rules, params) over each rank's slices, requests (lane, prompt length,
# new tokens), lm1's decode faulting from its SHARD_LANE_FAULT_AFTER-th
# step on past its one restore, so that its flight migrates to lm0.
SHARD_LANE_REQUESTS = [("lm0", 2, 3), ("lm1", 2, 6)]
SHARD_LANE_FAULT_AFTER = 2
SHARD_REQUESTS = [(1, 2)] * 8
SHARD_TIMEOUT_S = 600
# [shard]'s data ranks: SHARD_DP_ARCH over (data, model) =
# SHARD_DP_MESH, the weights replicated over ``data`` (serving's rules,
# ``fsdp=None``, as the reference's decode cells take them): the same
# prefill of B LM_BATCH, one row a data rank, SHARD_DP_DECODE_STEPS of the
# teacher-forced decode steps against the one-device path within
# SHARD_LIMITS, the float32 check, an LMServer of SHARD_SLOTS slots
# (SHARD_SLOTS / 2 a data rank) answering SHARD_REQUESTS with the same
# tokens on every rank, and the two-lane group (one slot a data rank).
SHARD_DP_ARCH, SHARD_DP_MESH, SHARD_DP_DECODE_STEPS = "minitron-8b", (2, 2), 8
# The float32 step-0 check of [shard], [shard train] and [shard zoo]: both
# sides (the sharded path and the one-device path) with
# ``layers.COMPUTE_DTYPE`` float32, TF32 off for cuBLAS and cuDNN, and
# attention through K7's and K7b's plain versions (the kernels take bf16
# only); what is left between the two is float32 sums in other orders, so
# no bf16 rounding can flip.  Limits: logits (or a forward's output)
# within 1e-3 of max |one device| with argmax agreement >= 0.99, each
# gathered gradient leaf within 1e-3 relative L2, the loss within 1e-5
# relative.  [shard] runs it on the first SHARD_F32_SEQ tokens of the
# prompt and SHARD_F32_STEPS teacher-forced decode steps.  An MoE model's
# routing is pinned to the one-device run's top-k there (``moe_routing``:
# a near-tie that float32 sums in another order resolve the other way
# moves a token to another expert, a discontinuity, not a rounding), and
# the tokens whose own choice differed are printed.  The bf16 runs
# through K7/K7b and their limits stay as they are beside it.
F32_CHECK = dict(out=1e-3, agreement=0.99, leaf=1e-3, loss=1e-5)
F32_ROUTE = ("float32 compute, TF32 off, attention through the plain "
             "versions of K7/K7b")
SHARD_F32_SEQ, SHARD_F32_STEPS = 512, 4
# K4: the main path's shapes (batch 8 and 1), then every C kernel path
# (Cw 1-4 and above) at pixel counts that are no multiple of a block's
# 256 pixels.
K4_SHAPES = [(BATCH, 227, 227, 3), (1, 227, 227, 3), (2, 5, 7, 40)] + [
    (1, 37, 41, c) for c in (1, 8, 31, 32, 33, 64, 100, 200)] + [
    (3, 1, 1, 33), (2, 333, 1, 5)]
# Launches per forward on each serving path.
KERNEL_NAMES = ("bitplane_pack", "direct_conv_bn_binarize",
                "direct_conv_bn_binarize_planes",
                "fused_matmul_bn_binarize", "chain_conv",
                "xnor_popcount_matmul", "xnor_popcount_matmul_planes",
                "mxu_pm1_matmul", "flash_attention", "flash_attention_bwd")


def launch_counts(**kw) -> dict[str, int]:
    return {name: kw.get(name, 0) for name in KERNEL_NAMES}


# Each wrapper's device kernels, by a substring of the name torch.profiler
# gives them: how a replay, which calls no wrapper, is counted.
DEVICE_KERNELS = (
    ("bitplane_pack_kernel", "bitplane_pack"),
    ("conv_mma_kernel<true", "direct_conv_bn_binarize_planes"),
    ("conv_mma_kernel<false", "direct_conv_bn_binarize"),
    ("direct_conv_bn_binarize_kernel", "direct_conv_bn_binarize"),
    ("ThresholdPackEpilogue", "fused_matmul_bn_binarize"),
    ("fused_matmul_bn_binarize_kernel", "fused_matmul_bn_binarize"),
    ("chain_conv_kernel", "chain_conv"),
    ("gemm_mma_kernel<true", "xnor_popcount_matmul_planes"),
    ("gemm_mma_kernel<false", "xnor_popcount_matmul"),
    ("xnor_popcount_matmul_kernel", "xnor_popcount_matmul"),
    ("DotEpilogue", "mxu_pm1_matmul"),
    ("flash_fwd_kernel", "flash_attention"),
    ("flash_bwd_main_kernel", "flash_attention_bwd"),    # one of its two
)
# The serving buckets; each is captured once, on its first use.
BUCKETS = (1, 2, 4, 8)


# conv1 goes through a bit-plane variant on every path that has one.
WANT_LAUNCHES = {
    "cuda_direct_pool": launch_counts(bitplane_pack=1,
                                      direct_conv_bn_binarize_planes=1,
                                      direct_conv_bn_binarize=4,
                                      fused_matmul_bn_binarize=2),
    "cuda_chain": launch_counts(bitplane_pack=1, fused_matmul_bn_binarize=2,
                                chain_conv=1),
    "cuda_pm1": launch_counts(bitplane_pack=1, xnor_popcount_matmul_planes=1,
                              mxu_pm1_matmul=6),
}
WANT_DETECT = {
    "cuda_direct_pool": launch_counts(bitplane_pack=1,
                                      direct_conv_bn_binarize_planes=1,
                                      direct_conv_bn_binarize=7),
    "cuda_chain": launch_counts(bitplane_pack=1,
                                direct_conv_bn_binarize_planes=1,
                                chain_conv=2),
    "cuda_pm1": launch_counts(bitplane_pack=1, xnor_popcount_matmul_planes=1,
                              mxu_pm1_matmul=7),
    # K2 once a conv node of the executor (phase_detect counts them): 8,
    # conv1's bit planes on the weighted CUDA-core kernel, conv2-conv8 on
    # the tensor cores.
    "cuda_popcount": launch_counts(bitplane_pack=1,
                                   fused_matmul_bn_binarize=8),
}
# The trained path: the unfused graph, and its default pipeline under
# cuda_direct_pool (the pools stay separate OR-pools there).
WANT_TRAINED = {
    "unfused": launch_counts(bitplane_pack=1, xnor_popcount_matmul_planes=1,
                             xnor_popcount_matmul=6),
    "fused": launch_counts(bitplane_pack=1, direct_conv_bn_binarize_planes=1,
                           direct_conv_bn_binarize=4,
                           fused_matmul_bn_binarize=2),
}
# Every threshold-and-pack case must give a mix of output bits: a kernel
# that miscounts could otherwise still match on near-constant outputs.
SET_SHARE = (0.2, 0.8)
COUNT_SET_SHARE = (0.3, 0.7)

SOURCES = {
    "bitplane_pack": ("src/repro_torch/kernels/csrc/bitplane_pack.cu",
                      "src/repro/kernels/bitplane_pack.py:52"),
    "direct_conv_bn_binarize": (
        "src/repro_torch/kernels/csrc/direct_conv_bn_binarize.cu",
        "src/repro/kernels/direct_conv_bn_binarize.py:101"),
    "direct_conv_bn_binarize_planes": (
        "src/repro_torch/kernels/csrc/direct_conv_bn_binarize.cu",
        "src/repro/kernels/direct_conv_bn_binarize.py:101"),
    "fused_matmul_bn_binarize": (
        "src/repro_torch/kernels/csrc/fused_conv_bn_binarize.cu",
        "src/repro/kernels/fused_conv_bn_binarize.py:85"),
    "chain_conv": ("src/repro_torch/kernels/csrc/chain_conv.cu",
                   "src/repro/kernels/chain_conv.py:233"),
    "xnor_popcount_matmul": (
        "src/repro_torch/kernels/csrc/xnor_popcount_matmul.cu",
        "src/repro/kernels/xnor_popcount_matmul.py:134"),
    "xnor_popcount_matmul_planes": (
        "src/repro_torch/kernels/csrc/xnor_popcount_matmul.cu",
        "src/repro/kernels/xnor_popcount_matmul.py:134"),
    "mxu_pm1_matmul": ("src/repro_torch/kernels/csrc/mxu_pm1_matmul.cu",
                       "src/repro/kernels/mxu_pm1_matmul.py:56"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:138"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:151"),
}


def log(*a) -> None:
    print(*a, flush=True)


# --------------------------------------------------------------------------
# Inputs and bounds
# --------------------------------------------------------------------------

def word_bits(channels: int) -> list[int]:
    """Real (non-pad) bits in each packed word of ``channels`` channels."""
    return [min(32, channels - 32 * i)
            for i in range(packing.num_words(channels))]


class Inputs:
    """Seeded random kernel operands on one device."""

    def __init__(self, device, seed: int = 0):
        self.device = device
        self.g = torch.Generator(device=device).manual_seed(seed)

    def words(self, *shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                             device=self.device, generator=self.g)

    def channel_words(self, lead, channels: int):
        """(*lead, num_words(channels)) words of random bits, pad bits 0."""
        bits = torch.randint(0, 2, tuple(lead) + (channels,),
                             device=self.device, generator=self.g)
        return packing.pack_bits(bits, axis=-1)

    def epilogue(self, n: int, ww, bits, pool_positions: int = 1):
        """Thresholds and sign flips of ``n`` channels that give a mix of
        output bits.

        The count ``sum ww·popcount(a ^ b)`` over words of ``bits`` random
        real bits has mean ``sum ww·bits/2`` and variance
        ``sum ww²·bits/4``.  A pooled bit is the OR of ``pool_positions``
        conv bits, so each conv bit is centred on the probability q with
        ``1 - (1 - q)^P = 1/2``, and each channel's threshold is spread
        by one standard deviation around that centre."""
        ww, bits = ww.double(), bits.double()
        mean = float((ww * bits).sum()) / 2
        sd = float((ww * ww * bits).sum()) ** .5 / 2
        z = NormalDist().inv_cdf(1 - 0.5 ** (1 / pool_positions))
        sgn = torch.randint(0, 2, (n,), device=self.device,
                            generator=self.g).bool()
        jitter = torch.rand(n, device=self.device, generator=self.g,
                            dtype=torch.float64) * 2 - 1
        # bit = (cnt <= t) ^ s: P(cnt <= t) = q for s = 0, 1 - q for s = 1.
        centre = torch.where(sgn, -z, z)
        thr = torch.round(mean + sd * (centre + jitter)).to(torch.int32)
        return thr, sgn


def conv_case(inp: Inputs, case):
    """Operands and keyword arguments of one K3 call, and K_bits, the real
    input bits behind one conv output (for the bound)."""
    name, (n, h, w, c), k, st, pad, o, pool, first = case
    planes = 8 if first else 1
    x = inp.channel_words((n, h, w, planes), c).reshape(n, h, w, -1)
    wp = inp.channel_words((o, k * k, planes), c).reshape(o, -1)
    bits = torch.tensor(word_bits(c) * planes * k * k, device=inp.device)
    cw = x.shape[-1]
    ww = (bitplanes.plane_word_weights(cw // 8).repeat(k * k).to(inp.device)
          if first else None)
    thr, sgn = inp.epilogue(o, ww if first else torch.ones_like(bits), bits,
                            pool[0] ** 2 if pool else 1)
    kw = dict(kh=k, kw=k, stride=st, pad=pad, word_weights=ww, pool=pool)
    return (x, wp, thr, sgn), kw, int(bits.sum())


def plane_filters(inp: Inputs, o: int, taps: int, c: int):
    """Converter-structured first-layer filters: each tap's random sign
    words (pad bits 0) copied into all 8 planes, their plane word weights,
    and the u8 x s8 form the executor builds from them."""
    signs = inp.channel_words((o, taps), c)                # O, taps, Cw
    wp = signs[:, :, None].expand(-1, -1, 8, -1).reshape(o, -1).contiguous()
    ww = bitplanes.plane_word_weights(signs.shape[-1]).repeat(taps) \
        .to(inp.device)
    return wp, ww, bitplanes.plane_filters(wp, ww, taps)


def plane_input(inp: Inputs, n: int, h: int, w: int, c: int,
                pad_bits: bool):
    """A first layer's input: K4's planes of a random image, or random
    words with every pad bit random too."""
    if pad_bits:
        return inp.words(n, h, w, 8 * packing.num_words(c))
    img = torch.randint(0, 256, (n, h, w, c), dtype=torch.uint8,
                        device=inp.device, generator=inp.g)
    return k4.bitplane_pack(img).reshape(n, h, w, -1)


def plane_conv_case(inp: Inputs, case):
    """Operands of one call of K3's bit-plane variant, its keyword
    arguments, the weighted words it stands for (w_packed, word weights)
    and the input bytes behind one output (every bit position of each
    word: the kernel's multiply-adds, for the bound)."""
    name, (n, h, w, c), k, st, pad, o, pool, pad_bits = case
    x = plane_input(inp, n, h, w, c, pad_bits)
    wp, ww, filters = plane_filters(inp, o, k * k, c)
    cw = packing.num_words(c)
    bits = torch.tensor(([32] * cw if pad_bits else word_bits(c)) * 8
                        * k * k, device=inp.device)
    thr, sgn = inp.epilogue(o, ww, bits, pool[0] ** 2 if pool else 1)
    kw = dict(kh=k, kw=k, stride=st, pad=pad, pool=pool)
    return (x, filters, thr, sgn), kw, wp, ww, k * k * cw * 32


def plane_matmul_case(inp: Inputs, case, pad_bits: bool):
    """(a, filters, w_packed, word weights, real bits a word, Cw) of one
    call of K1's bit-plane variant: im2col rows of a first layer's
    input."""
    name, (n, h, w, c), k, st, pad, o = case
    x = plane_input(inp, n, h, w, c, pad_bits)
    a, _ = binary_conv.im2col_matmul(x, k, k, st, pad)
    wp, ww, filters = plane_filters(inp, o, k * k, c)
    cw = packing.num_words(c)
    bits = torch.tensor(([32] * cw if pad_bits else word_bits(c)) * 8
                        * k * k, device=inp.device)
    return a.contiguous(), filters, wp, ww, bits, cw


def dense_case(inp: Inputs, case):
    name, m, n, w = case
    a, b = inp.words(m, w), inp.words(n, w)
    ww = None
    if "weighted" in name:
        ww = torch.randint(1, 129, (w,), dtype=torch.int32,
                           device=inp.device, generator=inp.g)
    thr, sgn = inp.epilogue(
        n, ww if ww is not None else torch.ones(w, device=inp.device),
        torch.full((w,), 32, device=inp.device))
    return (a, b, thr, sgn, ww)


def check_share(name: str, out, channels: int,
                limits: tuple[float, float] = SET_SHARE) -> float:
    """Share of set bits over the real output channels of packed words;
    fails outside ``limits``."""
    share = packing.unpack_bits(out, channels).float().mean().item()
    if not limits[0] <= share <= limits[1]:
        raise AssertionError(f"[kernels] {name}: {share:.3f} of output bits "
                             f"set, outside {limits}")
    return share


def matmul_case(inp: Inputs, case):
    """(a, b, word weights or None, real bits per word) of one K1/K6 call:
    im2col rows of a random map against random filters; padded positions
    are 0-words, real inputs of the reference."""
    name, (n, h, w, c), k, st, pad, o, first = case
    planes = 8 if first else 1
    if k == 1 and c % 32 == 0:
        a = inp.words(n * h * w, c // 32)          # every bit real
    else:
        x = inp.channel_words((n, h, w, planes), c).reshape(n, h, w, -1)
        a, _ = binary_conv.im2col_matmul(x, k, k, st, pad)
    b = inp.channel_words((o, k * k, planes), c).reshape(o, -1)
    bits = torch.tensor(word_bits(c) * planes * k * k, device=inp.device)
    ww = (bitplanes.plane_word_weights(packing.num_words(c)).repeat(k * k)
          .to(inp.device) if first else None)
    return a.contiguous(), b, ww, bits


def count_share(inp: Inputs, name: str, cnt, ww, bits) -> float:
    """The threshold-and-pack that follows the counts on the main path, at
    thresholds centred on them: the share of set bits must lie inside
    ``COUNT_SET_SHARE``."""
    thr, sgn = inp.epilogue(cnt.shape[1], ww if ww is not None
                            else torch.ones_like(bits), bits)
    out = packing.pack_bits(layer_integration.apply_threshold(
        cnt, layer_integration.IntegratedParams(thr, sgn)), axis=-1)
    return check_share(name, out, cnt.shape[1], COUNT_SET_SHARE)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = INT8_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv_cost(args, kw, out, k_bits: int) -> tuple[float, float]:
    """Bytes each input read once + output written once; 2·M·N·K_bits ops
    over the conv positions (each counted once), K_bits the real input
    bits of one output: KH·KW·C, and KH·KW·8·C for a first layer."""
    x, wp, thr, sgn = args
    n, h, w, cw = x.shape
    o = wp.shape[0]
    oh = conv_out_size(h, kw["kh"], kw["stride"], kw["pad"])
    ow = conv_out_size(w, kw["kw"], kw["stride"], kw["pad"])
    nbytes = (x.numel() * 4 + wp.numel() * 4 + thr.numel() * 4 + sgn.numel()
              + out.numel() * 4
              + (kw["word_weights"].numel() * 4
                 if kw["word_weights"] is not None else 0))
    return nbytes, 2.0 * n * oh * ow * o * k_bits


def dense_cost(args, out) -> tuple[float, float]:
    a, b, thr, sgn, ww = args
    m, w = a.shape
    nbytes = (a.numel() + b.numel() + thr.numel() + out.numel()) * 4 \
        + sgn.numel() + (ww.numel() * 4 if ww is not None else 0)
    return nbytes, 2.0 * m * b.shape[0] * w * 32


def matmul_cost(a, b, out, bits, ww=None) -> tuple[float, float]:
    """Bytes of a, b (and word weights) read once and the int32 result
    written once; 2·M·N·K_bits operations over the real input bits."""
    nbytes = (a.numel() + b.numel() + out.numel()) * 4 + \
        (ww.numel() * 4 if ww is not None else 0)
    return nbytes, 2.0 * a.shape[0] * b.shape[0] * float(bits.sum())


def chain_case(inp: Inputs, case):
    """Entry, kernel-layout operands and arena keywords of one K5 call at
    the planner's offsets, and per conv stage (valid positions, O,
    K_bits) for the bound."""
    name, (n, h, w, c), stages, tile = case
    first = stages[0].first
    planes = 8 if first else 1
    x = inp.channel_words((n, h, w, planes), c).reshape(n, h, w, -1)
    arrays, convs, cin, hw = [], [], c, (h, w)
    for i, st in enumerate(stages):
        out_hw = (st.out_size(hw[0]), st.out_size(hw[1]))
        if st.kind == "conv":
            p = 8 if st.first else 1
            kk = st.kernel * st.kernel
            wp = inp.channel_words((st.channels, kk, p), cin).reshape(
                st.channels, -1)
            bits = torch.tensor(word_bits(cin) * p * kk, device=inp.device)
            ww = (bitplanes.plane_word_weights(packing.num_words(cin))
                  .repeat(kk).to(inp.device) if st.first else None)
            pooled = i + 1 < len(stages) and stages[i + 1].kind == "pool"
            thr, sgn = inp.epilogue(
                st.channels, ww if st.first else torch.ones_like(bits), bits,
                stages[i + 1].kernel ** 2 if pooled else 1)
            arrays += [wp, ww, thr, sgn]
            convs.append((n * out_hw[0] * out_hw[1], st.channels,
                          int(bits.sum())))
            cin = st.channels
        hw = out_hw
    ops = k5.chain_operands(stages, tuple(arrays))
    plan = regions.plan_chain_vmem(stages, tuple(x.shape), tile=tile)
    kw = dict(tile, arena_offsets=tuple(o // 4 for o in plan.offsets),
              arena_words=plan.arena_bytes // 4)
    return x, ops, kw, convs


def chain_cost(x, ops, out, convs) -> tuple[float, float]:
    """Entry, operands and output bytes once; 2·M·O·K_bits operations over
    each conv stage's valid positions (conv_cost's convention), not the
    halo-grown tiles the kernel computes."""
    nbytes = (x.numel() + out.numel()) * 4 + sum(
        t.numel() * 4 for group in (ops.w_t, ops.ww, ops.t, ops.s)
        for t in group if t is not None)
    return nbytes, sum(2.0 * m * o * k_bits for m, o, k_bits in convs)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def alexnet_arena_words() -> int:
    """Arena words of AlexNet's region at batch 8, whole-map tile."""
    plan = regions.plan_chain_vmem(ALEXNET_CHAIN, (BATCH, 227, 227, 8))
    return plan.arena_bytes // 4


def phase_build() -> str:
    t0 = time.perf_counter()
    path, secs = build.build(verbose=True)
    build.library()
    log(f"[build] {path.name}: "
        + (f"nvcc {secs:.3f} s" if secs else "already built")
        + f", loaded in {time.perf_counter() - t0:.3f} s")
    optin = k5.smem_optin(0)
    if regions.DEFAULT_SMEM_BUDGET != optin:
        raise AssertionError(f"[build] region budget "
                             f"{regions.DEFAULT_SMEM_BUDGET} B != the card's "
                             f"opt-in shared memory per block {optin} B")
    log(f"[build] region budget {regions.DEFAULT_SMEM_BUDGET} B == "
        f"cudaDevAttrMaxSharedMemoryPerBlockOptin")
    for hd in k7.KERNEL_HEAD_DIMS:
        info = k7.kernel_info(hd)
        log(f"[build] flash_attention at hd {hd}: {info['registers']} "
            f"registers a thread as compiled, {info['smem_bytes']} B of "
            f"shared memory a block, {info['threads']} threads a block")
        info = k7.kernel_info(hd, backward=True)
        log(f"[build] flash_attention_bwd's main kernel at hd {hd}: "
            f"{info['registers']} registers a thread as compiled, "
            f"{info['smem_bytes']} B of shared memory a block, "
            f"{info['threads']} threads a block, {info['local_bytes']} B of "
            f"local memory a thread")
        if info["local_bytes"]:
            raise AssertionError(f"[build] flash_attention_bwd at hd {hd} "
                                 f"spills: {info['local_bytes']} B of local "
                                 f"memory a thread")
    info = k5.kernel_info()
    words = alexnet_arena_words()
    active = {c: k5.max_clusters(words, c) for c in k5.CLUSTER_SIZES}
    log(f"[build] chain_conv: {info['registers']} registers a thread, "
        f"{info['threads']} threads a block; AlexNet's region ({4 * words} "
        f"B arena a block): clusters the card holds at once by size "
        f"{active}; the wrapper's cluster C = {k5.cluster_size(words, 1)} "
        f"for one image, {k5.cluster_size(words, BATCH)} for {BATCH} "
        f"(fewest waves a rank)")
    lim = k3.mma_limits(torch.device("cuda", 0))
    log(f"[build] direct_conv_bn_binarize tile planner: {lim.sms} SMs and "
        f"{lim.smem_block} B of shared memory a block, read from the card; "
        f"weights {dataclasses.asdict(k3.MMA_WEIGHTS)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return smi


def pm1_route(m: int, n: int, w: int) -> str:
    """The route ``plan_pm1`` gives K6 and K2 (unweighted) at (M, N, W)."""
    # Imported here, not at the top: tools/kernel_times.py runs this
    # script's timing phase on trees that predate the planner.
    from repro_torch.kernels import pm1_gemm
    plan = pm1_gemm.plan_pm1(m, n, w, build.sm_count(torch.device("cuda")))
    t = pm1_gemm.TILES[plan.tile]
    return (f"{'swapped' if t.swap else 'unswapped'} {t.bx}x{t.by} "
            f"{'wgmma' if t.wgmma else 'mma.sync'} tile, cluster "
            f"{plan.cluster}")


def check_equal(name: str, got, want) -> int:
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.long() - want.long()).abs().max().item() \
            if got.shape == want.shape else "shape"
        raise AssertionError(f"[kernels] {name}: kernel != plain ({diff})")
    return int((got.long() - want.long()).abs().max().item())


def phase_kernels(device) -> dict[str, int]:
    """Every kernel against its plain version on the card, bit-exact.
    Returns the max |kernel - plain| per kernel (0 when it passes)."""
    inp = Inputs(device, seed=1)
    err: dict[str, int] = {}

    def note(name: str, e: int) -> None:
        err[name] = max(err.get(name, 0), e)

    for shape in K4_SHAPES:
        # The whole tensor, and the same shape as a slice one image into a
        # larger one (its first byte off a 16-byte boundary when the image
        # is an odd number of bytes).
        big = torch.randint(0, 256, (shape[0] + 1,) + shape[1:],
                            dtype=torch.uint8, device=device,
                            generator=inp.g)
        for x in (big[:-1].contiguous(), big[1:]):
            note("bitplane_pack", check_equal(
                f"bitplane_pack {shape}", k4.bitplane_pack(x),
                k4.bitplane_pack_plain(x)))
        log(f"[kernels] bitplane_pack {shape}: exact, also from byte "
            f"offset {big[1:].data_ptr() % 16} of a 16-byte boundary")
    for case in ALEXNET_CONVS + CONV_EDGES:
        args, kw, _ = conv_case(inp, case)
        got = k3.direct_conv_bn_binarize(*args, **kw)
        want = k3.direct_conv_bn_binarize_plain(*args, **kw)
        note("direct_conv_bn_binarize", check_equal(case[0], got, want))
        share = check_share(case[0], got, case[5])
        log(f"[kernels] direct_conv_bn_binarize {case[0]} "
            f"x{tuple(args[0].shape)} -> {tuple(got.shape)}: exact, "
            f"{share:.3f} of output bits set")
    for case in PLANE_CONVS:
        args, kw, wp, ww, _ = plane_conv_case(inp, case)
        got = k3.direct_conv_bn_binarize_planes(*args, **kw)
        want = k3.direct_conv_bn_binarize_planes_plain(*args, **kw)
        note("direct_conv_bn_binarize_planes",
             check_equal(case[0], got, want))
        check_equal(f"{case[0]}, generic plain on the weighted words", got,
                    k3.direct_conv_bn_binarize_plain(
                        args[0], wp, args[2], args[3], word_weights=ww,
                        **kw))
        share = check_share(case[0], got, case[5])
        log(f"[kernels] direct_conv_bn_binarize_planes {case[0]} "
            f"x{tuple(args[0].shape)} -> {tuple(got.shape)}: exact (and == "
            f"the generic plain version), {share:.3f} of output bits set")
    for case in ALEXNET_DENSE + DENSE_EDGES:
        args = dense_case(inp, case)
        got = k2.fused_matmul_bn_binarize(*args)
        want = k2.fused_matmul_bn_binarize_plain(*args)
        note("fused_matmul_bn_binarize", check_equal(case[0], got, want))
        share = check_share(case[0], got, case[2])
        log(f"[kernels] fused_matmul_bn_binarize {case[0]} "
            f"a{tuple(args[0].shape)} b{tuple(args[1].shape)} ("
            + ("weighted CUDA-core kernel" if args[4] is not None
               else pm1_route(*case[1:])) + f"): exact, "
            f"{share:.3f} of output bits set")
    for case in CHAIN_CASES:
        x, ops, kw, _ = chain_case(inp, case)
        got = k5.chain_conv(x, case[2], ops, **kw)
        want = k5.chain_conv_plain(x, case[2], ops, **kw)
        note("chain_conv", check_equal(case[0], got, want))
        share = check_share(case[0], got, case[2][-1].channels)
        log(f"[kernels] chain_conv {case[0]} x{tuple(x.shape)} -> "
            f"{tuple(got.shape)}, {len(case[2])} stages, arena "
            f"{4 * kw['arena_words']} B: exact, {share:.3f} of output bits "
            f"set")
    check_count_kernels(inp, note)
    check_flash(inp, note)
    torch.cuda.synchronize()
    return err


def check_count_kernels(inp: Inputs, note) -> None:
    """K1 and K6 against their plain versions at ``K1_CASES`` and
    ``K6_CASES``, bit-exact; ``note(name, max |kernel - plain|)``."""
    for case in K1_CASES:
        a, b, ww, bits = matmul_case(inp, case)
        got = k1.xnor_popcount_matmul(a, b, ww)
        note("xnor_popcount_matmul", check_equal(
            case[0], got, k1.xnor_popcount_matmul_plain(a, b, ww)))
        share = count_share(inp, case[0], got, ww, bits)
        log(f"[kernels] xnor_popcount_matmul {case[0]} a{tuple(a.shape)} "
            f"b{tuple(b.shape)}"
            + (" weighted" if ww is not None else "")
            + f": exact, {share:.3f} of thresholded bits set")
    for case, pad_bits in zip(PLANE_MATMULS, (False, True)):
        a, filters, wp, ww, bits, cw = plane_matmul_case(inp, case, pad_bits)
        got = k1.xnor_popcount_matmul_planes(a, filters, cw)
        note("xnor_popcount_matmul_planes", check_equal(
            case[0], got,
            k1.xnor_popcount_matmul_planes_plain(a, filters, cw)))
        check_equal(f"{case[0]}, generic plain on the weighted words", got,
                    k1.xnor_popcount_matmul_plain(a, wp, ww))
        share = count_share(inp, case[0], got, ww, bits)
        log(f"[kernels] xnor_popcount_matmul_planes {case[0]} "
            f"a{tuple(a.shape)} signs{tuple(filters.signs.shape)}"
            + (", input pad bits set" if pad_bits else "")
            + f": exact (and == the generic plain version), {share:.3f} of "
            f"thresholded bits set")
    for case in K6_CASES:
        a, b, _, bits = matmul_case(inp, case)
        k_valid = int(bits.sum())
        got = k6.mxu_pm1_matmul(a, b, k_valid)
        note("mxu_pm1_matmul", check_equal(
            case[0], got, k6.mxu_pm1_matmul_plain(a, b, k_valid)))
        share = count_share(inp, case[0], (k_valid - got) // 2, None, bits)
        log(f"[kernels] mxu_pm1_matmul {case[0]} a{tuple(a.shape)} "
            f"b{tuple(b.shape)} k_valid {k_valid} ("
            f"{pm1_route(a.shape[0], b.shape[0], a.shape[1])}): exact, "
            f"{share:.3f} of thresholded bits set")


def flash_inputs(inp: Inputs, case):
    """Seeded N(0, 1) bf16 q, k, v of one K7 case on the card."""
    _, b, sq, skv, h, kvh, hd, _ = case
    return tuple(torch.randn(shape, device=inp.device, generator=inp.g)
                 .to(torch.bfloat16)
                 for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                               (b, skv, kvh, hd)))


def flash_error(name: str, got, want) -> float:
    """max |got - want|; fails past ``FLASH_TOL``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"[kernels] {name}: bad output")
    diff = (got - want).abs()
    if (diff > FLASH_TOL * (1 + want.abs())).any():
        raise AssertionError(f"[kernels] {name}: max |kernel - plain| "
                             f"{diff.max().item():.3e} past {FLASH_TOL} · "
                             f"(1 + |plain|)")
    return diff.max().item()


def check_flash(inp: Inputs, note) -> None:
    """K7 against its plain version at ``FLASH_CASES``; float32 inputs
    are refused, not run."""
    for case in FLASH_CASES:
        q, k, v = flash_inputs(inp, case)
        causal = case[7]
        err = flash_error(case[0], k7.flash_attention(q, k, v, causal),
                          k7.flash_attention_plain(q, k, v, causal,
                                                   *plain_blocks(case)))
        note("flash_attention", err)
        log(f"[kernels] flash_attention {case[0]} q{tuple(q.shape)} "
            f"k{tuple(k.shape)} {'causal' if causal else 'non-causal'} "
            f"bf16: max |kernel - plain| {err:.3e} (tolerance {FLASH_TOL} "
            f"· (1 + |plain|))")
    q = q.float()
    try:
        k7.flash_attention(q, q, q)
    except ValueError as e:
        log(f"[kernels] flash_attention float32: refused ({e})")
    else:
        raise AssertionError("[kernels] flash_attention took float32")


WRAPPERS = {"bitplane_pack": k4.bitplane_pack,
            "direct_conv_bn_binarize": k3.direct_conv_bn_binarize,
            "direct_conv_bn_binarize_planes":
                k3.direct_conv_bn_binarize_planes,
            "xnor_popcount_matmul_planes": k1.xnor_popcount_matmul_planes,
            "fused_matmul_bn_binarize": k2.fused_matmul_bn_binarize,
            "chain_conv": k5.chain_conv,
            "xnor_popcount_matmul": k1.xnor_popcount_matmul,
            "mxu_pm1_matmul": k6.mxu_pm1_matmul,
            "flash_attention": k7.flash_attention,
            "flash_attention_bwd": k7.flash_attention_bwd}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def capture_calls() -> int:
    """Calls of a bucket's forward while it is captured: the warm-up
    calls and the captured one.  Each runs every wrapper of the forward
    once; a replay runs none.  (Imported here, not at the top:
    tools/kernel_times.py imports this script against trees whose
    executor predates capture.)"""
    from repro_torch.runtime.executor import WARMUP_CALLS
    return WARMUP_CALLS + 1


def device_launches(prof) -> dict[str, int]:
    """Launches of each wrapper's kernels in a profiler session's kept
    step, matched by ``DEVICE_KERNELS``: how replays, which call no
    wrapper, are counted."""
    counts = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        for part, name in DEVICE_KERNELS:
            if part in e.key:
                counts[name] += e.count
                break
    return launch_counts(**counts)


def scaled(counts: dict[str, int], n: int) -> dict[str, int]:
    return {k: v * n for k, v in counts.items()}


def check_healthy(tag: str, m: dict, base: str) -> None:
    """A server that ran with no fault plan installed: no retry, no
    demotion, every bucket's ladder at the base mode."""
    modes = {b: h["mode"] for b, h in m.get("bucket_health", {}).items()}
    if m["retries"] or m["degraded"] or m["mode"] != base \
            or any(mode != base for mode in modes.values()):
        raise AssertionError(f"[{tag}] with no fault plan: retries "
                             f"{m['retries']}, degraded {m['degraded']}, "
                             f"mode {m['mode']}, buckets {modes}")


# Replays of a captured bucket traced to count its kernels.
REPLAYS = 10


def replay_launches(exe) -> dict[str, int]:
    """Launches of each wrapper's kernels in ``REPLAYS`` replays of a
    captured bucket, from a torch.profiler trace."""
    return device_launches(profiled(
        lambda: [exe.replay() for _ in range(REPLAYS)]))


def check_captured(wl, x: torch.Tensor, tag: str) -> None:
    """The workload's captured bucket on ``x``: its raw output equals the
    eager executor's, and its rows the eager head's on it, bit for bit."""
    exe = wl.engine.compile(x.shape[0])
    rows, raw = exe.run(x)
    eager = wl.engine.engine.compile(x.shape[0], capture=False)(x)
    if not torch.equal(raw, eager) \
            or not torch.equal(rows, wl.postprocess(eager)):
        raise AssertionError(f"[{tag}] bucket {x.shape[0]}: captured "
                             f"output != the eager executor's")


def steady_run(wl, frames, capture) -> dict:
    """64 network-size images through a fresh server at bucket 8 (the
    buckets already built): served/s, p50, p95."""
    server = wl.server(max_batch=8, buckets=BUCKETS, capture=capture)
    builds = wl.engine.build_count
    torch.cuda.synchronize()
    for im in frames:
        server.submit(im)
    server.drain()
    m = server.metrics()
    if m["served"] != len(frames) or wl.engine.build_count != builds:
        raise AssertionError("[serve] steady run failed")
    check_healthy("serve", m, wl.matmul_mode)
    return dict(served_per_s=m["throughput"], p50_ms=m["p50_ms"],
                p95_ms=m["p95_ms"])


def phase_serve(rng: np.random.Generator, mode: str):
    """AlexNet behind InferenceServer on one serving path, each bucket
    captured.  The executors are built (and under cuda_chain their region
    tiles tuned) first; the main path's run — the server's boot, which
    captures every bucket, and the mixed traffic — is counted from there.
    Returns (the workload, launches in the run, launches per forward,
    serving numbers)."""
    t0 = time.perf_counter()
    wl = workloads.get("alexnet_imagenet", seed=0, matmul_mode=mode)
    for b in BUCKETS:
        wl.engine.engine.compile(b, capture=False)
    setup_s = time.perf_counter() - t0
    sizes = [(240, 320), (300, 300), (227, 227), (480, 360), (256, 341)]
    groups = [1, 2, 3, 5, 7]          # buckets 1, 2, 4, 8, 8
    imgs = [rng.integers(0, 256, (*sizes[i % len(sizes)], 3), dtype=np.uint8)
            for i in range(sum(groups))]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    server = wl.server(max_batch=8, buckets=BUCKETS)
    timings = server.compile_buckets()
    booted = read_launches()
    builds, captures = wl.engine.build_count, wl.engine.capture_count
    record: list[tuple[list, list]] = []

    def traffic():
        served = 0
        for g in groups:
            batch = imgs[served:served + g]
            reqs = [server.submit(im) for im in batch]
            server.drain()
            served += g
            bucket = server.scheduler.bucket_for(g)
            record.append((reqs, batch + [np.zeros_like(batch[-1])]
                           * (bucket - g)))

    def rehearse():
        # The profiler's dropped step: the traffic's replays, unserved.
        for g in groups:
            wl.engine.compile(server.scheduler.bucket_for(g)).replay()

    # The traffic, traced: its replays call no wrapper, so the profiler
    # counts the kernels they launch.
    replayed = device_launches(profiled(traffic, first=rehearse))
    torch.cuda.synchronize()
    counted = read_launches()
    peak = torch.cuda.max_memory_allocated()
    metrics = server.metrics()
    capture_s = {b: wl.engine.compile(b).capture_s for b in BUCKETS}
    log(f"[serve] alexnet_imagenet paper on {wl.engine.device} "
        f"({wl.matmul_mode}), model {wl.model_bytes} B, executors built in "
        f"{setup_s:.3f} s; boot (capture + first run) a bucket "
        + ", ".join(f"{b}: {s * 1e3:.1f} ms" for b, s in timings.items())
        + ", capture alone "
        + ", ".join(f"{b}: {s * 1e3:.1f} ms" for b, s in capture_s.items()))

    if not all(r.done and r.outcome == "served" for reqs, _ in record
               for r in reqs):
        raise AssertionError("[serve] a request was not served")
    if metrics["served"] != len(imgs):
        raise AssertionError(f"[serve] served {metrics['served']} of "
                             f"{len(imgs)}")
    check_healthy("serve", metrics, mode)
    if captures != len(BUCKETS) or (wl.engine.build_count,
                                    wl.engine.capture_count) \
            != (builds, captures):
        raise AssertionError(f"[serve] {captures} captures; build_count or "
                             f"capture_count moved while serving")
    # The boot captured every bucket, each capture calling the forward
    # capture_calls() times; the traffic replayed one forward a group and
    # called no wrapper.
    calls = capture_calls() * len(BUCKETS)
    want = WANT_LAUNCHES[mode]
    if booted != scaled(want, calls) or counted != booted:
        raise AssertionError(f"[serve] wrapper launches over the boot "
                             f"{booted}, after the traffic {counted}; want "
                             f"{calls} x {want} for both")
    if replayed != scaled(want, len(groups)):
        raise AssertionError(f"[serve] the traffic's {len(groups)} replays "
                             f"launched {replayed}, want {len(groups)} x "
                             f"{want}")
    launches = {k: booted[k] + replayed[k] for k in booted}
    per_forward = {k: v / calls for k, v in booted.items()}
    for reqs, padded in record:
        x = torch.stack([wl.preprocess_hook(p) for p in padded])
        ref = wl.engine.cross_check(x).cpu().numpy()
        for r, expect in zip(reqs, ref):
            if not np.array_equal(r.result, expect):
                raise AssertionError("[serve] served row != cross_check")
        if not np.isfinite(ref).all() or ref.shape[1:] != (5, 2):
            raise AssertionError(f"[serve] bad rows {ref.shape}")
        check_captured(wl, x, "serve")
    log(f"[serve] {mode}: {len(imgs)} requests in groups {groups} through "
        f"captured buckets "
        f"{sorted({server.scheduler.bucket_for(g) for g in groups})}: all "
        f"served, each row == cross_check (the graph's raw output == the "
        f"flat oracle) and the captured output == the eager executor's; "
        f"build_count flat at {builds}, capture_count at {captures}; "
        f"wrapper launches over the boot {booted} = {calls} captured "
        f"forwards x WANT_LAUNCHES, none in the traffic; the traffic's "
        f"traced replays launched {replayed} = {len(groups)} x "
        f"WANT_LAUNCHES")
    log(f"[serve] {mode} mixed run (traced by the profiler): served/s "
        f"{metrics['throughput']:.3f}, p50 {metrics['p50_ms']:.3f} ms, p95 "
        f"{metrics['p95_ms']:.3f} ms, peak device memory {peak} B")

    # Steady traffic: 64 network-size images, 8 full batches, eager then
    # captured.
    frames = [rng.integers(0, 256, (227, 227, 3), dtype=np.uint8)
              for _ in range(64)]
    steady = {label: steady_run(wl, frames, capture)
              for label, capture in (("eager", False), ("captured", None))}
    for label, sm in steady.items():
        log(f"[serve] {mode} steady run, {label}, 64 requests of 227x227 at "
            f"bucket 8: served/s {sm['served_per_s']:.3f}, p50 "
            f"{sm['p50_ms']:.3f} ms, p95 {sm['p95_ms']:.3f} ms")
    # The server's hook copies each image to the card and resizes it
    # there; this is the wall time per image of that work alone.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for im in frames:
        wl.preprocess_hook(im)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    log(f"[serve] preprocess alone (copy + resize on the card), 227x227 "
        f"image: {pre_ms:.4f} ms per image")
    numbers = dict(mixed=dict(served_per_s=metrics["throughput"],
                              p50_ms=metrics["p50_ms"],
                              p95_ms=metrics["p95_ms"],
                              peak_bytes=peak),
                   steady=dict(steady["captured"], preprocess_ms=pre_ms),
                   steady_eager=steady["eager"],
                   capture_ms={b: t * 1e3 for b, t in capture_s.items()})
    return wl, launches, per_forward, numbers


def profile_forward(fn, x: torch.Tensor, reps: int = 20) -> dict:
    """Host wall a call of ``fn`` (no profiler), device time by kernel and
    the busy share (torch.profiler over the same calls), and the peak
    device memory while it runs."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    prof = profiled(lambda: [fn(x) for _ in range(reps)])
    rows = device_time_by_kernel(prof, reps)
    device_ms = sum(r[0] for r in rows)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, peak_bytes=peak,
                rows=[dict(ms=ms, per_forward=n, kernel=key[:90])
                      for ms, n, key in rows])


def phase_profile(wl) -> dict:
    """Where one forward of the workload and its head at bucket 8 on its
    serving path spend their time, eager (the frozen executor
    and the head, launch by launch) then captured (one replay, the copy
    into the static input and of the rows out included) where the tree
    captures: host wall per forward, device time per kernel, busy share,
    peak device memory."""
    eng = wl.engine.engine
    x = torch.randint(0, 256, (BATCH, *wl.input_hw, 3), dtype=torch.uint8,
                      device=eng.device)
    forms = {"eager": wl.engine.compile(BATCH, capture=False),
             "captured": wl.engine.compile(BATCH)}
    out = {}
    for label, fn in forms.items():
        out[label] = r = profile_forward(fn, x)
        log(f"[profile] {wl.matmul_mode} {wl.name} forward + head at batch "
            f"{BATCH}, {label}: host wall {r['wall_ms']:.4f} ms/forward (no "
            f"profiler), device {r['device_ms']:.4f} ms/forward, busy share "
            f"{r['busy_share']:.3f}, peak device memory {r['peak_bytes']} B")
        for row in r["rows"]:
            log(f"[profile]   {row['ms']:.4f} ms  x{row['per_forward']:g}  "
                f"{row['kernel']}")
    return out


def phase_detect(images: list[np.ndarray], mode: str):
    """YOLOv2-Tiny on one serving path; returns its detection rows (every
    path gets the same images, and main() holds the rows equal) and the
    workload."""
    wl = workloads.get("yolov2_tiny_voc", seed=0, matmul_mode=mode)
    x = torch.stack([wl.preprocess_hook(im) for im in images])
    # Built first: under cuda_chain the build times each region's tiles,
    # launches that are not the forward's.
    wl.engine.engine.compile(x.shape[0], capture=False)
    reset_launches()
    rows = wl.engine(x)                  # captures the bucket, then replays
    torch.cuda.synchronize()
    counted = read_launches()
    launches = WANT_DETECT[mode]
    ref = wl.engine.cross_check(x)
    if not torch.equal(rows, ref) or rows.shape != (2, 16, 6) \
            or not torch.isfinite(rows).all():
        raise AssertionError("[detect] yolov2_tiny_voc rows disagree")
    if counted != scaled(launches, capture_calls()):
        raise AssertionError(f"[detect] {mode} launches {counted} over "
                             f"{capture_calls()} captured forwards")
    replayed = replay_launches(wl.engine.compile(x.shape[0]))
    if replayed != scaled(launches, REPLAYS):
        raise AssertionError(f"[detect] {mode} {REPLAYS} replays launched "
                             f"{replayed}")
    check_captured(wl, x, "detect")
    if mode == "cuda_popcount":
        convs = [r for r in wl.engine.engine.backend_choices
                 if r["op"] in ("packed_conv", "packed_conv_pool")
                 and r["backend"] == mode]
        if len(convs) != launches["fused_matmul_bn_binarize"]:
            raise AssertionError(f"[detect] {len(convs)} conv nodes on "
                                 f"{mode}, K2 launches {launches}")
    log(f"[detect] {mode} yolov2_tiny_voc 416x416 batch 2, captured: rows "
        f"{tuple(rows.shape)}"
        f" == cross_check and == the eager executor's, "
        f"{int((rows[..., 4] > 0).sum())} detections, launches a forward "
        f"{launches} (counted over the capture, and in the profile of "
        f"{REPLAYS} replays)")
    return rows, wl


def phase_multiplex(rng: np.random.Generator) -> dict:
    """Paper AlexNet and YOLOv2-Tiny as two lanes of one
    ``MultiTenantServer`` at weights 3:1, both saturated, bucket 8: over
    the first 8 ticks the lanes dispatch device rows 3:1 (48 and 16), and
    every served row equals its lane's ``cross_check`` on the same batch.
    Returns the split and each lane's metrics."""
    from repro_torch.serving import MultiTenantServer
    wls = {"alexnet": workloads.get("alexnet_imagenet", seed=0),
           "yolov2_tiny": workloads.get("yolov2_tiny_voc", seed=0)}
    mux = MultiTenantServer(max_batch=BATCH, buckets=(BATCH,))
    for t, weight in (("alexnet", 3.0), ("yolov2_tiny", 1.0)):
        mux.add_workload(t, wls[t], weight=weight)
        mux.server(t).compile_buckets()
    sizes = {"alexnet": (240, 320), "yolov2_tiny": (375, 500)}
    imgs = {t: [rng.integers(0, 256, sizes[t] + (3,), dtype=np.uint8)
                for _ in range(n)]
            for t, n in (("alexnet", 48), ("yolov2_tiny", 16))}
    reqs = {t: [mux.submit(t, im) for im in imgs[t]] for t in wls}
    t0 = time.perf_counter()
    order = []
    for _ in range(8):
        mux.step(force=True)
        order.append(tuple(mux.server(t).dispatched_rows for t in wls))
    split = {t: mux.server(t).dispatched_rows for t in wls}
    mux.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if split != {"alexnet": 48, "yolov2_tiny": 16}:
        raise AssertionError(f"[multiplex] rows after 8 ticks {split}, "
                             f"want 48:16")
    for t, wl in wls.items():
        if not all(r.outcome == "served" for r in reqs[t]):
            raise AssertionError(f"[multiplex] {t}: a request was not "
                                 f"served")
        for k in range(0, len(imgs[t]), BATCH):
            x = torch.stack([wl.preprocess_hook(im)
                             for im in imgs[t][k:k + BATCH]])
            ref = wl.engine.cross_check(x).cpu().numpy()
            for r, want in zip(reqs[t][k:k + BATCH], ref):
                if not np.array_equal(r.result, want):
                    raise AssertionError(f"[multiplex] {t}: served row != "
                                         f"cross_check")
    m = mux.metrics()
    for t, tm in m["tenants"].items():
        check_healthy("multiplex", tm, wls[t].matmul_mode)
    log(f"[multiplex] alexnet (weight 3) and yolov2_tiny (weight 1), "
        f"saturated, bucket {BATCH}: device rows after each of 8 ticks "
        f"{order}; split {split} (3:1); all {sum(map(len, reqs.values()))} "
        f"rows == their lane's cross_check; drained in {wall_s:.3f} s")
    for t, tm in m["tenants"].items():
        log(f"[multiplex] {t}: served {tm['served']}, served/s "
            f"{tm['throughput']:.3f}, p50 {tm['p50_ms']:.3f} ms, p95 "
            f"{tm['p95_ms']:.3f} ms, vtime {m['fairness'][t]['vtime']}")
    return dict(split=split, order=order, wall_s=wall_s,
                tenants={t: {k: tm[k] for k in ("served", "throughput",
                                                "p50_ms", "p95_ms")}
                         for t, tm in m["tenants"].items()})


# The [placement] phase: paper AlexNet pipelined over two stages of the
# one card on these paths; YOLOv2-Tiny (416²) and VGG16 (224²) pipelined
# under cuda_direct_pool as (name, stages, bucket); the replica group's
# traffic in groups (64 requests); the distinct images of the timed
# windows, cycled to RATE_REQUESTS a run (a window of seconds, not of a
# few batches) for the sync/async comparison and half that for the
# replica group.
PLACEMENT_PATHS = ("cuda_direct_pool", "cuda_chain", "cuda_pm1")
PLACEMENT_NETS = (("yolov2_tiny_voc", 3, 2), ("vgg16_imagenet", 4, 1))
REPLICA_GROUPS = (1, 2, 3, 5, 7, 8, 6, 4, 8, 8, 5, 7)
RATE_FRAMES = 64
RATE_REQUESTS = 4096
# The kernels of the pipelined paths (K1 through its bit-plane variant).
PLACEMENT_KERNELS = sorted({k for m in PLACEMENT_PATHS
                            for k, n in WANT_LAUNCHES[m].items() if n})


def padded_rows(wl, payloads: list, bucket: int) -> torch.Tensor:
    """A served batch as the server staged it: each payload through the
    preprocess hook, zero images (``_zero_like`` of the last) up to the
    bucket."""
    padded = payloads + [np.zeros_like(payloads[-1])] * (bucket
                                                         - len(payloads))
    return torch.stack([wl.preprocess_hook(p) for p in padded])


def check_rows(tag: str, wl, batches) -> None:
    """Each (requests, payloads, bucket) batch: every served row equals
    ``cross_check`` on the same padded batch (the single-device captured
    graph's raw output == the flat oracle)."""
    for reqs, payloads, bucket in batches:
        x = padded_rows(wl, payloads, bucket)
        ref = wl.engine.cross_check(x).cpu().numpy()
        for r, want in zip(reqs, ref):
            if r.outcome != "served" or not np.array_equal(r.result, want):
                raise AssertionError(f"[placement] {tag}: served row != "
                                     f"the single-device cross_check")


def check_staged_raw(tag: str, wl, x: torch.Tensor, stages) -> list[dict]:
    """The pipelined bucket's raw output and rows on ``x`` equal the
    single-device captured bucket's bit for bit; returns its stage
    report."""
    staged = wl.engine.compile(x.shape[0], pipeline=stages)
    single = wl.engine.compile(x.shape[0])
    got, want = staged.run(x), single.run(x)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"[placement] {tag} bucket {x.shape[0]}: the "
                             f"staged graphs' output != the single-device "
                             f"graph's")
    return staged.executor.stage_report()


def log_stages(tag: str, report: list[dict]) -> None:
    log(f"[placement] {tag} stages: " + "; ".join(
        f"{r['stage']}: nodes {r['nodes'][0]}-{r['nodes'][-1]} cost "
        f"{r['cost']:.4g} (share {r['share']}) boundary {r['boundary']}"
        for r in report))


def pipelined_alexnet(rng, device, mode: str) -> tuple[dict, dict]:
    """Paper AlexNet behind ``InferenceServer(placement=Pipelined((cuda:0,
    cuda:0)))`` under ``mode``: the executors (single and staged) are built
    first; then the counted run — the boot, which captures each bucket as
    one graph a stage, and mixed traffic; the wrappers count the boot's
    forwards times ``WANT_LAUNCHES`` summed over the stages, the traffic
    none, and the traffic's traced replays launch its groups times
    ``WANT_LAUNCHES``.  Rows equal the single-device ``cross_check``; the
    staged graphs' output equals the single-device graph's."""
    from repro_torch.distributed import Pipelined

    stages = (device, device)
    wl = workloads.get("alexnet_imagenet", seed=0, matmul_mode=mode)
    for b in BUCKETS:
        wl.engine.engine.compile(b, capture=False)
        wl.engine.engine.compile(b, pipeline=stages, capture=False)
    sizes = [(240, 320), (300, 300), (227, 227), (480, 360), (256, 341)]
    groups = [1, 2, 3, 5, 7]
    imgs = [rng.integers(0, 256, (*sizes[i % len(sizes)], 3), dtype=np.uint8)
            for i in range(sum(groups))]
    torch.cuda.synchronize()
    reset_launches()
    server = wl.server(max_batch=8, buckets=BUCKETS,
                       placement=Pipelined(stages))
    timings = server.compile_buckets()
    booted = read_launches()
    builds, captures = wl.engine.build_count, wl.engine.capture_count
    batches = []

    def traffic():
        served = 0
        for g in groups:
            batch = imgs[served:served + g]
            reqs = [server.submit(im) for im in batch]
            server.drain()
            served += g
            batches.append((reqs, batch, server.scheduler.bucket_for(g)))

    def rehearse():
        for g in groups:
            wl.engine.compile(server.scheduler.bucket_for(g),
                              pipeline=stages).replay()

    t0 = time.perf_counter()
    replayed = device_launches(profiled(traffic, first=rehearse))
    torch.cuda.synchronize()
    counted = read_launches()
    wall_s = time.perf_counter() - t0
    m = server.metrics()
    calls = capture_calls() * len(BUCKETS)
    want = WANT_LAUNCHES[mode]
    staged = wl.engine.compile(8, pipeline=stages)
    n_stages, graphs = staged.executor.plan.n_stages, staged.n_graphs
    if booted != scaled(want, calls) or counted != booted:
        raise AssertionError(f"[placement] {mode}: wrapper launches over "
                             f"the boot {booted}, after the traffic "
                             f"{counted}; want {calls} x {want} (summed "
                             f"over the stages) for both")
    if replayed != scaled(want, len(groups)):
        raise AssertionError(f"[placement] {mode}: the traffic's "
                             f"{len(groups)} staged replays launched "
                             f"{replayed}, want {len(groups)} x {want}")
    if n_stages != 2 or captures != graphs * len(BUCKETS) \
            or (wl.engine.build_count, wl.engine.capture_count) \
            != (builds, captures):
        raise AssertionError(f"[placement] {mode}: {n_stages} stages, "
                             f"{captures} captures; or a build while "
                             f"serving")
    if m["served"] != len(imgs) or m["placement"]["kind"] != "pipeline":
        raise AssertionError(f"[placement] {mode}: {m}")
    check_healthy("placement", m, mode)
    check_rows(f"alexnet {mode}", wl, batches)
    x = padded_rows(wl, imgs[:8], 8)
    report = check_staged_raw(f"alexnet {mode}", wl, x, stages)
    log_stages(f"alexnet 227² {mode}", report)
    log(f"[placement] alexnet {mode}, Pipelined((cuda:0, cuda:0)): "
        f"{len(imgs)} requests in groups {groups}, every row == the "
        f"single-device cross_check and the staged graphs' output == the "
        f"single-device graph's bit for bit; {captures} graphs ({graphs} a "
        f"bucket, {len(BUCKETS)} buckets), build_count flat at {builds}; "
        f"wrapper "
        f"launches over the boot {booted} = {calls} forwards x "
        f"WANT_LAUNCHES summed over the stages, the traffic's traced "
        f"replays {replayed} = {len(groups)} x WANT_LAUNCHES; boot a bucket "
        + ", ".join(f"{b}: {s * 1e3:.1f} ms" for b, s in timings.items())
        + f"; traffic (profiled) {wall_s:.3f} s, served/s "
        f"{m['throughput']:.3f}")
    launches = {k: booted[k] + replayed[k] for k in booted}
    return launches, dict(stages=report, served_per_s=m["throughput"],
                          p50_ms=m["p50_ms"], p95_ms=m["p95_ms"])


def pipelined_net(rng, device, name: str, n_stages: int,
                  bucket: int) -> tuple[dict, dict, dict]:
    """``name`` at its paper size under cuda_direct_pool, pipelined over
    ``n_stages`` stages of the card, serving one bucket of images: the
    launches over the boot summed over the stages equal the single-device
    bucket's capture's, the rows equal the single-device cross_check and
    the staged output the single-device graph's.  Returns (launches,
    launches a forward, numbers)."""
    from repro_torch.distributed import Pipelined

    stages = (device,) * n_stages
    wl = workloads.get(name, seed=0)
    wl.engine.engine.compile(bucket, pipeline=stages, capture=False)
    wl.engine.engine.compile(bucket, capture=False)
    h, w = wl.input_hw
    imgs = [rng.integers(0, 256, (h + 31 * i, w - 17 * i, 3),
                         dtype=np.uint8) for i in range(bucket)]
    torch.cuda.synchronize()
    reset_launches()
    server = wl.server(max_batch=bucket, buckets=(bucket,),
                       placement=Pipelined(stages))
    server.compile_buckets()
    booted = read_launches()
    builds = wl.engine.build_count
    reqs = [server.submit(im) for im in imgs]
    server.drain()
    torch.cuda.synchronize()
    counted = read_launches()
    m = server.metrics()
    reset_launches()
    wl.engine.compile(bucket)               # the single-device capture
    single = read_launches()
    exe = wl.engine.compile(bucket, pipeline=stages)
    if booted != single or counted != booted or not any(booted.values()):
        raise AssertionError(f"[placement] {name}: launches over the "
                             f"staged boot {booted} (after the traffic "
                             f"{counted}) != the single-device capture's "
                             f"{single}")
    if exe.executor.plan.n_stages != n_stages \
            or wl.engine.build_count != builds + 1 or m["served"] != bucket:
        raise AssertionError(f"[placement] {name}: "
                             f"{exe.executor.plan.n_stages} stages, "
                             f"build_count {wl.engine.build_count} after "
                             f"{builds} (+1: the single-device capture), "
                             f"{m}")
    check_healthy("placement", m, wl.matmul_mode)
    check_rows(name, wl, [(reqs, imgs, bucket)])
    report = check_staged_raw(name, wl, padded_rows(wl, imgs, bucket),
                              stages)
    log_stages(f"{name} {h}x{w}", report)
    calls = capture_calls()
    per_forward = {k: v // calls for k, v in booted.items()}
    log(f"[placement] {name} {h}x{w}, {n_stages} stages of cuda:0, bucket "
        f"{bucket}: rows == the single-device cross_check, staged output "
        f"== the single-device graph's bit for bit; launches a forward "
        f"summed over the stages {per_forward} == the single-device "
        f"forward's")
    return booted, per_forward, dict(stages=report)


def served_batches(grp, wl, reqs: dict) -> list:
    """The batches each replica served, from its flight recorder: the
    requests a dispatch carried share its ``dispatched_s``; returns
    (requests, payloads, bucket) in dispatch order."""
    out = []
    for rep in grp.replicas.values():
        by_dispatch = collections.defaultdict(list)
        for f in rep.server.flight.dump():
            if f.get("outcome") == "served" and f.get("id") in reqs:
                by_dispatch[(f["dispatched_s"], f["bucket"])].append(
                    reqs[f["id"]])
        for (_, bucket), rs in by_dispatch.items():
            rs.sort(key=lambda r: r.id)
            out.append((rs, [r.payload for r in rs], bucket))
    return out


def replica_group(rng, device) -> tuple[dict, dict]:
    """``ReplicaGroup(engine, [cuda:0] * 2)`` of paper AlexNet
    (cuda_direct_pool), buckets 1-8: 64 mixed requests routed in groups;
    rows equal the single-device cross_check, build and capture counts
    flat after ``compile_buckets``, the two replicas share the packed
    tensors and not an output buffer.  Then a plan at ``server.device``
    matching ``{"tenant": "r1"}`` demotes r1's bucket 8 alone; unpinned
    traffic routes to r0."""
    from repro_torch.distributed import ReplicaGroup

    wl = workloads.get("alexnet_imagenet", seed=0)
    # No jitter: a failed batch's requests come back together, so r1's
    # second fault hits the same bucket and demotes it.
    grp = ReplicaGroup(wl.engine, [device] * 2, buckets=BUCKETS,
                       max_batch=BATCH, preprocess=wl.preprocess_hook,
                       retry=RetryPolicy(jitter=0.0))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    grp.compile_buckets()
    boot_s = time.perf_counter() - t0
    booted = read_launches()
    builds, captures = grp.build_count, grp.capture_count
    r0, r1 = grp.replicas["r0"], grp.replicas["r1"]
    e0, e1 = r0.server.engine.engine, r1.server.engine.engine
    out0 = e0._captured[next(k for k in e0._captured if k[0] == 8)]
    out1 = e1._captured[next(k for k in e1._captured if k[0] == 8)]
    if e0.packed[0]["w_packed"] is not e1.packed[0]["w_packed"] \
            or e0.packed[0]["w_packed"] is not \
            wl.engine.engine.packed[0]["w_packed"] \
            or out0.static_output.data_ptr() \
            == out1.static_output.data_ptr():
        raise AssertionError("[placement] replicas copy the packed tensors "
                             "or share an output buffer")
    sizes = [(240, 320), (300, 300), (227, 227), (480, 360), (256, 341)]
    reqs = {}
    t0 = time.perf_counter()
    for i, g in enumerate(REPLICA_GROUPS):
        for j in range(g):
            im = rng.integers(0, 256, (*sizes[(i + j) % len(sizes)], 3),
                              dtype=np.uint8)
            r = grp.submit(im)
            reqs[r.id] = r
        grp.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counted = read_launches()
    m = grp.metrics()
    calls = capture_calls() * len(BUCKETS) * 2
    want = WANT_LAUNCHES["cuda_direct_pool"]
    if (grp.build_count, grp.capture_count) != (builds, captures) \
            or captures != 2 * len(BUCKETS) \
            or booted != scaled(want, calls) or counted != booted:
        raise AssertionError(f"[placement] replicas: build/capture counts "
                             f"{(grp.build_count, grp.capture_count)} after "
                             f"{(builds, captures)}; launches over the boot "
                             f"{booted}, after the traffic {counted}, want "
                             f"{calls} x {want}")
    served = {n: v["served"] for n, v in m["replicas"].items()}
    if sum(served.values()) != len(reqs) or min(served.values()) == 0:
        raise AssertionError(f"[placement] replicas served {served}")
    for n, v in m["replicas"].items():
        check_healthy(f"placement {n}", v, "cuda_direct_pool")
    check_rows("replicas", wl, served_batches(grp, wl, reqs))
    log(f"[placement] ReplicaGroup of alexnet, 2 replicas on cuda:0: "
        f"{len(reqs)} requests in groups {list(REPLICA_GROUPS)} served "
        f"{served}, every row == the single-device cross_check; "
        f"build_count {builds} and capture_count {captures} flat; packed "
        f"tensors shared, output buffers apart; boot {boot_s:.3f} s, "
        f"traffic {serve_s:.3f} s (drained group by group: not a rate)")

    # The group's rate over a window of seconds: RATE_REQUESTS // 2
    # unpinned 227² requests submitted at once, then drained; replays
    # launch no wrapper.
    frames = [rng.integers(0, 256, (227, 227, 3), dtype=np.uint8)
              for _ in range(RATE_FRAMES)]
    before = {n: v["served"] for n, v in m["replicas"].items()}
    reset_launches()
    t0 = time.perf_counter()
    steady = [grp.submit(frames[i % RATE_FRAMES])
              for i in range(RATE_REQUESTS // 2)]
    grp.drain()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    m = grp.metrics()
    split = {n: v["served"] - before[n] for n, v in m["replicas"].items()}
    if not all(r.outcome == "served" for r in steady) \
            or (grp.build_count, grp.capture_count) != (builds, captures) \
            or any(read_launches().values()):
        raise AssertionError(f"[placement] replicas' timed window: "
                             f"launches {read_launches()}, build/capture "
                             f"counts {(grp.build_count, grp.capture_count)}"
                             f", {m}")
    log(f"[placement] ReplicaGroup timed window: {len(steady)} requests "
        f"of 227x227 submitted at once, split {split}, in "
        f"{steady_s:.3f} s ({len(steady) / steady_s:.3f} served/s)")

    # r1's readbacks fault twice: its bucket 8 demotes (the rung captured
    # at its next dispatch), r0 is untouched, and routing avoids r1.
    plan = FaultPlan([FaultSpec("server.device", "device_fault", times=2,
                                match={"tenant": "r1"})])
    pinned = [rng.integers(0, 256, (256, 341, 3), dtype=np.uint8)
              for _ in range(BATCH)]
    r1_served = r1.server.metrics()["served"]
    with faults.inject(plan):
        faulted = [grp.submit(im, replica="r1") for im in pinned]
        grp.drain()
        demoted = r1.server.health.ladder(BATCH).mode
        routed = [grp.submit(im) for im in pinned * 2]
        r1_depth = r1.server.queue_depth
        grp.drain()
    m = grp.metrics()
    if not all(r.outcome == "served" for r in faulted + routed) \
            or demoted == "cuda_direct_pool" or r1.healthy \
            or not r0.healthy or r1_depth \
            or r1.server.metrics()["served"] != r1_served + BATCH \
            or len(plan.log) != 2:
        raise AssertionError(f"[placement] r1's fault plan: r1 at "
                             f"{demoted}, healthy {r1.healthy}, r0 healthy "
                             f"{r0.healthy}, r1 queue {r1_depth}, fired "
                             f"{len(plan.log)}, {m['routing']}")
    check_healthy("placement r0", m["replicas"]["r0"], "cuda_direct_pool")
    check_rows("replicas, r1 demoted", wl,
               [(faulted, pinned, BATCH), (routed[:BATCH], pinned, BATCH),
                (routed[BATCH:], pinned, BATCH)])
    log(f"[placement] fault plan {{'tenant': 'r1'}} at server.device, 2 "
        f"faults: r1's bucket {BATCH} demoted to {demoted} (captured at "
        f"its next dispatch), its {BATCH} requests served (retries "
        f"{m['replicas']['r1']['retries']}); r0 untouched; "
        f"{len(routed)} unpinned requests all routed to r0; rows == "
        f"cross_check")
    return booted, dict(served=served, boot_s=boot_s, serve_s=serve_s,
                        steady_split=split, steady_s=steady_s,
                        served_per_s=len(steady) / steady_s,
                        r1_demoted_to=demoted)


def sync_against_async(rng) -> dict:
    """Served/s of RATE_REQUESTS network-size images (RATE_FRAMES
    distinct ones, cycled) at bucket 8 on cuda_direct_pool, each bucket
    captured, async dispatch against the blocking baseline, twice in
    alternation (printed, not asserted)."""
    wl = workloads.get("alexnet_imagenet", seed=0)
    frames = [rng.integers(0, 256, (227, 227, 3), dtype=np.uint8)
              for _ in range(RATE_FRAMES)]
    out = collections.defaultdict(list)
    for async_dispatch in (True, False, False, True):
        server = wl.server(max_batch=BATCH, buckets=(BATCH,),
                           async_dispatch=async_dispatch)
        server.compile_buckets()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [server.submit(frames[i % RATE_FRAMES])
                for i in range(RATE_REQUESTS)]
        server.drain()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        m = server.metrics()
        if not all(r.outcome == "served" for r in reqs) \
                or m["async_dispatch"] is not async_dispatch:
            raise AssertionError(f"[placement] sync/async: {m}")
        check_healthy("placement", m, wl.matmul_mode)
        out["async" if async_dispatch else "sync"].append(
            dict(served_per_s=m["throughput"], wall_s=wall_s))
    log(f"[placement] alexnet bucket {BATCH}, {RATE_REQUESTS} requests of "
        f"227x227 ({RATE_FRAMES} distinct) submitted at once, "
        f"cuda_direct_pool captured: served/s async "
        + ", ".join(f"{r['served_per_s']:.3f} over {r['wall_s']:.3f} s"
                    for r in out["async"])
        + "; sync (the blocking baseline) "
        + ", ".join(f"{r['served_per_s']:.3f} over {r['wall_s']:.3f} s"
                    for r in out["sync"])
        + " (runs async, sync, sync, async)")
    return dict(out)


def phase_placement(rng, device) -> tuple[dict, dict, dict]:
    """Multi-device serving on one card's terms (every device list names
    cuda:0).  Returns (launches of each placed path, launches a forward,
    numbers)."""
    launches, per_forward, numbers = {}, {}, {}
    for mode in PLACEMENT_PATHS:
        key = f"placement_{mode}"
        launches[key], numbers[key] = pipelined_alexnet(rng, device, mode)
        per_forward[key] = WANT_LAUNCHES[mode]
    for name, n_stages, bucket in PLACEMENT_NETS:
        key = f"placement_{name}"
        launches[key], per_forward[key], numbers[key] = pipelined_net(
            rng, device, name, n_stages, bucket)
    launches["placement_replicas"], numbers["replicas"] = \
        replica_group(rng, device)
    per_forward["placement_replicas"] = WANT_LAUNCHES["cuda_direct_pool"]
    numbers["sync_async"] = sync_against_async(rng)
    missing = [k for k in PLACEMENT_KERNELS
               if not sum(v[k] for v in launches.values())]
    if missing:
        raise AssertionError(f"[placement] kernels never launched on the "
                             f"placed paths: {missing}")
    return launches, per_forward, numbers


# The [faults] phase: the watchdog's bound and the latency spike that
# outlives it, the re-probe interval of a demoted bucket (long enough that
# the profiled demoted traffic cannot reach it; then the phase waits it
# out), and the groups of 8 profiled on each rung.
WATCHDOG_S, SPIKE_S, PROBE_S, FAULT_GROUPS = 0.25, 0.6, 2.0, 2


def phase_faults(chain_wl) -> dict:
    """The resilience layer on paper AlexNet at 227², buckets (1, 8)
    captured, base mode ``cuda_chain``, a seeded fault plan: a latency
    spike past ``watchdog_s`` resolves ``error`` on a server with
    ``retry=None`` and its next batch is served; two dispatch faults of
    ``cuda_chain`` at bucket 8 demote that bucket to ``cuda_direct_pool``,
    whose rung is captured at its next dispatch (capture ms printed) while
    bucket 1 stays; the demoted traffic's replays, profiled, launch
    exactly ``cuda_direct_pool``'s kernels a group and no K5; after
    ``PROBE_S`` a probe promotes bucket 8 and its replays launch
    ``cuda_chain``'s again; one ``executor.call`` and one ``server.device``
    fault at bucket 1 are retried and served.  Every served row equals
    ``cross_check``.  The wrappers count the run from the servers' boot:
    each bucket's ``cuda_chain`` capture and the lazy ``cuda_direct_pool``
    one (K4, K5, K3 and its bit-plane variant, K2)."""
    from repro_torch.serving import InferenceServer, PhoneBitEngine
    from repro_torch.workloads.workload import WorkloadEngine

    base = chain_wl.engine.engine
    engine = WorkloadEngine(
        PhoneBitEngine(spec=base.spec, packed=base.packed,
                       input_hw=base.input_hw, matmul_mode="cuda_chain",
                       device=base.device), chain_wl.postprocess)
    for b in (1, BATCH):                 # regions planned, tiles tuned
        engine.engine.compile(b, capture=False)
    hook = chain_wl.preprocess_hook
    rng = np.random.default_rng(20)
    imgs = [rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
            for _ in range(BATCH * (2 * FAULT_GROUPS + 3) + 4)]
    feed = iter(imgs)
    served: list[tuple[list, list]] = []

    def serve(server, n):
        batch = [next(feed) for _ in range(n)]
        reqs = [server.submit(im) for im in batch]
        server.drain()
        pad = server.scheduler.bucket_for(n) - n
        served.append((reqs, batch + [np.zeros_like(batch[-1])] * pad))
        return reqs

    torch.cuda.synchronize()
    reset_launches()
    t_phase = time.perf_counter()
    kw = dict(preprocess=hook, max_batch=BATCH, buckets=(1, BATCH))
    guarded = InferenceServer(engine, retry=None, watchdog_s=WATCHDOG_S,
                              **kw)
    server = InferenceServer(engine, demote_after=2, probe_after_s=PROBE_S,
                             watchdog_s=1.0,
                             retry=RetryPolicy(max_attempts=3,
                                               backoff_base_s=0.001,
                                               jitter=0.0), **kw)
    server.compile_buckets()
    out: dict = {}

    # The watchdog: a readback wedged past watchdog_s is an error (no
    # retry on this server), and the next batch is served.
    with faults.inject([FaultSpec("server.device", "latency_spike",
                                  times=1, duration_s=SPIKE_S)],
                       sleep=time.sleep):
        t0 = time.perf_counter()
        wedged = guarded.submit(next(feed))
        guarded.drain()
        out["watchdog_s"] = time.perf_counter() - t0
        after = serve(guarded, 1)
    if wedged.outcome != "error" or "WatchdogTimeout" not in wedged.error \
            or after[0].outcome != "served" \
            or out["watchdog_s"] >= SPIKE_S:
        raise AssertionError(f"[faults] watchdog: {wedged.outcome} "
                             f"({wedged.error}), next {after[0].outcome}, "
                             f"{out['watchdog_s']:.3f} s")

    plan = faults.install(FaultPlan([
        FaultSpec("server.dispatch", "device_fault", times=2,
                  match={"mode": "cuda_chain", "bucket": BATCH}),
        FaultSpec("executor.call", "device_fault", times=1,
                  match={"bucket": 1}),
        FaultSpec("server.device", "device_fault", times=1, after=1,
                  match={"bucket": 1}),
    ], seed=7, sleep=time.sleep))
    try:
        # Two dispatch faults demote bucket 8; the third attempt captures
        # the demoted rung and serves.
        t0 = time.perf_counter()
        serve(server, BATCH)
        out["demote_serve_s"] = time.perf_counter() - t0
        demoted = engine.compile(BATCH, mode="cuda_direct_pool")
        out["demoted_capture_ms"] = demoted.capture_s * 1e3
        t_demote = server.health.ladder(BATCH).demotions[-1]["t"]
        if server.health.mode_for(BATCH) != "cuda_direct_pool" \
                or server.health.mode_for(1) != "cuda_chain" \
                or server.health.ladder(BATCH).floor != faults.CUDA_FLOOR:
            raise AssertionError(f"[faults] after the dispatch faults: "
                                 f"{server.metrics()['bucket_health']}")

        def traffic():
            for _ in range(FAULT_GROUPS):
                serve(server, BATCH)

        def rehearse(exe):
            return lambda: [exe.replay() for _ in range(FAULT_GROUPS)]

        # The demoted traffic: cuda_direct_pool's launches, no K5.
        replayed = device_launches(profiled(traffic,
                                            first=rehearse(demoted)))
        if time.monotonic() - t_demote >= PROBE_S:
            raise AssertionError("[faults] the demoted traffic outlasted "
                                 "the probe interval")
        want = scaled(WANT_LAUNCHES["cuda_direct_pool"], FAULT_GROUPS)
        if replayed != want:
            raise AssertionError(f"[faults] demoted replays launched "
                                 f"{replayed}, want {want}")
        out["demoted_launches"] = replayed
        # Past the quarantine the next bucket-8 batch probes cuda_chain
        # and promotes the bucket; its replays launch K5 again.
        time.sleep(max(0.0, t_demote + PROBE_S - time.monotonic()) + 0.01)
        chain = engine.compile(BATCH)
        replayed = device_launches(profiled(traffic, first=rehearse(chain)))
        want = scaled(WANT_LAUNCHES["cuda_chain"], FAULT_GROUPS)
        if replayed != want or server.health.mode_for(BATCH) != \
                "cuda_chain":
            raise AssertionError(f"[faults] after the probe: launched "
                                 f"{replayed}, want {want}; mode "
                                 f"{server.health.mode_for(BATCH)}")
        out["promoted_launches"] = replayed
        # Transient faults at bucket 1: a replay, then a readback.
        transient = serve(server, 1) + serve(server, 1)
    finally:
        faults.uninstall()
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t_phase
    counted = read_launches()
    calls = capture_calls()
    want = {k: 2 * calls * v + calls * WANT_LAUNCHES["cuda_direct_pool"][k]
            for k, v in WANT_LAUNCHES["cuda_chain"].items()}
    if counted != want:
        raise AssertionError(f"[faults] wrapper launches {counted}, want "
                             f"{want} (two cuda_chain buckets and the "
                             f"demoted rung captured)")
    missing = [k for k in ("bitplane_pack", "chain_conv",
                           "direct_conv_bn_binarize",
                           "direct_conv_bn_binarize_planes",
                           "fused_matmul_bn_binarize") if not counted[k]]
    if missing:
        raise AssertionError(f"[faults] no launch of {missing}")
    out["launches"] = counted
    sites = [f["site"] for f in plan.log]
    m = server.metrics()
    flights = [f for f in server.flight.dump() if f.get("kind")]
    if sites != ["server.dispatch"] * 2 + ["executor.call", "server.device"] \
            or [r.attempts for r in transient] != [1, 1] \
            or m["degraded"] != 1 \
            or m["retries"] != 2 * BATCH + 2 or m["errors"] \
            or [f["kind"] for f in flights] != ["demotion", "promotion"]:
        raise AssertionError(f"[faults] fault log {plan.log}, attempts "
                             f"{[r.attempts for r in transient]}, metrics "
                             f"{m}, flights {flights}")
    for reqs, padded in served:
        x = torch.stack([hook(p) for p in padded])
        ref = engine.cross_check(x).cpu().numpy()
        for r, row in zip(reqs, ref):
            if r.outcome != "served" or not np.array_equal(r.result, row):
                raise AssertionError("[faults] served row != cross_check")
    out.update(retries=m["retries"], degraded=m["degraded"],
               served=m["served"] + guarded.metrics()["served"],
               captures=engine.capture_count)
    out["no_ladder"] = faults_without_ladder(engine, feed, hook)
    log(f"[faults] watchdog: a {SPIKE_S} s spike at server.device past "
        f"watchdog_s {WATCHDOG_S} resolved error (WatchdogTimeout, "
        f"retry=None) in {out['watchdog_s']:.3f} s; the next batch served")
    log(f"[faults] two server.dispatch faults of cuda_chain at bucket "
        f"{BATCH} demoted it to cuda_direct_pool (degraded 1; bucket 1 "
        f"stays on cuda_chain); that rung captured at the next dispatch in "
        f"{out['demoted_capture_ms']:.3f} ms, the batch served "
        f"{out['demote_serve_s']:.3f} s after its submit (2 faulted "
        f"dispatches, 2 backoffs, the capture); {FAULT_GROUPS} demoted "
        f"groups' traced replays launched {out['demoted_launches']} = "
        f"{FAULT_GROUPS} x WANT_LAUNCHES['cuda_direct_pool'], no K5; "
        f"after {PROBE_S} s a probe promoted the bucket, {FAULT_GROUPS} "
        f"groups launched {out['promoted_launches']} = {FAULT_GROUPS} x "
        f"WANT_LAUNCHES['cuda_chain']")
    log(f"[faults] executor.call and server.device faults at bucket 1: "
        f"retried once each and served; fault log sites {sites}; retries "
        f"{m['retries']}, errors {m['errors']}, {out['served']} rows "
        f"served, each == cross_check; wrapper launches from the boot "
        f"{counted} (2 cuda_chain buckets and the demoted rung captured, "
        f"{calls} calls each); phase {out['phase_s']:.3f} s")
    return out


def faults_without_ladder(engine, feed, hook) -> dict:
    """``InferenceServer(degrade=False)`` on the top rung (``cuda_chain``,
    the buckets captured above): three dispatch faults at bucket 8 spend
    the batch's attempts and it resolves ``error`` with no demotion
    (``health`` None, ``degraded`` 0, the mode the engine's); the next
    batch is served on the same captured rung, each row equal to
    ``cross_check``, and nothing is built or captured."""
    from repro_torch.serving import InferenceServer

    server = InferenceServer(engine, preprocess=hook, max_batch=BATCH,
                             buckets=(1, BATCH), degrade=False,
                             retry=RetryPolicy(max_attempts=3,
                                               backoff_base_s=0.001,
                                               jitter=0.0))
    captures = engine.capture_count
    reset_launches()
    t0 = time.perf_counter()
    with faults.inject([FaultSpec("server.dispatch", "device_fault",
                                  times=3, match={"mode": "cuda_chain",
                                                  "bucket": BATCH})],
                       sleep=time.sleep) as plan:
        failed = [server.submit(next(feed)) for _ in range(BATCH)]
        server.drain()
    batch = [next(feed) for _ in range(BATCH)]
    reqs = [server.submit(im) for im in batch]
    server.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = read_launches()
    m = server.metrics()
    ref = engine.cross_check(torch.stack([hook(p) for p in batch])).cpu()
    rows_equal = all(r.outcome == "served"
                     and np.array_equal(r.result, row.numpy())
                     for r, row in zip(reqs, ref))
    if server.health is not None \
            or [r.outcome for r in failed] != ["error"] * BATCH \
            or [r.attempts for r in failed] != [3] * BATCH \
            or len(plan.log) != 3 or m["degraded"] or m["errors"] != BATCH \
            or m["mode"] != "cuda_chain" or not rows_equal \
            or any(f.get("kind") for f in server.flight.dump()) \
            or engine.capture_count != captures \
            or launched != launch_counts():
        raise AssertionError(f"[faults] degrade=False: outcomes "
                             f"{[r.outcome for r in failed]}, metrics {m}, "
                             f"rows equal {rows_equal}, captures "
                             f"{engine.capture_count} (were {captures}), "
                             f"launches {launched}")
    log(f"[faults] InferenceServer(degrade=False) on cuda_chain: three "
        f"server.dispatch faults at bucket {BATCH} spent the batch's 3 "
        f"attempts and its {BATCH} requests resolved error with no demotion "
        f"(health None, degraded 0, errors {m['errors']}, retries "
        f"{m['retries']}, mode {m['mode']}); the next batch served on the "
        f"same captured rung, rows == cross_check, nothing built or "
        f"captured; {wall_s:.3f} s")
    return dict(errors=m["errors"], retries=m["retries"],
                degraded=m["degraded"], wall_s=wall_s)


# A fresh interpreter that boots AlexNet servers from artifacts and serves
# 8 images, for the artifact phase: it imports repro_torch alone and
# prints one line, ``BOOT {json}``.
BOOT_SCRIPT = """
import time
t_start = time.perf_counter()
import collections, json, os, sys
os.environ["REPRO_AUTOTUNE_CACHE"] = "0"
sys.path.insert(0, {src!r})
import numpy as np
import torch
from repro_torch import workloads
from repro_torch.kernels import build
from repro_torch.obs import metrics
from repro_torch.serving.recovery import RequestJournal, replay_journal
out = dict(import_s=time.perf_counter() - t_start, runs=[])
io = np.load({io!r})
for mode, art in {runs!r}:
    t0 = time.perf_counter()
    with metrics.use_registry() as reg:
        wl = workloads.get("alexnet_imagenet", seed=0, matmul_mode=mode)
        server = wl.server(max_batch=8, buckets=(1, 2, 4, 8), artifact=art)
        builds = wl.engine.build_count
        reqs = [server.submit(im) for im in io["imgs"]]
        server.drain()
        first_s = time.perf_counter() - t0
        tuner = collections.Counter(e["outcome"]
                                    for e in reg.events("autotune"))
    report = server.artifact_report
    m = server.metrics()
    out["runs"].append(dict(
        mode=mode, boot_to_result_s=first_s,
        since_start_s=time.perf_counter() - t_start,
        loaded=report.get("loaded"), missed=sorted(report.get("missed", [])),
        tuner=dict(tuner), nvcc_s=build.build()[1],
        capture_count=wl.engine.capture_count,
        build_count_flat=wl.engine.build_count == builds,
        retries=m["retries"], degraded=m["degraded"],
        rows_equal=bool(np.array_equal(np.stack([r.result for r in reqs]),
                                       io[mode]))))
    if mode == {journal_mode!r}:
        # The parent left submits unresolved in this journal: replay them
        # through the booted buckets.
        t0 = time.perf_counter()
        server = wl.server(max_batch=8, buckets=(1, 2, 4, 8),
                           journal=RequestJournal({jpath!r}))
        replayed = replay_journal(server, {jpath!r})
        server.drain()
        server.journal.close()
        out["journal"] = dict(
            replayed=[r.jid for r in replayed],
            outcomes=[r.outcome for r in replayed],
            replay_s=time.perf_counter() - t0,
            rows_equal=bool(np.array_equal(
                np.stack([r.result for r in replayed]), io["journal"])),
            unresolved_after=len(RequestJournal.scan({jpath!r}).unresolved),
            build_count_flat=wl.engine.build_count == builds)
out["foreign"] = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "repro")]
print("BOOT " + json.dumps(out))
"""


# The artifact boot that replays the parent's journal, and the images the
# parent journaled (indices into the phase's 8).
JOURNAL_MODE, JOURNAL_IMAGES = "cuda_direct_pool", (0, 2, 5)


def run_boot(io: str, runs: list, jpath: str) -> dict:
    """Run BOOT_SCRIPT in a fresh interpreter; returns its result and the
    subprocess's wall time."""
    script = BOOT_SCRIPT.format(src=str(ROOT / "src"), io=io, runs=runs,
                                jpath=jpath, journal_mode=JOURNAL_MODE)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    line = next((ln for ln in r.stdout.splitlines()
                 if ln.startswith("BOOT ")), None)
    if r.returncode != 0 or line is None:
        raise AssertionError(f"[artifact] boot subprocess failed "
                             f"({r.returncode}):\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    return dict(json.loads(line[5:]), process_wall_s=wall_s)


def phase_artifact(rng: np.random.Generator) -> dict:
    """Paper AlexNet booted live under ``"auto"`` (the tuner's caches
    emptied and its disk cache off, so every bucket is tuned) and under
    ``cuda_direct_pool``, exported at buckets (1, 2, 4, 8), captured and
    serving 8 images; then a fresh interpreter boots a server from each
    artifact (the ``"auto"`` one first) and serves the same images: every
    bucket loaded and captured, no tuner outcome, no nvcc build,
    ``build_count`` flat, no retry or demotion, rows equal to the live
    boot's.  A live ``cuda_direct_pool`` server also journals 3 of the
    images as one batch (its rows kept), and the journal is cut back to
    their submits, as a process killed before their readback leaves it:
    the fresh process replays them through its booted buckets with
    ``replay_journal``, each result equal to the exporter's row, and the
    journal is closed after."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import engine as serving_engine
    imgs = np.stack([rng.integers(0, 256, (227, 227, 3), dtype=np.uint8)
                     for _ in range(BATCH)])
    serving_engine._AUTOTUNE_CACHE.clear()
    serving_engine._AUTOTUNE_AGNOSTIC.clear()
    disk = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = "0"
    live = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-artifact-") as tmp:
        want, arts = {}, {}
        for mode in ("auto", "cuda_direct_pool"):
            arts[mode] = os.path.join(tmp, mode)
            t0 = time.perf_counter()
            wl = workloads.get("alexnet_imagenet", seed=0, matmul_mode=mode)
            with obs_metrics.use_registry() as reg:
                meta = wl.engine.export_artifact(arts[mode], buckets=BUCKETS,
                                                 workload=wl.name)
            export_s = time.perf_counter() - t0
            tuner = dict(collections.Counter(e["outcome"]
                                             for e in reg.events("autotune")))
            if mode == "auto" and "miss" not in tuner:
                raise AssertionError(f"[artifact] live auto boot: tuner "
                                     f"outcomes {tuner}, want it to tune")
            server = wl.server(max_batch=BATCH, buckets=BUCKETS)
            capture_s = sum(server.compile_buckets().values())
            reqs = [server.submit(im) for im in imgs]
            server.drain()
            want[mode] = np.stack([r.result for r in reqs])
            check_healthy("artifact", server.metrics(), mode)
            if mode == JOURNAL_MODE:
                jpath = os.path.join(tmp, "requests.jsonl")
                journal = RequestJournal(jpath)
                jserver = wl.server(max_batch=BATCH, buckets=BUCKETS,
                                    journal=journal)
                jreqs = [jserver.submit(imgs[i]) for i in JOURNAL_IMAGES]
                jserver.drain()
                want["journal"] = np.stack([r.result for r in jreqs])
                journal.close()
                # What a process killed before their readback leaves: the
                # submits without their resolves.
                with open(jpath, encoding="utf-8") as f:
                    lines = [ln for ln in f if '"op":"submit"' in ln]
                with open(jpath, "w", encoding="utf-8") as f:
                    f.writelines(lines)
            live[mode] = dict(boot_to_result_s=time.perf_counter() - t0,
                              build_export_s=export_s, capture_s=capture_s,
                              tuner=tuner)
            files = sorted(os.listdir(arts[mode]))
            size = sum(os.path.getsize(os.path.join(arts[mode], f))
                       for f in files)
            log(f"[artifact] {mode} live in this process: built"
                + (" and tuned" if mode == "auto" else "")
                + f" and exported buckets "
                f"{sorted(int(b) for b in meta['buckets'])} in "
                f"{export_s:.3f} s ({', '.join(files)}; {size} B; tuner "
                f"outcomes {tuner}), "
                f"captured and first-run in {capture_s:.3f} s, boot to the "
                f"8 results {live[mode]['boot_to_result_s']:.3f} s; "
                f"device_kind {meta['device_kind']}, kernels "
                f"{meta['kernels']}")
        os.environ["REPRO_AUTOTUNE_CACHE"] = disk
        io = os.path.join(tmp, "io.npz")
        np.savez(io, imgs=imgs, **want)
        fresh = run_boot(io, [("auto", arts["auto"]),
                              ("cuda_direct_pool", arts["cuda_direct_pool"])],
                         jpath)
    for run in fresh["runs"]:
        ok = (run["loaded"] == list(BUCKETS) and not run["missed"]
              and not run["tuner"] and run["nvcc_s"] == 0.0
              and run["capture_count"] == len(BUCKETS)
              and run["build_count_flat"] and run["rows_equal"]
              and run["retries"] == 0 and run["degraded"] == 0)
        if not ok or fresh["foreign"]:
            raise AssertionError(f"[artifact] fresh boot: {run}, foreign "
                                 f"modules {fresh['foreign']}")
    jr = fresh.get("journal", {})
    if len(jr.get("replayed", [])) != len(JOURNAL_IMAGES) \
            or jr["outcomes"] != ["served"] * len(JOURNAL_IMAGES) \
            or not jr["rows_equal"] or jr["unresolved_after"] \
            or not jr["build_count_flat"]:
        raise AssertionError(f"[artifact] journal replay in the fresh "
                             f"process: {jr}")
    log(f"[artifact] journal: the fresh process replayed the "
        f"{len(jr['replayed'])} submits the live server left unresolved "
        f"(jids {jr['replayed']}) through its {JOURNAL_MODE} buckets in "
        f"{jr['replay_s']:.3f} s: all served, rows == the exporter's, "
        f"journal closed, nothing built")
    for i, run in enumerate(fresh["runs"]):
        where = "fresh process" if i == 0 else "the same process, next"
        log(f"[artifact] {where}, {run['mode']} from the artifact: boot to "
            f"the 8 results {run['boot_to_result_s']:.3f} s "
            f"({run['since_start_s']:.3f} s since the interpreter's first "
            f"line, imports {fresh['import_s']:.3f} s; the process "
            f"{fresh['process_wall_s']:.3f} s); loaded {run['loaded']}, "
            f"tuner outcomes {run['tuner']}, nvcc {run['nvcc_s']} s, "
            f"captures {run['capture_count']}, build_count flat "
            f"{run['build_count_flat']}, rows == the live boot's "
            f"{run['rows_equal']}")
    return dict(fresh=fresh, live=live)


def packed_tail(g):
    """``g`` cut at its last packed node, the input of the float head's
    ``unpack_pm1``."""
    unpack = next(n for n in g.nodes.values() if n.op == "unpack_pm1")
    return g.upto(unpack.inputs[0])


def phase_trained(device) -> dict[str, dict[str, int]]:
    """Paper AlexNet from seeded float params through the trained-params
    path: the unfused graph on the card (K4, K1 for every count node, the
    float-BN epilogue and max-pools in plain PyTorch) against its default
    pipeline under ``cuda_direct_pool``, and both against the float oracle.
    Returns the launches of each graph's run."""
    spec = paper_nets.alexnet_spec()
    hw = (227, 227)
    params = workloads.checkpoint_params(spec, seed=0)
    graphs = {
        "unfused": (assign_layouts(bnn_model.to_graph(params, spec, hw)),
                    "torch"),
        "fused": (default_pipeline(bnn_model.to_graph(params, spec, hw)),
                  "cuda_direct_pool"),
    }
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randint(0, 256, (BATCH, *hw, 3), dtype=torch.uint8,
                      device=device, generator=g)
    heads, tails, launches = {}, {}, {}
    for name, (graph, backend) in graphs.items():
        graph = graph.to(device)
        exe = GraphExecutor(graph, backend)
        exe(x)
        torch.cuda.synchronize()
        reset_launches()
        heads[name] = exe(x)
        torch.cuda.synchronize()
        launches[name] = read_launches()
        if launches[name] != WANT_TRAINED[name]:
            raise AssertionError(f"[trained] {name} launches "
                                 f"{launches[name]}, want "
                                 f"{WANT_TRAINED[name]}")
        tails[name] = GraphExecutor(packed_tail(graph), backend)(x)
    oracle = bnn_model.float_forward(params, spec, x)
    torch.cuda.synchronize()
    if not torch.equal(tails["unfused"], tails["fused"]):
        differ = int((tails["unfused"] != tails["fused"]).sum())
        raise AssertionError(f"[trained] packed tails differ in {differ} "
                             f"words of {tails['fused'].numel()}")
    diffs = {name: (h - oracle).abs().max().item()
             for name, h in heads.items()}
    diffs["unfused vs fused"] = (heads["unfused"] -
                                 heads["fused"]).abs().max().item()
    if max(diffs.values()) > 1e-3:
        raise AssertionError(f"[trained] float heads differ: {diffs}")
    top5 = {name: torch.topk(h, 5, dim=-1).indices
            for name, h in dict(heads, oracle=oracle).items()}
    if not (torch.equal(top5["unfused"], top5["fused"])
            and torch.equal(top5["unfused"], top5["oracle"])):
        raise AssertionError("[trained] top-5 classes differ")
    if not torch.isfinite(oracle).all() or oracle.shape != (BATCH, 1000):
        raise AssertionError(f"[trained] bad heads {tuple(oracle.shape)}")
    log(f"[trained] alexnet 227x227 batch {BATCH} from float params: "
        f"unfused graph ({len(graphs['unfused'][0].nodes)} nodes) launches "
        f"{launches['unfused']}; default pipeline under cuda_direct_pool "
        f"launches {launches['fused']}; packed tails "
        f"{tuple(tails['fused'].shape)} equal bit for bit; top-5 equal; "
        f"largest |head - float_forward| unfused "
        f"{diffs['unfused']:.3e}, fused {diffs['fused']:.3e}, unfused vs "
        f"fused {diffs['unfused vs fused']:.3e}")
    return launches


# --------------------------------------------------------------------------
# The [train] phase
# --------------------------------------------------------------------------

# K7b cases, bf16, in FLASH_CASES' form: lm-100m's layer (the train step's
# shape), minitron-8b's prefill layer and the same at S 512, and edge cases
# of the 64-row, 128-key tiles (ragged, non-causal with Sq != Skv, G = 1,
# G = 4 over five key tiles, so each dq block sums five contributions in
# order), the zoo's layers (ZOO_FLASH_LAYERS, gen_1024's at B 1), and the
# train steps' layers at their batches (TRAIN_LAYERS).  The first two are
# the timed shapes.
K7B_CASES = [
    ("lm-100m layer", 8, 512, 512, 12, 4, 64, True),
    ("minitron-8b prefill layer", 2, 2048, 2048, 32, 8, 128, True),
    ("minitron-8b layer at S 512", 2, 512, 512, 32, 8, 128, True),
    ("hd 64, ragged last tile, S = 100", 1, 100, 100, 12, 4, 64, True),
    ("hd 64, non-causal Sq 100, Skv 300", 1, 100, 300, 12, 4, 64, False),
    ("hd 128, S = 129, G = 1, non-causal", 1, 129, 129, 8, 8, 128, False),
    ("hd 128, S = 200, G = 1", 2, 200, 200, 4, 4, 128, True),
    ("hd 64, S = 640, G = 4, five key tiles", 1, 640, 640, 16, 4, 64, True),
] + ZOO_FLASH_LAYERS + [(name, 1, *rest)
                          for name, _, *rest in ZOO_GEN_1024] + [
    ("hd 72, ragged S 100", 1, 100, 100, 16, 16, 72, False),
] + TRAIN_LAYERS + SHARD_ZOO_LAYERS + BATCH_AXES_LAYERS
# K7b against its plain version, |kernel - plain| <= tol·(1 + |plain|) for
# each of dq, dk and dv: both round p and dS to bf16 before their products
# and round each output once, but sum in other orders (16-wide wgmma steps
# over 64-row, 128-key tiles against whole blocks), so they agree to a few
# bf16 steps (2^-8) of the gradients' scale.  The same bound holds against
# autograd of the float32 ``reference_attention`` on the same bf16 inputs.
K7B_TOL = 2e-2
# lm-100m at full width (launch/train.py's LM_100M, examples/
# train_lm_100m.py's batch and sequence), TRAIN_STEPS AdamW steps.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 8, 512
# The [shard train] phase: (arch, mesh (data, model), global batch, steps)
# at S TRAIN_SEQ.  lm-100m at full width and depth on (2, 2): DP, FSDP and
# TP at once, the [train] phase's B 8 x S 512, remat "nothing" (its
# config's); a checkpoint after step SHARD_TRAIN_CRASH_AFTER, then a
# resume on SHARD_TRAIN_RESUME from it.  granite-moe-3b-a800m at full
# width on (1, 4): EP with the tokens cut over ``model``, capacity factor
# E/k (nothing drops), its depth cut to SHARD_TRAIN_MOE_LAYERS of 32 (the
# full model's float32 state, ~3.3 B params x 16 B, would not fit beside
# the host-staged sums in the phase's time), B 4 x S 512.
SHARD_TRAIN_JOBS = (("lm-100m", (2, 2), TRAIN_BATCH, 4),
                    ("granite-moe-3b-a800m", (1, 4), 4, 2))
# lm-100m on a batch the batch axes do not divide: B 6 on (4, 1),
# where ``batch_spec(6)`` keeps no axis and every rank holds the 6 rows,
# and on the three-axis (pod 2, data 2, model 1), where the rows are cut
# over ``data`` alone and whole over ``pod``: (mesh, global batch,
# steps), the same checks as SHARD_TRAIN_JOBS' (step 0 against one device
# at the same batch, bf16 and float32, K7/K7b counted, bytes against
# ``shard_train_bytes``).
SHARD_TRAIN_UNEVEN = (({"data": 4, "model": 1}, 6, 2),
                      ({"pod": 2, "data": 2, "model": 1}, 6, 2))
SHARD_TRAIN_CRASH_AFTER = 2
SHARD_TRAIN_RESUME = (4, 1)
SHARD_TRAIN_MOE_LAYERS = 4
SHARD_TRAIN_LR = 3e-4
# Step 0 sharded against the one-device step on the same weights and
# batch (the balance loss over the mesh's token shards: the mean of each
# shard's, as ``_moe_local`` takes it): the loss within 2e-4 relative and
# the gradient norm within 5e-3 (tightened from the [zoo] phase's 2e-3 and
# 1e-2: an H100 80GB HBM3 at 700 W read at most 2.2e-5 and 7.9e-4,
# PERF.md §6), the resumed step's loss within 2e-4 of the uninterrupted
# run's (read: 7.4e-6).  Each
# gathered gradient leaf within SHARD_TRAIN_LEAF_TOL relative L2, by
# model.  A sharded forward sums a row-parallel product's float32 parts
# in another order than cuBLAS does, which moves a rare bf16 rounding;
# twelve random-init layers grow that to ~1% of the hidden state and 2%
# of a leaf (on the CPU the sharded and the one-device bf16 gradients are
# each 2.3-3.1% from the float32 one, and 1.8% from each other), so 2%
# is not met: lm-100m reads 1.67-2.14%, held to 3%;
# granite-moe-3b-a800m 2.63-3.76%, whose one-device floor (the same
# gradient from two half batches: other bucket shapes) reads 1.4-1.8%,
# held to 5% (tests/test_torch_train.py's GRAD_TOL).  A missing sum or a
# share taken twice moves a leaf by 30% or more.  The floor is held to the
# same limit: past it, the check fails rather than loosen.
SHARD_TRAIN_LOSS_TOL = 2e-4
SHARD_TRAIN_GNORM_TOL = 5e-3
SHARD_TRAIN_LEAF_TOL = {"lm-100m": 3e-2, "granite-moe-3b-a800m": 5e-2}
# The [shard zoo] phase: the zoo under ``rules`` at full width and depth
# over the same 4 ranks sharing the card.  Each arch's train cell
# (SHARD_ZOO_STEPS steps on SHARD_ZOO_TRAIN_MESH: DP, FSDP and TP at once)
# and serving cell (a forward, DiT's a DDIM sample step, on
# SHARD_ZOO_SERVE_MESH: TP over 4, DiT's sequence-sharded residual) as
# (shape, the batch it runs at).  Batches cut from the published ones
# (configs/shapes.py: cls_224 256, train_256 256, serve_b128 128,
# gen_fast 16): a gloo round trip costs 7-8 ms among 4 ranks there, and a
# step's weight gathers go through the host (PERF.md §5); EfficientNet-B7
# trains at its native 600², which no published cell of the zoo's runs.
SHARD_ZOO_ARCHS = ("vit-h14", "dit-xl2", "convnext-b", "efficientnet-b7")
SHARD_ZOO_CELLS = {
    "vit-h14": (("cls_224", 8), ("serve_b128", 8)),
    "dit-xl2": (("train_256", 8), ("gen_fast", 4)),
    "convnext-b": (("cls_224", 8), ("serve_b128", 8)),
    "efficientnet-b7": (("native_600", 4), None),
}
SHARD_ZOO_TRAIN_MESH, SHARD_ZOO_SERVE_MESH = (2, 2), (1, 4)
# Counted train steps a cell after step 0's checks (cut from 2 to 1 to
# make room in the smoke's time for the batch-axes cells; PERF.md §4
# lists the cut).
SHARD_ZOO_STEPS = 1
# A train cell on a batch the batch axes do not divide: ViT-H/14
# at cls_224 with a batch of 3 on SHARD_ZOO_TRAIN_MESH (every rank the 3
# rows, K7/K7b on its tp-2 heads), (arch, shape, batch, steps): step 0
# against one device, float32 within F32_CHECK and bf16 within
# SHARD_ZOO_UNEVEN_BF16_LIMITS (worst leaf, loss gap), its steps counted
# as the other cells'.  The bf16 leaf limit is ViT-H/14's; its loss, a
# mean of 3 rows where the batch-8 cell's averages 8, read a gap of
# 1.735e-3 on an NVIDIA H100 80GB HBM3 at 700 W (the batch-8 cell:
# 3.2e-4; its worst leaf 1.287e-2 beside a floor of 1.193e-2), held to
# 5e-3; the float32 check bounds the math.
SHARD_ZOO_UNEVEN = ("vit-h14", "cls_224", 3, 1)
SHARD_ZOO_UNEVEN_BF16_LIMITS = (3e-2, 5e-3, None)
# A gathered gradient leaf's relative L2 against one device is taken
# against max(its norm, SHARD_ZOO_FLOOR of the whole tree's): a leaf whose
# gradient is 0 in exact arithmetic (EfficientNet's proj_bn_b, a bias
# before the next train-mode BN) reads O(1) relative noise otherwise
# (tests/test_torch_vision.py's GRAD_FLOOR rule, at a 50× smaller share).
SHARD_ZOO_FLOOR = 1e-3
# Fixed limits of each zoo arch's bf16 readings in [shard zoo], set above
# what an NVIDIA H100 80GB HBM3 at 700 W read (PERF.md §6, PR 30 run 7),
# as SHARD_LIMITS bounds [shard]'s: (the worst gathered leaf of step 0,
# its loss's relative gap, the serving output's max error over max |one
# device|; None where the arch has no such reading).  Read: ViT-H/14
# 1.47e-2 (one-device floor 2.6e-3), 3.2e-4, 1.22e-2 (floor 0); DiT-XL/2
# 1.34e-2 (2.3e-3), 4.9e-5, 6.7e-4 (0); ConvNeXt-B 2.47e-3 (2.47e-3), 0,
# 0 (2.7e-7).  EfficientNet-B7's leaves have no bf16 limit: under
# train-mode BN a scale's gradient before another BN is a difference of
# near-equal terms (0.67 on proj_bn_s, ROADMAP caveat (i)), while its
# loss, a mean over the batch, read 9.1e-4: that is bounded, its leaves
# by the float32 check (F32_CHECK).  A missing cast or a bf16 sum over
# ranks moves a leaf by a bf16 step of the whole (3.9e-3) at every
# rank, and the losses by more than these.
SHARD_ZOO_BF16_LIMITS = {"vit-h14": (3e-2, 1e-3, 3e-2),
                         "dit-xl2": (3e-2, 5e-4, 5e-3),
                         "convnext-b": (5e-3, 1e-4, 1e-3),
                         "efficientnet-b7": (None, 5e-3, None)}
TRAIN_ARGS = ["--arch", "lm-100m", "--batch", str(TRAIN_BATCH), "--seq-len",
              str(TRAIN_SEQ), "--device", "cuda"]
# Step 0 with K7/K7b against the same step with their plain versions: the
# loss within 2e-3 relative and the gradient norm within 2e-2 (attention's
# output and gradients agree to K7's and K7b's bf16 tolerances elementwise;
# the loss averages 4,096 tokens, the norm sums every leaf).
SWAP_LOSS_TOL, SWAP_GNORM_TOL = 2e-3, 2e-2
# Crash and resume: 10 steps, checkpoints every 3, death at step 6; the
# resumed steps 6-9 against an uninterrupted run within 1e-3 relative (the
# embedding's backward accumulates with atomics, so runs differ in the last
# bits).
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL_AT = 10, 3, 6
RESUME_TOL = 1e-3
# lm-100m at train_4k's sequence: steps (step 0 the warm-up), the batch it
# must run at (cut from the published 256: PERF.md §4 gives the bytes; any
# other batch fails the phase), and the cross entropy's sequence chunks
# (``transformer.chunked_ce``'s default).
TRAIN_4K_STEPS = 3
TRAIN_4K_BATCH = 32
LM_CE_CHUNKS = 8
# AlexNet STE training (examples/train_bnn.py at the paper's width): steps,
# images a step, class prototypes, the deployment's images, and the head's
# bound (tests/harness.py's 1e-4).
BNN_STEPS, BNN_BATCH, BNN_CLASSES, BNN_EVAL = 10, 8, 10, 64
BNN_HEAD_TOL = 1e-4
# cuBLAS's and CUTLASS's kernel names, by a substring (lower case).
MATMUL_KERNELS = ("nvjet", "gemm", "cutlass", "xmma")
WANT_BNN_DEPLOY = {k: v * (BNN_EVAL // BATCH)
                   for k, v in WANT_LAUNCHES["cuda_direct_pool"].items()}


def k7b_inputs(inp: Inputs, case):
    """Seeded bf16 q, k, v of one case and an upstream gradient."""
    q, k, v = flash_inputs(inp, case)
    do = torch.randn(q.shape, device=inp.device, generator=inp.g).to(
        torch.bfloat16)
    return q, k, v, do


def plain_blocks(case) -> tuple[int, int]:
    """(block_q, block_k) of the plain versions at a case: 512 cut to S, or
    128 where 512 does not divide a longer S, or S itself where neither
    does (the blocks must divide it: ViT-H/14's 730)."""
    return tuple(512 if s <= 512 or s % 512 == 0 else
                 128 if s % 128 == 0 else s for s in (case[2], case[3]))


def k7b_error(name: str, got, want) -> float:
    """max |got - want| over dq, dk, dv; fails past ``K7B_TOL``."""
    worst = 0.0
    for part, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"[train] {name} {part}: bad output")
        diff = (g - w).abs()
        if (diff > K7B_TOL * (1 + w.abs())).any():
            raise AssertionError(f"[train] {name} {part}: max |kernel - "
                                 f"reference| {diff.max().item():.3e} past "
                                 f"{K7B_TOL} · (1 + |reference|)")
        worst = max(worst, diff.max().item())
    return worst


def check_k7b(inp: Inputs, note) -> None:
    """(a) K7 with its lse and K7b against their plain versions and against
    autograd of the float32 oracle; K7's output with the lse equal to its
    serving output bit for bit."""
    for case in K7B_CASES:
        q, k, v, do = k7b_inputs(inp, case)
        causal = case[7]
        out, lse = k7.flash_attention_fwd(q, k, v, causal)
        if not torch.equal(out, k7.flash_attention(q, k, v, causal)):
            raise AssertionError(f"[train] {case[0]}: K7's output with the "
                                 f"lse differs from its serving output")
        blocks = plain_blocks(case)
        _, plain_lse = k7.flash_attention_plain(q, k, v, causal, *blocks,
                                                return_lse=True)
        lse_err = (lse - plain_lse).abs().max().item()
        if lse_err > 1e-3 * (1 + plain_lse.abs().max().item()):
            raise AssertionError(f"[train] {case[0]}: lse off by {lse_err}")
        got = k7.flash_attention_bwd(q, k, v, out, lse, do, causal)
        again = k7.flash_attention_bwd(q, k, v, out, lse, do, causal)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"[train] {case[0]}: two K7b calls on the "
                                 f"same inputs differ")
        del again
        err = k7b_error(case[0], got,
                        k7.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     causal, *blocks))
        note("flash_attention_bwd", err)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(
            layers.reference_attention(*leaves, causal=causal), leaves,
            do.float())
        ref_err = k7b_error(f"{case[0]} (float32 autograd)", got, want)
        log(f"[train] flash_attention_bwd {case[0]} q{tuple(q.shape)} "
            f"k{tuple(k.shape)} {'causal' if causal else 'non-causal'} bf16: "
            f"max |kernel - plain| {err:.3e}, |kernel - float32 autograd| "
            f"{ref_err:.3e} (tolerance {K7B_TOL} · (1 + |reference|)); lse "
            f"{lse_err:.3e} from the plain version's; a second call equal "
            f"bit for bit")


class PlainAttention(torch.autograd.Function):
    """K7 and K7b swapped for their plain versions (step 0's check only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        out, lse = k7.flash_attention_plain(q, k, v, causal, block_q,
                                            block_k, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = k7.flash_attention_bwd_plain(*ctx.saved_tensors,
                                             dout.contiguous(), *ctx.blocks)
        return (*grads, None, None, None)


@contextlib.contextmanager
def attention_path(plain: bool):
    """Attention through K7/K7b or, with ``plain``, through their plain
    versions (``layers.chunked_attention`` reads
    ``layers.flash_attention``)."""
    saved = layers.flash_attention
    if plain:
        layers.flash_attention = PlainAttention.apply
    try:
        yield
    finally:
        layers.flash_attention = saved


@contextlib.contextmanager
def float32_check():
    """The float32 step-0 check's setting (``F32_CHECK``): float32 compute,
    TF32 off for cuBLAS and cuDNN, attention through K7's and K7b's plain
    versions; everything restored after."""
    saved = (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    layers.COMPUTE_DTYPE = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with attention_path(True):
            yield
    finally:
        (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def moe_routing(routers: torch.Tensor, record: dict | None = None,
                pinned: dict | None = None, tokens: int = 0,
                shard: int = 0):
    """The float32 check's MoE routing (``moe._route``) with each call's
    top-k experts recorded or pinned, keyed by (layer, the layer's n-th
    call): MoE routing is discontinuous, so a near-tie between the k-th
    and the (k+1)-th expert that float32 sums in another order resolve the
    other way moves a token to another expert, and the gradient by far
    more than the check's limit (granite-moe-3b-a800m's one-device step
    on the card against the same step on the CPU: 5.1e-3, PERF.md §6).
    ``routers``: the stacked router weights (L, D, E), whose [l, 0, :8]
    tells the layer.  ``record``: the one-device run's calls (over
    ``tokens`` tokens where given: the train step's balance loss routes
    shard by shard again, calls not counted).  ``pinned``: the sharded run's calls take the recorded
    experts, the rank's ``shard`` of them where it routes fewer tokens
    (combine weights renormalised from its own probabilities, as
    ``_route`` takes them), and ``pinned["flips"]`` counts the tokens
    whose own choice differed."""
    real = moe._route
    keys = [tuple(r) for r in routers[:, 0, :8].float().tolist()]
    calls: collections.Counter = collections.Counter()

    def route(x, router, *, n_real, top_k):
        w, ids, probs = real(x, router, n_real=n_real, top_k=top_k)
        layer = keys.index(tuple(router[0, :8].float().tolist()))
        if record is not None and tokens in (0, x.shape[0]):
            record[layer, calls[layer]] = ids.clone()
            calls[layer] += 1
        elif pinned is not None:
            want = pinned[layer, calls[layer]]
            calls[layer] += 1
            n = x.shape[0]
            if want.shape[0] != n:
                want = want[shard * n:(shard + 1) * n]
            pinned["flips"] = pinned.get("flips", 0) + int(
                (ids.sort(-1).values != want.sort(-1).values).any(-1).sum())
            w = torch.take_along_dim(probs, want, dim=-1)
            w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
            ids = want
        return w, ids, probs

    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def _routing(cfg, params, **kw):
    """``moe_routing`` over an MoE model's routers (nothing for a dense
    one)."""
    if not cfg.moe:
        return contextlib.nullcontext()
    return moe_routing(params["layers"]["router"], **kw)


def loss_and_grad_norm(loss_fn, params, *args,
                       plain: bool) -> tuple[float, float]:
    """Step 0's loss and gradient norm of ``loss_fn(params, *args)``
    through K7/K7b or their plain versions."""
    with attention_path(plain):
        (loss, _), grads = tree.value_and_grad(loss_fn, params, *args)
        norm = optim.global_norm(grads)
    return loss.item(), norm.item()


def train_resume(tmp: str) -> float:
    """(b) A crash at step RESUME_FAIL_AT and the restart, against an
    uninterrupted run; returns the largest relative gap of steps 6-9."""
    args = TRAIN_ARGS + ["--steps", str(RESUME_STEPS), "--log-every", "100"]
    ckpt = ["--checkpoint-dir", tmp, "--checkpoint-every", str(RESUME_EVERY)]
    try:
        train.main(args + ckpt + ["--fail-at", str(RESUME_FAIL_AT)])
    except SystemExit as e:
        if e.code != 17:
            raise AssertionError(f"[train] --fail-at exited {e.code}") from e
    else:
        raise AssertionError("[train] --fail-at did not exit")
    resumed = train.main(args + ckpt)
    whole = train.main(args)
    if resumed["start_step"] != RESUME_FAIL_AT:
        raise AssertionError(f"[train] resumed from "
                             f"{resumed['start_step']}")
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(resumed["losses"], whole["losses"][RESUME_FAIL_AT:])]
    if len(gaps) != RESUME_STEPS - RESUME_FAIL_AT or max(gaps) > RESUME_TOL:
        raise AssertionError(f"[train] resumed losses {resumed['losses']} "
                             f"against {whole['losses'][RESUME_FAIL_AT:]}")
    log(f"[train] crash at step {RESUME_FAIL_AT} (exit 17), checkpoints "
        f"every {RESUME_EVERY}: the restart restored step "
        f"{RESUME_FAIL_AT - 1} and resumed from {resumed['start_step']}; "
        f"losses of steps {RESUME_FAIL_AT}-{RESUME_STEPS - 1} "
        f"{[round(x, 6) for x in resumed['losses']]} against the "
        f"uninterrupted run's {[round(x, 6) for x in whole['losses'][6:]]}: "
        f"largest relative gap {max(gaps):.3e} (tolerance {RESUME_TOL})")
    return max(gaps)


def train_lm(device) -> tuple[dict, dict]:
    """(b) lm-100m at full width through ``launch.train.main``: K7 twice a
    layer a step (the forward and the remat's recompute) and K7b once;
    step 0 against the plain swap; one step profiled; the crash and
    resume."""
    cfg = train.LM_100M
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    res = train.main(TRAIN_ARGS + ["--steps", str(TRAIN_STEPS),
                                   "--log-every", "5"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = launch_counts(flash_attention=2 * cfg.n_layers * TRAIN_STEPS,
                         flash_attention_bwd=cfg.n_layers * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"[train] lm-100m launches {launches}, want "
                             f"{want}")
    losses = res["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
            or not np.isfinite(res["grad_norms"]).all():
        raise AssertionError(f"[train] lm-100m losses {losses}")
    step_ms = float(np.median(res["step_s"][1:])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] lm-100m ({cfg.param_count()} params, float32 masters, "
        f"bf16 compute) B {TRAIN_BATCH} x S {TRAIN_SEQ}, {TRAIN_STEPS} AdamW "
        f"steps in {wall:.3f} s: {step_ms:.3f} ms a step (median of steps "
        f"1-{TRAIN_STEPS - 1}; step 0 {res['step_s'][0] * 1e3:.3f} ms), "
        f"{tokens / step_ms * 1e3:.1f} tokens/s; peak device memory {peak} "
        f"B, {peak - base} B above the {base} B allocated before; loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; launches K7 "
        f"{launches['flash_attention']}, K7b "
        f"{launches['flash_attention_bwd']}")

    # Step 0 again from the same seed and batch, through the kernels and
    # through their plain versions.
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        dtype=torch.float32)
    batch = data.TokenPipeline(seed=0, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               vocab=cfg.vocab, device=device).batch_at(0)
    kern = loss_and_grad_norm(transformer.loss_fn, params, batch, cfg,
                              plain=False)
    plain = loss_and_grad_norm(transformer.loss_fn, params, batch, cfg,
                               plain=True)
    gaps = (abs(kern[0] - plain[0]) / abs(plain[0]),
            abs(kern[1] - plain[1]) / abs(plain[1]),
            abs(kern[0] - losses[0]) / abs(losses[0]))
    if gaps[0] > SWAP_LOSS_TOL or gaps[1] > SWAP_GNORM_TOL \
            or gaps[2] > SWAP_LOSS_TOL:
        raise AssertionError(f"[train] step 0 (loss, grad norm): kernels "
                             f"{kern}, plain {plain}, launch.train "
                             f"{losses[0]}, {res['grad_norms'][0]}")
    log(f"[train] step 0 through K7/K7b: loss {kern[0]:.6f}, grad norm "
        f"{kern[1]:.6f}; through their plain versions: {plain[0]:.6f}, "
        f"{plain[1]:.6f} (relative gaps {gaps[0]:.3e}, {gaps[1]:.3e}; "
        f"tolerances {SWAP_LOSS_TOL}, {SWAP_GNORM_TOL}); launch.train's step "
        f"0 loss {losses[0]:.6f}")

    # One step profiled: device time by kernel.
    opt = optim.adamw_init(params)
    step_fn = transformer.make_train_step(cfg)
    prof = profiled(lambda: step_fn(params, opt, batch))
    rows = device_time_by_kernel(prof, 1)
    device_ms = sum(r[0] for r in rows)
    k7_ms = sum(r[0] for r in rows if "flash_fwd" in r[2])
    k7b_ms = sum(r[0] for r in rows if "flash_bwd" in r[2])
    gemm_ms = sum(r[0] for r in rows if any(
        part in r[2].lower() for part in MATMUL_KERNELS))
    log(f"[train] one lm-100m step profiled: device {device_ms:.3f} ms in "
        f"{sum(r[1] for r in rows):g} kernels; K7 {k7_ms:.3f} ms, K7b "
        f"{k7b_ms:.3f} ms, matmuls {gemm_ms:.3f} ms")
    for ms, n, key in rows[:10]:
        log(f"[train]   {ms:.4f} ms  x{n:g}  {key[:90]}")
    with FlopCounterMode(display=False) as fc:       # [dryrun]'s count
        step_fn(params, opt, batch)
    flops = fc.get_total_flops()
    log(f"[train] one lm-100m step under FlopCounterMode: {flops} FLOPs "
        f"(K7 and K7b by their ops' formulas)")
    del params, opt, batch, prof

    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        resume_gap = train_resume(tmp)
    numbers = dict(step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
                   peak_bytes=peak, peak_above_bytes=peak - base,
                   first_loss=losses[0],
                   last_loss=losses[-1], step0_kernels=kern,
                   step0_plain=plain, device_ms=device_ms, k7_ms=k7_ms,
                   k7b_ms=k7b_ms, matmul_ms=gemm_ms, resume_gap=resume_gap,
                   flops_step=flops)
    return launches, numbers


def lm_predicted_peak(cfg, batch: int, seq: int) -> int:
    """Peak bytes of an LM train step by arithmetic, at the end of its
    forward: the float32 state (16 B a parameter), each layer's bf16 input
    kept by remat (2 B a token and unit of width), and the chunked cross
    entropy's float32 logits and their exp kept for its backward (8 B a
    token and vocabulary entry), with the last chunk's bf16 logits and
    their float32 copy in flight (6 B)."""
    tokens = batch * seq
    chunk = tokens // min(LM_CE_CHUNKS, seq)
    return (16 * cfg.param_count() + 2 * cfg.n_layers * cfg.d_model * tokens
            + 8 * cfg.vocab * tokens + 6 * cfg.vocab * chunk)


def train_lm_4k(device) -> tuple[dict, dict]:
    """(b) lm-100m at train_4k's sequence (4,096 tokens) from its published
    batch of 256 down by halves until a step fits the card, which must be
    at TRAIN_4K_BATCH: TRAIN_4K_STEPS AdamW steps, K7 twice and K7b once a
    layer a step, losses finite; ms a step, tokens/s and the peak beside
    the predicted one.  Returns (the launches, numbers)."""
    from repro_torch.configs.shapes import LM_SHAPES
    cfg = train.LM_100M
    shape = next(s for s in LM_SHAPES if s.name == "train_4k")
    seq, batch = shape.seq_len, shape.global_batch
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    params = transformer.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        dtype=torch.float32)
    state = (params, optim.adamw_init(params))
    del params
    step = transformer.make_train_step(cfg)
    while True:
        predicted = lm_predicted_peak(cfg, batch, seq)
        pipe = data.TokenPipeline(seed=0, batch=batch, seq_len=seq,
                                  vocab=cfg.vocab, device=device, prefetch=0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        try:
            losses, times = [], []
            for i in range(TRAIN_4K_STEPS):
                t0 = time.perf_counter()
                *new, m = step(*state, pipe.batch_at(i))
                losses.append(m["loss"].item())
                times.append(time.perf_counter() - t0)
                state = tuple(new)
            break
        except torch.OutOfMemoryError:
            if batch == 1:
                raise
            log(f"[train] lm-100m {shape.name}: batch {batch} x S {seq} "
                f"does not fit: out of memory (predicted peak {predicted} B "
                f"above the {start} B allocated before the model); cut to "
                f"{batch // 2}")
            batch //= 2
    if batch != TRAIN_4K_BATCH:
        raise AssertionError(f"[train] lm-100m {shape.name}: ran at batch "
                             f"{batch}, not at {TRAIN_4K_BATCH}")
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    want = launch_counts(flash_attention=2 * cfg.n_layers * TRAIN_4K_STEPS,
                         flash_attention_bwd=cfg.n_layers * TRAIN_4K_STEPS)
    if launches != want:
        raise AssertionError(f"[train] lm-100m {shape.name} launches "
                             f"{launches}, want {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"[train] lm-100m {shape.name} losses {losses}")
    step_ms = float(np.median(times[1:])) * 1e3
    tokens = batch * seq
    log(f"[train] lm-100m {shape.name}: {TRAIN_4K_STEPS} AdamW steps at "
        f"batch {batch} (published {shape.global_batch}) x S {seq}: "
        f"{step_ms:.3f} ms a step (median of steps 1-{TRAIN_4K_STEPS - 1}; "
        f"step 0 {times[0] * 1e3:.3f} ms), {tokens / step_ms * 1e3:.1f} "
        f"tokens/s; loss {losses[0]:.6f} -> {losses[-1]:.6f}; launches K7 "
        f"{launches['flash_attention']}, K7b "
        f"{launches['flash_attention_bwd']}; peak device memory {peak} B, "
        f"{peak - start} B above the {start} B before the model, against "
        f"{predicted} B predicted ({(peak - start) / predicted:.3f}x)")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(batch=batch, seq=seq, step_ms=step_ms,
                          tokens_per_s=tokens / step_ms * 1e3,
                          losses=losses, peak_bytes=peak,
                          peak_above_bytes=peak - start,
                          predicted_bytes=predicted)


def ste_train(device, spec, hw, params, rng, protos):
    """BNN_STEPS AdamW steps of STE training (examples/train_bnn.py's loss,
    optimizer settings and data) from ``params``; returns (params, losses,
    ms a step, median of steps 1 on)."""
    params = tree.tree_map(lambda t: t.to(device), params)
    opt = optim.adamw_init(params)
    lr = optim.cosine_schedule(1e-3, warmup=20, total=BNN_STEPS)

    def loss_fn(p, x, y):
        logits = bnn_model.float_forward(p, spec, x, train=True)
        gold = torch.take_along_dim(logits, y[:, None], dim=-1)[:, 0]
        return (torch.logsumexp(logits, dim=-1) - gold).mean(), None

    losses, step_s = [], []
    for _ in range(BNN_STEPS):
        x, y = prototype_images(device, rng, protos, BNN_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss, _), grads = tree.value_and_grad(loss_fn, params, x, y)
        params, opt, _ = optim.adamw_update(
            params, grads, opt, lr=lr, weight_decay=0.0,
            clip_latent_paths=lambda path: "w" in path)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    if not np.isfinite(losses).all() or any(
            float(p["w"].abs().max()) > 1.0 for p in params if "w" in p):
        raise AssertionError(f"[train] alexnet STE losses {losses}")
    return params, losses, float(np.median(step_s[1:])) * 1e3


def prototype_images(device, rng, protos, n):
    """``n`` uint8 images of the synthetic classes (a prototype plus
    N(0, 25²) noise) and their labels, as examples/train_bnn.py draws
    them."""
    y = rng.integers(0, len(protos), (n,))
    x = protos[y] + rng.normal(0, 25, (n, *protos.shape[1:]))
    return (torch.from_numpy(np.clip(x, 0, 255).astype(np.uint8)).to(device),
            torch.from_numpy(y).to(device))


def deploy(device, spec, hw, params, x) -> dict:
    """``PhoneBitEngine.from_trained`` under ``cuda_direct_pool``, eager at
    bucket 8 over ``x``: the wrappers' launches, the head's largest gap to
    the flat packed oracle (``legacy_call``, the converted params walked in
    plain PyTorch), the argmax agreement with ``float_forward`` on the
    same params, the head's largest gap to it and the share of images
    whose head lies within ``BNN_HEAD_TOL`` of it."""
    engine = PhoneBitEngine.from_trained(params, spec, hw, device=device,
                                         matmul_mode="cuda_direct_pool")
    exe = engine.compile(BATCH, capture=False)
    exe(x[:BATCH])
    torch.cuda.synchronize()
    reset_launches()
    head = torch.cat([exe(x[i:i + BATCH])
                      for i in range(0, len(x), BATCH)])
    torch.cuda.synchronize()
    launches = read_launches()
    flat = torch.cat([engine.legacy_call(x[i:i + BATCH])
                      for i in range(0, len(x), BATCH)])
    oracle = bnn_model.float_forward(params, spec, x)
    gap = (head - oracle).abs().amax(-1)
    return dict(launches=launches,
                flat_err=(head - flat).abs().max().item(),
                agreement=(head.argmax(-1) == oracle.argmax(-1))
                .float().mean().item(),
                float_err=gap.max().item(),
                float_within=(gap <= BNN_HEAD_TOL).float().mean().item())


def train_alexnet(device) -> tuple[dict, dict]:
    """(c) Paper AlexNet trained with the STE sign and AdamW on synthetic
    class prototypes (examples/train_bnn.py's recipe at 227²), then
    deployed with ``PhoneBitEngine.from_trained`` under
    ``cuda_direct_pool``, from the seeded params the ``[trained]`` phase
    deploys (``workloads.checkpoint_params``: randomised BN statistics).
    Held: the deployed argmax equal to ``float_forward``'s on the trained
    params for every image (examples/train_bnn.py's assertion), and the
    head within ``BNN_HEAD_TOL`` of the flat packed oracle of the same
    conversion.  Printed, not held: the head's gap to the float oracle.
    The BN fold runs in float32 (the reference's, bit for bit), and so
    does the oracle's BN, each rounding differently; a pre-activation that
    lies within their rounding of its threshold takes another sign in the
    two, and one flipped bit before the float head moves it by up to twice
    a head weight (ROADMAP, caveat (h)).  From examples/train_bnn.py's
    identity BN the same numbers are printed too: there every BN offset
    starts at 0 and moves by about the learning rate, below the float32
    fold's resolution at AlexNet's first layer (its threshold reaches
    9.3e4, whose float32 step is 0.0078)."""
    spec = paper_nets.alexnet_spec()
    hw = (227, 227)
    rng = np.random.default_rng(0)
    protos = rng.integers(0, 256, (BNN_CLASSES, *hw, 3)).astype(np.float32)
    x, _ = prototype_images(device, rng, protos, BNN_EVAL)
    params, losses, step_ms = ste_train(
        device, spec, hw, workloads.checkpoint_params(spec, seed=0), rng,
        protos)
    d = deploy(device, spec, hw, params, x)
    launches = d.pop("launches")
    if launches != WANT_BNN_DEPLOY:
        raise AssertionError(f"[train] alexnet deployment launches "
                             f"{launches}, want {WANT_BNN_DEPLOY}")
    if d["agreement"] != 1.0 or d["flat_err"] > BNN_HEAD_TOL:
        raise AssertionError(f"[train] deployed alexnet: {d}")
    log(f"[train] alexnet 227x227 STE training from the seeded params "
        f"(randomised BN statistics), batch {BNN_BATCH}, {BNN_STEPS} AdamW "
        f"steps (clip_latent_paths 'w'): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, {step_ms:.3f} ms a step (median of steps "
        f"1-{BNN_STEPS - 1}); deployed under cuda_direct_pool on "
        f"{BNN_EVAL} images: argmax agreement {d['agreement']:.1%} with "
        f"float_forward; max |head - flat packed oracle| "
        f"{d['flat_err']:.3e} (bound {BNN_HEAD_TOL}); max |head - "
        f"float_forward| {d['float_err']:.3e}, {d['float_within']:.1%} of "
        f"the images within {BNN_HEAD_TOL} of it (printed); launches K4 "
        f"{launches['bitplane_pack']}, K3 bit-plane variant "
        f"{launches['direct_conv_bn_binarize_planes']}, K3 "
        f"{launches['direct_conv_bn_binarize']}, K2 "
        f"{launches['fused_matmul_bn_binarize']}")
    ident, ident_losses, _ = ste_train(
        device, spec, hw, bnn_model.init_params(np.random.default_rng(0),
                                                spec), rng, protos)
    di = deploy(device, spec, hw, ident, x)
    di.pop("launches")
    log(f"[train] the same from examples/train_bnn.py's identity BN "
        f"(printed, not held): loss {ident_losses[0]:.4f} -> "
        f"{ident_losses[-1]:.4f}; argmax agreement {di['agreement']:.1%}; "
        f"max |head - flat packed oracle| {di['flat_err']:.3e}; max |head "
        f"- float_forward| {di['float_err']:.3e}, {di['float_within']:.1%} "
        f"of the images within {BNN_HEAD_TOL}")
    return launches, dict(step_ms=step_ms, first_loss=losses[0],
                          last_loss=losses[-1], **d,
                          identity_bn={f"{k}": v for k, v in di.items()})


def phase_train(device, errs: dict) -> tuple[dict, dict]:
    """The training path: (a) K7b on the card (its largest error into
    ``errs``), (b) lm-100m through the train driver and at train_4k's
    sequence, (c) AlexNet STE training and deployment.  Returns (launches
    of each counted run, numbers)."""
    t0 = time.perf_counter()

    def note(name: str, e: float) -> None:
        errs[name] = max(errs.get(name, 0), e)

    check_k7b(Inputs(device, seed=11), note)
    launches, numbers = {}, {}
    launches["train_lm100m"], numbers["lm100m"] = train_lm(device)
    gc.collect()
    torch.cuda.empty_cache()
    launches["train_lm100m_4k"], numbers["lm100m_4k"] = train_lm_4k(device)
    launches["train_alexnet_deploy"], numbers["alexnet"] = \
        train_alexnet(device)
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    return launches, numbers


# The zoo phase: the vision and diffusion archs at full width and depth,
# one at a time.  Every train step checkpoints each layer (ViT "nothing",
# DiT its configs' "dots", the convnets' blocks "nothing"), so the train
# cells run at the published batches: cls_224 256 images, cls_384 64,
# train_256 256 latents, train_1024 32.  A cell whose step one card cannot
# hold even so halves its batch until it fits, and says so; it must end at
# the batch ZOO_CUTS lists.  gen_1024 runs ZOO_GEN_1024_STEPS of its
# 50 DDIM steps, gen_fast all 4.
ZOO_ARCHS = ("vit-l16", "vit-h14", "dit-l2", "dit-xl2", "convnext-b",
             "efficientnet-b7")
# Train steps a cell: step 0 the warm-up, then the timed ones (cut from 3
# to 2 to make room in the smoke's time for the batch-axes cells;
# PERF.md §4 lists the cut).
ZOO_TRAIN_STEPS = 2
ZOO_VISION_TRAIN = ("cls_224", "cls_384")
ZOO_DIT_TRAIN = ("train_256", "train_1024")
ZOO_GEN_1024_STEPS = 2
ZOO_SERVE_BATCHES = (1, 128)
# Step 0 of the hd-80 and hd-72 models at batch ZOO_SWAP_BATCH through
# K7/K7b against the same step through their plain versions: the loss
# within the lm-100m check's SWAP_LOSS_TOL (2e-3 relative), the gradient
# norm within ZOO_SWAP_GNORM_TOL (1e-2 relative, half of lm-100m's
# SWAP_GNORM_TOL), and one forward's logits (eps) within ZOO_SWAP_OUT_TOL
# as max error over max
# |plain| (K7's bf16 tolerance carried through 28-32 layers, the bound the
# LM phase holds prefill to).  The same step with remat against the same
# step without it is held to the same loss and gradient-norm limits.
ZOO_SWAP_ARCHS = ("vit-h14", "dit-xl2")
ZOO_SWAP_BATCH = 2
# What remat costs and saves: for ZOO_SWAP_ARCHS, ZOO_TRAIN_STEPS steps at
# a batch that fits without remat, with it and without it (ms a step and
# the peak; not counted).
ZOO_REMAT_COST_BATCH = 32
ZOO_SWAP_GNORM_TOL = 1e-2
ZOO_SWAP_OUT_TOL = 0.04
# DiT's adaLN modulation and output weights start at 0 (adaLN-zero): a
# fresh model predicts 0 and no gradient reaches attention.  The phase
# draws those leaves N(0, ZOO_ADALN_STD²) so that attention's output and
# gradient reach the model's.
ZOO_ADALN_STD = 0.02
ZOO_ADALN_LEAVES = ("ada_w", "ada_b", "final_ada_w", "final_ada_b",
                    "final_w", "final_b")

# Peak device memory of each train cell above the memory allocated before
# the model, at the batch it runs at, as PERF.md's arithmetic predicted it
# before the cells first ran (the float32 state, each checkpointed layer's
# bf16 input, under "dots" a DiT layer's 9 products, one layer's
# recompute, the optimiser's update): printed beside the measured peak.
ZOO_PREDICTED_PEAK = {
    ("vit-l16", "cls_224"): 11.5e9, ("vit-l16", "cls_384"): 10.9e9,
    ("vit-h14", "cls_224"): 22.7e9, ("vit-h14", "cls_384"): 22.7e9,
    ("dit-l2", "train_256"): 44.5e9, ("dit-l2", "train_1024"): 81.6e9,
    ("dit-xl2", "train_256"): 58.6e9, ("dit-xl2", "train_1024"): 58.6e9,
    ("convnext-b", "cls_224"): 15.6e9, ("convnext-b", "cls_384"): 11.8e9,
    ("efficientnet-b7", "cls_224"): 66.8e9,
    ("efficientnet-b7", "cls_384"): 49.3e9,
}
# The cells one card cannot hold at their published batch even with remat,
# and the batch each runs at instead (PERF.md §4 gives the bytes that force
# it).  A cell that runs at any other batch fails the phase, so a new cut
# (remat broken, memory regressed) cannot pass unnoticed.
ZOO_CUTS = {("dit-xl2", "train_1024"): 16}


# --------------------------------------------------------------------------
# [shard]: the sharded LM serving path, 4 ranks sharing the card
# --------------------------------------------------------------------------

def shard_bytes(cfg, rules_tp: int, batch: int, seq: int, max_seq: int,
                decode: bool, dp: int = 1) -> int:
    """Bytes one rank hands to collectives in a sharded prefill of (batch,
    seq) or one decode step of ``batch`` slots on a (dp, tp) mesh whose
    weights are whole over ``data`` (serving's ``fsdp=None``), from the
    shapes alone (``transformer._Sharded``'s collectives: bf16 data
    movement, float32 sums).  The rows are cut over ``data`` where dp
    divides the batch, and the logits all-gathered over it."""
    tp = rules_tp
    rows_dp = dp if batch % dp == 0 else 1
    batch //= rows_dp
    d, hd = cfg.d_model, cfg.d_head
    h, kv = cfg.n_heads, cfg.n_kv_heads
    tp_heads = tp > 1 and h % tp == 0
    kv_sharded = tp_heads and kv % tp == 0
    v_pad = transformer.padded_vocab(cfg.vocab, tp)
    rows = batch if decode else batch * seq
    total = rows * d * 2                                  # embedding sum
    per_layer = 0
    if cfg.qkv_dim % tp == 0:
        per_layer += rows * d * 4                         # wo row-parallel
        if not tp_heads and tp > 1:                       # wq gathered
            per_layer += d * cfg.qkv_dim // tp * 2
    if not kv_sharded and cfg.kv_dim % tp == 0 and tp > 1:
        per_layer += 2 * d * cfg.kv_dim // tp * 2         # wk, wv gathered
    if decode:
        hq = h // tp if tp_heads else h
        if kv_sharded:
            per_layer += batch * (hq + 2 * kv // tp) * hd * 2
        elif tp_heads:
            per_layer += batch * hq * hd * 2
        if max_seq % tp == 0:                             # decode combine
            per_layer += batch * h * 4 + batch * h * (hd + 1) * 4
    elif kv_sharded:              # K/V from heads to the cache's layout
        per_layer += 2 * batch * (kv // tp) * max_seq * hd * 2
    if cfg.moe:
        split = rows % tp == 0
        t_local = rows // tp if split else rows
        e_pad = cfg.padded_experts(tp)
        cap = moe.capacity(t_local, cfg.top_k, e_pad, cfg.capacity_factor)
        per_layer += 2 * e_pad * cap * d * 2              # a2a x2
        if split:
            per_layer += t_local * d * 2                  # output gather
    elif cfg.d_ff % tp == 0:
        per_layer += rows * d * 4                         # MLP row-parallel
    logits = batch * (v_pad // tp) * 2
    if rows_dp > 1:                                       # over the rows
        logits += batch * v_pad * 2
    return total + cfg.n_layers * per_layer + logits


def shard_model(rules, device, cfg, full, tokens, teacher,
                requests, routes) -> dict:
    """One model on one rank: its slices of ``full`` (the parent's weights,
    received through CUDA IPC), the sharded prefill and decode steps, then
    a sharded ``LMServer``.  Returns the rank's counts and times, and on
    rank 0 the logits."""
    from repro_torch.distributed import sharding

    world = rules.comm(("data", "model"))
    params = sharding.shard_tree(full, transformer.param_specs(cfg, rules),
                                 rules)
    torch.cuda.synchronize()
    out = dict(weight_bytes=sum(t.numel() * t.element_size()
                                for t in tree.leaves(params)))
    prefill = transformer.make_prefill_step(cfg, LM_MAX_SEQ, rules)
    decode = transformer.make_decode_step(cfg, LM_MAX_SEQ, rules)
    torch.cuda.reset_peak_memory_stats()
    world.psum(torch.zeros(1, device=device))                   # align
    reset_launches()
    sent = sharding.Collective.payload_bytes
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["prefill_bytes"] = sharding.Collective.payload_bytes - sent
    out["prefill_launches"] = read_launches()
    steps, step_ms, step_bytes = [logits.float().cpu()], [], []
    reset_launches()
    for i in range(len(teacher)):
        sent = sharding.Collective.payload_bytes
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, teacher[i], LM_SEQ + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_bytes.append(sharding.Collective.payload_bytes - sent)
        steps.append(logits.float().cpu())
    out["decode_launches"] = read_launches()
    out["decode_ms"], out["decode_bytes"] = step_ms, step_bytes
    out["cache_shape"] = tuple(cache["k"].shape)
    out["finite"] = bool(torch.isfinite(cache["k"]).all()
                         and torch.isfinite(cache["v"]).all())
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del cache
    pinned = dict(routes)
    f32 = shard_f32_logits(prefill, decode, cfg, params, tokens, teacher,
                           dict(pinned=pinned, shard=world.index))
    out["f32_logits"] = f32 if world.index == 0 else None
    out["flips32"] = pinned.get("flips", 0)
    server = LMServer(cfg, params, n_slots=SHARD_SLOTS,
                      max_seq=SHARD_SERVER_MAX_SEQ, device=device,
                      rules=rules)
    reset_launches()
    t0 = time.perf_counter()
    reqs = [server.submit(p, max_new=m) for p, m in requests]
    server.drain()
    out["server"] = dict(
        outcomes=[r.outcome for r in reqs],
        tokens=[r.result for r in reqs], wall_s=time.perf_counter() - t0,
        steps=server.pos, launches=read_launches(),
        served=server.metrics()["served"])
    if not cfg.moe:
        out["lanes"] = shard_lanes(cfg, params, rules, device)
    out["logits"] = torch.stack(steps) if world.index == 0 else None
    return out


def shard_lanes(cfg, params, rules, device) -> dict:
    """A two-lane ``LMReplicaGroup(cfg, rules, params)`` on the rank: the
    requests served while lm1's decode faults from its
    SHARD_LANE_FAULT_AFTER-th step on; its flight migrates to lm0 (every
    rank reads rank 0's clock, so every rank routes, quarantines and
    adopts alike).  Returns what each request got, the emitted prefixes
    the migration carried and whether each was kept."""
    from repro_torch.distributed import LMReplicaGroup

    grp = LMReplicaGroup(cfg, rules, params, n_slots=2,
                         max_seq=SHARD_SERVER_MAX_SEQ, device=device,
                         checkpoint_every=2, max_restore_attempts=1)
    prefixes = {}
    hook = grp.lanes["lm1"].server.evacuate

    def spy(items):
        prefixes.update({r.id: list(seq.tokens) for r, seq in items})
        return hook(items)
    grp.lanes["lm1"].server.evacuate = spy
    rng = np.random.default_rng(7)
    reset_launches()
    t0 = time.perf_counter()
    with faults.inject([FaultSpec("lm.step", "device_fault",
                                  after=SHARD_LANE_FAULT_AFTER,
                                  match={"tenant": "lm1"})]):
        reqs = [(grp.submit([int(t) for t in rng.integers(0, cfg.vocab, n)],
                            max_new=m, lane=lane), m)
                for lane, n, m in SHARD_LANE_REQUESTS]
        grp.drain()
    m = grp.metrics()["routing"]
    return dict(
        outcomes=[r.outcome for r, _ in reqs],
        full=[len(r.result) == mn for r, mn in reqs],
        tokens=[[int(t) for t in r.result] for r, _ in reqs],
        prefixes=[len(prefixes[r.id]) for r, _ in reqs if r.id in prefixes],
        kept=[r.result[:len(prefixes[r.id])] == prefixes[r.id]
              for r, _ in reqs if r.id in prefixes],
        migrations=grp.migrations, lm1_quarantined=m["lm1"]["quarantined"],
        wall_s=time.perf_counter() - t0, launches=read_launches())


def shard_f32_logits(prefill, decode, cfg, params, tokens, teacher,
                     routing: dict) -> torch.Tensor:
    """The float32 check's logits (``F32_CHECK``): the prefill of the
    prompt's first SHARD_F32_SEQ tokens, then SHARD_F32_STEPS
    teacher-forced decode steps, each step's (B, Vp) on the host.
    ``routing``: ``moe_routing``'s arguments (an MoE model's experts
    recorded on one device, pinned on a rank)."""
    with float32_check(), torch.inference_mode(), _routing(
            cfg, params, **routing):
        logits, cache = prefill(params, tokens[:, :SHARD_F32_SEQ])
        steps = [logits.float().cpu()]
        for i in range(SHARD_F32_STEPS):
            logits, cache = decode(params, cache, teacher[i],
                                   SHARD_F32_SEQ + i)
            steps.append(logits.float().cpu())
    return torch.stack(steps)


def f32_logit_check(tag: str, got: torch.Tensor, want: torch.Tensor,
                    vocab: int) -> dict:
    """The sharded float32 logits against one device's (``F32_CHECK``):
    max |sharded - single| / max |single| over the real vocab's columns
    and the argmax agreement, printed; fails past the limits."""
    got, want = got[..., :vocab], want[..., :vocab]
    err = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"{tag} float32 step-0 check ({F32_ROUTE}; prompt cut to "
        f"{SHARD_F32_SEQ} tokens, then {SHARD_F32_STEPS} decode steps: "
        f"{got.shape[0] * got.shape[1]} rows): max |sharded - single| / max "
        f"|single| {err:.4e} (limit {F32_CHECK['out']}), argmax agreement "
        f"{agree:.4f} (limit {F32_CHECK['agreement']})")
    if not err <= F32_CHECK["out"] or agree < F32_CHECK["agreement"]:
        raise AssertionError(f"{tag}: float32 logits off by {err:.4e}, "
                             f"agreement {agree:.4f}")
    return dict(rel_err=err, agreement=agree)


def shard_rank(rank, device, jobs, dp_job):
    """One rank of the [shard] phase: a (1, SHARD_RANKS) mesh, then each
    job's model in turn (``shard_model``); then ``dp_job`` on
    SHARD_DP_MESH, the weights whole over ``data``."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_host_mesh(data=1, model=SHARD_RANKS, device=device)
    rules = sharding.rules_for_mesh(mesh)
    out = {"rank": rank, "mesh": mesh.describe()}
    for arch, *job in jobs:
        out[arch] = shard_model(rules, device, *job)
        gc.collect()
        torch.cuda.empty_cache()
    dp, tp = SHARD_DP_MESH
    mesh = mesh_lib.make_host_mesh(data=dp, model=tp, device=device)
    rules = dataclasses.replace(sharding.rules_for_mesh(mesh), fsdp=None)
    out["dp_mesh"] = mesh.describe()
    out["dp"] = shard_model(rules, device, *dp_job[1:])
    return out


@torch.inference_mode()
def shard_single(cfg, params, tokens, teacher) -> tuple[torch.Tensor, dict]:
    """The one-device path on the same weights: the prefill's last logits,
    then each teacher-forced decode step's, and their times."""
    prefill = transformer.make_prefill_step(cfg, LM_MAX_SEQ)
    decode = transformer.make_decode_step(cfg, LM_MAX_SEQ)
    prefill(params, tokens[:, :SHARD_WARM_SEQ])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens)
    torch.cuda.synchronize()
    numbers = dict(prefill_ms=(time.perf_counter() - t0) * 1e3)
    steps, step_ms = [logits.float().cpu()], []
    for i in range(len(teacher)):
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, teacher[i], LM_SEQ + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits.float().cpu())
    numbers["decode_ms"] = step_ms
    return torch.stack(steps), numbers


@torch.inference_mode()
def shard_drops(cfg, params, tokens, published: float) -> dict:
    """Layer 0's routing of the prefill's tokens cut as the sharded MoE
    cuts them (``tokens_spec(B·S)``: ``SHARD_RANKS`` source shards):
    assignments dropped at the published capacity factor and at the
    phase's (>= E/k, where no bucket can overflow)."""
    lp = {n: t[0] for n, t in params["layers"].items()}
    x = transformer._embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x, _, _ = transformer._attention(x, lp, cfg, positions)
    h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
    t_local = h.shape[0] // SHARD_RANKS
    e_pad = lp["router"].shape[1]
    out = {}
    for name, factor in (("published", published),
                         ("phase", cfg.capacity_factor)):
        cap = moe.capacity(t_local, cfg.top_k, e_pad, factor)
        dropped = 0
        for s in range(SHARD_RANKS):
            _, ids, _ = moe._route(h[s * t_local:(s + 1) * t_local],
                                   lp["router"], n_real=cfg.n_experts,
                                   top_k=cfg.top_k)
            _, keep = moe._dispatch_indices(ids, n_experts=e_pad, cap=cap)
            dropped += int((~keep).sum())
        out[name] = dict(factor=factor, capacity=cap, dropped=dropped,
                         assignments=h.shape[0] * cfg.top_k)
    return out


def phase_shard(device, smi: str) -> tuple[dict, dict]:
    """minitron-8b and granite-moe-3b-a800m at full width and depth over
    ``SHARD_RANKS`` ranks on a (1, 4) mesh that share the card (gloo,
    collectives staged through pinned host memory): each model's weights
    drawn once here, run on one device, then handed to the ranks through
    CUDA IPC, each rank keeping its slices; the sharded prefill (K7 on
    each rank's heads) and ``SHARD_DECODE_STEPS`` teacher-forced decode
    steps against the one-device path on the same weights and tokens,
    within ``SHARD_LIMITS``; the bytes each rank hands
    to collectives equal to ``shard_bytes``; a sharded ``LMServer``
    answering ``SHARD_REQUESTS``.  Returns (each model's prefill launches
    a rank, numbers)."""
    from repro_torch.launch import mesh as mesh_lib

    launches, numbers, jobs, singles = {}, {}, [], {}
    rng = np.random.default_rng(27)
    gc.collect()
    torch.cuda.empty_cache()
    for arch in SHARD_ARCHS:
        cfg = published = configs.get(arch).full
        if cfg.moe:                       # no bucket can overflow
            cfg = dataclasses.replace(cfg, capacity_factor=max(
                cfg.capacity_factor, cfg.n_experts / cfg.top_k))
        gen = torch.Generator(device=device).manual_seed(0)
        params = transformer.init_params(cfg, gen, device, ep=SHARD_RANKS,
                                         vocab_pad_to=SHARD_RANKS)
        tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ),
                               device=device, generator=gen)
        teacher = torch.randint(0, cfg.vocab,
                                (SHARD_DECODE_STEPS, LM_BATCH, 1),
                                device=device, generator=gen)
        requests = [([int(t) for t in rng.integers(0, cfg.vocab, n)], m)
                    for n, m in SHARD_REQUESTS]
        single, single_numbers = shard_single(cfg, params, tokens, teacher)
        # The noise floor: the same one-device path a row at a time (other
        # matmul shapes, so other bf16 roundings), printed beside.
        rows = torch.cat([shard_single(cfg, params, tokens[i:i + 1],
                                       teacher[:, i:i + 1])[0]
                          for i in range(LM_BATCH)], dim=1)[..., :cfg.vocab]
        single_numbers["rowwise_rel_err"] = rel_err(
            rows, single[..., :cfg.vocab])
        single_numbers["rowwise_agreement"] = float(
            (rows.argmax(-1) == single[..., :cfg.vocab].argmax(-1))
            .float().mean())
        routes: dict = {}
        single_numbers["f32_logits"] = shard_f32_logits(
            transformer.make_prefill_step(cfg, LM_MAX_SEQ),
            transformer.make_decode_step(cfg, LM_MAX_SEQ), cfg, params,
            tokens, teacher, dict(record=routes))
        if arch == SHARD_DP_ARCH:
            dp_job = (arch, cfg, params, tokens,
                      teacher[:SHARD_DP_DECODE_STEPS], requests, routes)
            dp_f32 = single_numbers["f32_logits"]
        numbers[arch] = dict(single=single_numbers)
        if cfg.moe:
            drops = numbers[arch]["drops"] = shard_drops(
                cfg, params, tokens, published.capacity_factor)
            if drops["phase"]["dropped"]:
                raise AssertionError(f"[shard] {arch}: drops at factor "
                                     f"{cfg.capacity_factor}")
        singles[arch] = (cfg, single, requests)
        jobs.append((arch, cfg, params, tokens, teacher, requests, routes))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(shard_rank, SHARD_RANKS, jobs, dp_job,
                           device="cuda", timeout_s=SHARD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    del jobs, dp_job
    log(f"[shard] {ranks[0]['mesh']}; {SHARD_RANKS} ranks spawned, both "
        f"models run and joined in {spawn_s:.3f} s ({smi})")
    for arch in SHARD_ARCHS:
        cfg, single, requests = singles[arch]
        # The real vocab's columns (a padded column is -1e30 in both).
        got = ranks[0][arch].pop("logits")[..., :cfg.vocab]
        want = single[..., :cfg.vocab]
        err_steps = [rel_err(g, w) for g, w in zip(got, want)]
        agree_steps = (got.argmax(-1) == want.argmax(-1)).float()
        err, agree = max(err_steps), float(agree_steps.mean())
        for step, row in torch.nonzero(agree_steps == 0).tolist():
            g, w = got[step, row], want[step, row]
            gi, wi = int(g.argmax()), int(w.argmax())
            log(f"[shard] {cfg.name} miss at step {step} row {row}: one "
                f"device's top two {w.topk(2).values.tolist()} (token {wi}),"
                f" its logit at the sharded token {gi}: {float(w[gi])}; "
                f"sharded top two {g.topk(2).values.tolist()}, its logit at "
                f"token {wi}: {float(g[wi])}")
        want_prefill = shard_bytes(cfg, SHARD_RANKS, LM_BATCH, LM_SEQ,
                                   LM_MAX_SEQ, decode=False)
        want_step = shard_bytes(cfg, SHARD_RANKS, LM_BATCH, 1, LM_MAX_SEQ,
                                decode=True)
        for rank in ranks:
            r, srv = rank[arch], rank[arch]["server"]
            pl, dl = r["prefill_launches"], r["decode_launches"]
            log(f"[shard] {cfg.name} rank {rank['rank']}: "
                f"{r['weight_bytes']} B of weights; prefill B {LM_BATCH} x "
                f"S {LM_SEQ} {r['prefill_ms']:.3f} ms wall, K7 "
                f"{pl['flash_attention']} launches, {r['prefill_bytes']} B "
                f"into collectives; decode step median "
                f"{float(np.median(r['decode_ms'])):.3f} ms wall (min "
                f"{min(r['decode_ms']):.3f}, max {max(r['decode_ms']):.3f}), "
                f"K7 {dl['flash_attention']}, {r['decode_bytes'][0]} B into "
                f"collectives a step; cache shard {r['cache_shape']}; peak "
                f"device memory {r['peak_bytes']} B; LMServer "
                f"{srv['served']} served in {srv['steps']} steps, "
                f"{srv['wall_s']:.3f} s ({smi})")
            if pl != launch_counts(flash_attention=cfg.n_layers) \
                    or dl != launch_counts() \
                    or srv["launches"] != launch_counts() \
                    or not r["finite"]:
                raise AssertionError(f"[shard] {cfg.name} rank "
                                     f"{rank['rank']}: launches {pl}, {dl}, "
                                     f"{srv['launches']} or a non-finite "
                                     f"cache")
            if r["prefill_bytes"] != want_prefill \
                    or set(r["decode_bytes"]) != {want_step}:
                raise AssertionError(
                    f"[shard] {cfg.name} rank {rank['rank']}: collective "
                    f"bytes {r['prefill_bytes']} / {set(r['decode_bytes'])}"
                    f", arithmetic {want_prefill} / {want_step}")
            if srv["outcomes"] != ["served"] * len(requests) \
                    or srv["tokens"] != ranks[0][arch]["server"]["tokens"] \
                    or [len(t) for t in srv["tokens"]] \
                    != [m for _, m in requests]:
                raise AssertionError(f"[shard] {cfg.name} rank "
                                     f"{rank['rank']}: LMServer {srv}")
        out = numbers[arch]
        sn = out["single"]
        drops = out.get("drops")
        log(f"[shard] {cfg.name}: one device prefill {sn['prefill_ms']:.3f} "
            f"ms wall, decode step median "
            f"{float(np.median(sn['decode_ms'])):.3f} ms ({smi}); sharded "
            f"against one device over the prefill's last logits and "
            f"{SHARD_DECODE_STEPS} decode steps: max |sharded - single| / "
            f"max |single| {err:.4e} (by step "
            + " ".join(f"{e:.3e}" for e in err_steps)
            + f"), argmax agreement {agree:.4f} ("
            f"misses at steps "
            f"{sorted(set(torch.nonzero(agree_steps == 0)[:, 0].tolist()))}"
            f"); one device a row at a time against B {LM_BATCH}: "
            f"{sn['rowwise_rel_err']:.4e}, agreement "
            f"{sn['rowwise_agreement']:.4f}; collective bytes a rank: "
            f"prefill {want_prefill}, decode "
            f"step {want_step} (arithmetic = counted)"
            + (f"; layer 0 drops at the published factor "
               f"{drops['published']['factor']}: "
               f"{drops['published']['dropped']} of "
               f"{drops['published']['assignments']}, at "
               f"{cfg.capacity_factor}: 0" if drops else ""))
        bound, bar = SHARD_LIMITS[arch]
        log(f"[shard] {cfg.name}: held to max error {bound} and agreement "
            f"{bar}, the one-device floor too")
        if not sn["rowwise_rel_err"] <= bound \
                or sn["rowwise_agreement"] < bar:
            raise AssertionError(
                f"[shard] {cfg.name}: one device a row at a time against "
                f"the batch off by {sn['rowwise_rel_err']:.4e}, agreement "
                f"{sn['rowwise_agreement']:.4f}")
        if not err <= bound or agree < bar:
            raise AssertionError(f"[shard] {cfg.name}: sharded logits off "
                                 f"by {err:.4e}, agreement {agree:.4f}")
        out["f32"] = f32_logit_check(f"[shard] {cfg.name}",
                                     ranks[0][arch].pop("f32_logits"),
                                     sn.pop("f32_logits"), cfg.vocab)
        if cfg.moe:
            out["f32"]["flips"] = [r[arch]["flips32"] for r in ranks]
            log(f"[shard] {cfg.name} float32 check: routing pinned to one "
                f"device's top-k; the ranks' own choice differed for "
                f"{out['f32']['flips']} tokens (each rank's)")
        if "lanes" in ranks[0][arch]:
            out["lanes"] = check_shard_lanes(
                cfg, ranks, arch, smi, f"(data 1, model {SHARD_RANKS})")
        launches[f"shard_prefill_{arch}"] = ranks[0][arch]["prefill_launches"]
        out.update(rel_err=err, rel_err_steps=err_steps, agreement=agree,
                   bound=bound, bar=bar,
                   prefill_bytes=want_prefill, step_bytes=want_step,
                   ranks=[{k: v for k, v in rank[arch].items()
                           if k != "server"}
                          | {"served": rank[arch]["server"]["served"],
                             "server_wall_s": rank[arch]["server"]["wall_s"]}
                          for rank in ranks])
    cfg, single, requests = singles[SHARD_DP_ARCH]
    numbers["dp"] = check_shard_dp(cfg, ranks, single, dp_f32, requests, smi)
    launches[f"shard_prefill_{SHARD_DP_ARCH}_dp"] = \
        ranks[0]["dp"]["prefill_launches"]
    numbers["spawn_s"] = spawn_s
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def check_shard_dp(cfg, ranks, single, f32_single, requests,
                   smi: str) -> dict:
    """[shard]'s SHARD_DP_MESH run: every rank's prefill (K7 on its row
    and heads), decode and LMServer counted, its bytes equal to
    ``shard_bytes``; rank 0's logits against one device's first
    SHARD_DP_DECODE_STEPS steps within SHARD_LIMITS, the float32 check,
    the server's tokens equal on every rank, the lanes' migration."""
    dp, tp = SHARD_DP_MESH
    steps = SHARD_DP_DECODE_STEPS
    got = ranks[0]["dp"].pop("logits")[..., :cfg.vocab]
    want = single[:steps + 1, ..., :cfg.vocab]
    err_steps = [rel_err(g, w) for g, w in zip(got, want)]
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    err = max(err_steps)
    want_prefill = shard_bytes(cfg, tp, LM_BATCH, LM_SEQ, LM_MAX_SEQ,
                               decode=False, dp=dp)
    want_step = shard_bytes(cfg, tp, LM_BATCH, 1, LM_MAX_SEQ, decode=True,
                            dp=dp)
    r0 = ranks[0]["dp"]
    for rank in ranks:
        r, srv = rank["dp"], rank["dp"]["server"]
        pl, dl = r["prefill_launches"], r["decode_launches"]
        log(f"[shard] {cfg.name} on {rank['dp_mesh']} rank {rank['rank']}: "
            f"{r['weight_bytes']} B of weights; prefill B {LM_BATCH} x S "
            f"{LM_SEQ} (one row a data rank) {r['prefill_ms']:.3f} ms wall, "
            f"K7 {pl['flash_attention']} launches, {r['prefill_bytes']} B "
            f"into collectives; decode step median "
            f"{float(np.median(r['decode_ms'])):.3f} ms wall (min "
            f"{min(r['decode_ms']):.3f}, max {max(r['decode_ms']):.3f}), "
            f"{r['decode_bytes'][0]} B a step; cache shard "
            f"{r['cache_shape']}; peak device memory {r['peak_bytes']} B; "
            f"LMServer of {SHARD_SLOTS} slots ({SHARD_SLOTS // dp} a data "
            f"rank) {srv['served']} served in {srv['steps']} steps, "
            f"{srv['wall_s']:.3f} s ({smi})")
        if pl != launch_counts(flash_attention=cfg.n_layers) \
                or dl != launch_counts() \
                or srv["launches"] != launch_counts() or not r["finite"] \
                or r["cache_shape"][1] != LM_BATCH // dp:
            raise AssertionError(f"[shard] {cfg.name} on {SHARD_DP_MESH} "
                                 f"rank {rank['rank']}: launches {pl}, {dl}, "
                                 f"{srv['launches']}, cache "
                                 f"{r['cache_shape']}, finite {r['finite']}")
        if r["prefill_bytes"] != want_prefill \
                or set(r["decode_bytes"]) != {want_step}:
            raise AssertionError(
                f"[shard] {cfg.name} on {SHARD_DP_MESH} rank "
                f"{rank['rank']}: collective bytes {r['prefill_bytes']} / "
                f"{set(r['decode_bytes'])}, arithmetic {want_prefill} / "
                f"{want_step}")
        if srv["outcomes"] != ["served"] * len(requests) \
                or srv["tokens"] != r0["server"]["tokens"] \
                or [len(t) for t in srv["tokens"]] \
                != [m for _, m in requests]:
            raise AssertionError(f"[shard] {cfg.name} on {SHARD_DP_MESH} "
                                 f"rank {rank['rank']}: LMServer {srv}")
    same = r0["server"]["tokens"] == \
        ranks[0][SHARD_DP_ARCH]["server"]["tokens"]
    bound, bar = SHARD_LIMITS[SHARD_DP_ARCH]
    log(f"[shard] {cfg.name} on {SHARD_DP_MESH}: sharded against one device "
        f"over the prefill's last logits and {steps} decode steps: max "
        f"|sharded - single| / max |single| {err:.4e} (by step "
        + " ".join(f"{e:.3e}" for e in err_steps)
        + f"), argmax agreement {agree:.4f} (limits {bound}, {bar}); "
        f"collective bytes a rank: prefill {want_prefill}, decode step "
        f"{want_step} (arithmetic = counted); the LMServer's tokens equal "
        f"on every rank, and to the (1, {SHARD_RANKS}) server's: {same}")
    if not err <= bound or agree < bar:
        raise AssertionError(f"[shard] {cfg.name} on {SHARD_DP_MESH}: "
                             f"logits off by {err:.4e}, agreement "
                             f"{agree:.4f}")
    f32 = f32_logit_check(f"[shard] {cfg.name} on {SHARD_DP_MESH}",
                          r0.pop("f32_logits"), f32_single, cfg.vocab)
    lanes = check_shard_lanes(cfg, ranks, "dp", smi,
                              f"(data {dp}, model {tp})")
    return dict(mesh=SHARD_DP_MESH, rel_err=err, rel_err_steps=err_steps,
                agreement=agree, f32=f32, lanes=lanes,
                prefill_bytes=want_prefill, step_bytes=want_step,
                server_tokens_as_1x4=same,
                ranks=[{k: v for k, v in rank["dp"].items()
                        if k not in ("server", "lanes", "logits",
                                     "f32_logits")}
                       | {"served": rank["dp"]["server"]["served"],
                          "server_wall_s": rank["dp"]["server"]["wall_s"]}
                       for rank in ranks])


def check_shard_lanes(cfg, ranks, arch: str, smi: str, where: str) -> dict:
    """Every rank's two-lane group served every request in full, migrated
    at least one sequence with its emitted prefix kept verbatim,
    quarantined lm1, and agrees with rank 0 on the tokens and the
    migration count; no K7 launched (the lanes prefill through the
    decode step)."""
    r0 = ranks[0][arch]["lanes"]
    for rank in ranks:
        ln = rank[arch]["lanes"]
        if ln["outcomes"] != ["served"] * len(SHARD_LANE_REQUESTS) \
                or not all(ln["full"]) or ln["migrations"] < 1 \
                or len(ln["kept"]) != ln["migrations"] \
                or not all(ln["kept"]) or not all(ln["prefixes"]) \
                or not ln["lm1_quarantined"] \
                or ln["migrations"] != r0["migrations"] \
                or ln["tokens"] != r0["tokens"] \
                or ln["launches"] != launch_counts():
            raise AssertionError(f"[shard] {cfg.name} lanes, rank "
                                 f"{rank['rank']}: {ln}")
    log(f"[shard] {cfg.name} LMReplicaGroup(cfg, rules, params), 2 lanes on "
        f"{where}: lm1's decode faulted from its step "
        f"{SHARD_LANE_FAULT_AFTER + 1} past its restore; {r0['migrations']} "
        f"sequence(s) migrated to lm0 on every rank with their emitted "
        f"prefixes ({r0['prefixes']} tokens) kept verbatim, every request "
        f"served, the same tokens on every rank, lm1 quarantined, in "
        f"{r0['wall_s']:.3f} s; K7 launches 0 ({smi})")
    return dict(migrations=r0["migrations"], prefixes=r0["prefixes"],
                wall_s=[rank[arch]["lanes"]["wall_s"] for rank in ranks])


# --------------------------------------------------------------------------
# [shard train]: the sharded LM train step, 4 ranks sharing the card
# --------------------------------------------------------------------------

class _MeshShape:
    """A stand-in mesh of axis sizes alone (``Rules``' arithmetic); with
    ``pod`` the three-axis one."""

    def __init__(self, dp: int, tp: int, pod: int = 0):
        self.shape = {"data": dp, "model": tp}
        self.axis_names = ("data", "model")
        if pod:
            self.shape = {"pod": pod, **self.shape}
            self.axis_names = ("pod", "data", "model")


def _mesh_dict(shape) -> dict:
    """A job's mesh as axis sizes: (data, model) or a dict."""
    return dict(shape) if isinstance(shape, dict) else dict(
        data=shape[0], model=shape[1])


def _mesh_name(shape) -> str:
    return ", ".join(f"{a} {n}" for a, n in _mesh_dict(shape).items())


def shard_train_bytes(cfg, dp: int, tp: int, batch: int, seq: int,
                      pod: int = 0) -> int:
    """Bytes one rank hands to collectives in one sharded train step
    (``transformer.make_train_step(cfg, rules)``) of a global (batch, seq)
    on a (dp, tp) mesh, or (pod, dp, tp) with ``pod``, from the shapes
    alone (``transformer._Sharded``'s and ``chunked_ce``'s collectives,
    their differentiable backwards, ``sync_grads`` and the global norm).
    The rank's rows are ``batch_spec(batch)``'s cut (every row where it
    keeps no axis).  float32 masters, so every FSDP
    gather and reduce-scatter moves float32; activations move in bf16,
    their sums in float32.  Each layer's forward collectives run again in
    the remat's recompute, but for the row-parallel sums under "dots" and
    for the MoE's last two (its output's gather and the balance loss's
    mean): the recompute stops once it has remade every tensor the
    backward saved (``torch.utils.checkpoint``'s early stop)."""
    from repro_torch.distributed import sharding

    rules = sharding.Rules(mesh=_MeshShape(dp, tp, pod),
                           batch=("pod", "data") if pod else ("data",))
    specs = transformer.param_specs(cfg, rules)
    full = transformer.abstract_params(cfg, ep=tp, vocab_pad_to=tp)
    d, hd = cfg.d_model, cfg.d_head
    tp_heads = tp > 1 and cfg.n_heads % tp == 0
    kv_sharded = tp_heads and cfg.n_kv_heads % tp == 0
    parts = rules.axis_size(rules.batch_spec(batch))
    if cfg.moe and parts != rules.dp:
        raise ValueError("shard_train_bytes: an MoE step's rows must cut "
                         "over every batch axis (no recut counted)")
    t = batch // parts * seq                    # the rank's tokens
    f32, bf16 = 4, 2

    def local(name, lay=True):
        spec = specs["layers"][name] if lay else specs[name]
        shape = full["layers"][name].shape if lay else full[name].shape
        n = math.prod(shape[1:] if lay else shape)
        for e in (list(spec)[1:] if lay else spec):
            n //= rules.axis_size(e) if e else 1
        return n

    lay = specs["layers"]
    fsdp = [n for n in lay if "data" in lay[n]]
    fwd = bwd = tail = 0
    if dp > 1:                                  # a layer's FSDP gather
        fwd += sum(local(n) for n in fsdp) * f32
        bwd += sum(local(n) for n in fsdp) * dp * f32
    gathered = [(n, dim) for n, dim, keep in (
        ("wq", cfg.qkv_dim, tp_heads), ("wk", cfg.kv_dim, kv_sharded),
        ("wv", cfg.kv_dim, kv_sharded)) if not keep and lay[n][2] and tp > 1]
    for _, dim in gathered:
        fwd += d * dim // tp * f32
        if tp_heads:                            # reduce-scattered back
            bwd += d * dim * f32
    row = 0
    if lay["wo"][1] and tp > 1:
        row += t * d * f32                      # wo row-parallel
        if not tp_heads:                        # o's columns gathered back
            bwd += t * cfg.qkv_dim // tp * bf16
    if tp_heads:
        bwd += t * d * f32                      # q/k/v input cotangent
        if cfg.qk_norm:
            bwd += 2 * hd * f32
    if cfg.moe:
        world = dp * tp
        split = (batch * seq) % world == 0 and tp > 1
        t_local = t // tp if split else t
        e_pad = cfg.padded_experts(tp)
        cap = moe.capacity(t_local, cfg.top_k, e_pad, cfg.capacity_factor)
        if tp > 1:
            fwd += 2 * e_pad * cap * d * bf16   # the two all_to_all
            bwd += 2 * e_pad * cap * d * bf16
        if world > 1:
            tail += f32                         # the balance loss's mean
        if split:
            tail += t_local * d * bf16          # the output gathered
            bwd += t_local * d * bf16 + d * e_pad * f32   # x, router
    elif lay["w_up"][2] and tp > 1:
        row += t * d * f32                      # w_down row-parallel
        bwd += t * d * f32                      # the MLP input cotangent
    fwd += row
    recompute = fwd - (row if cfg.remat_policy == "dots" else 0)
    total = cfg.n_layers * (fwd + recompute + bwd + tail)
    # the embedding, and the head (the embedding again where tied)
    table = local("embed", False)
    head = table if cfg.tie_embeddings else local("lm_head", False)
    if dp > 1:
        total += (table + head) * f32 * (1 + dp)
    if tp > 1:
        total += t * d * bf16                   # the masked lookup's sum
        total += t * d * f32                    # the CE input cotangent
        total += 3 * t * f32                    # each chunk's max, sums
    if rules.dp > 1:
        total += 2 * f32                        # the CE sums, batch axes
        replicated = [n for n in lay if "data" not in lay[n]]
        total += (cfg.n_layers * sum(local(n) for n in replicated)
                  + d) * f32                    # sync_grads
    if pod > 1:                                 # FSDP leaves over "pod"
        total += (cfg.n_layers * sum(local(n) for n in fsdp) + table
                  + (0 if cfg.tie_embeddings else head)) * f32
    groups = {tuple(a for a in ("data", "model") if a in spec)
              for spec in [*lay.values(), specs["embed"], specs["final_norm"]]
              + ([specs["lm_head"]] if "lm_head" in specs else [])}
    total += sum(f32 for g in groups if g and rules.axis_size(g) > 1)
    return total


def _token_shard_balance(n: int):
    """``moe.moe_apply``'s balance loss as a mesh of ``n`` token shards
    takes it (the mean of each shard's loss: ``_moe_local``'s pmean),
    for the one-device step the sharded one is held to."""
    real = moe.moe_apply

    def moe_apply(x, router, wg, wu, wd, **kw):
        out, _ = real(x, router, wg, wu, wd, **kw)
        auxs = []
        for xs in x.reshape(n, -1, x.shape[-1]):
            _, ids, probs = moe._route(xs, router, n_real=kw["n_experts"],
                                       top_k=kw["top_k"])
            onehot = (ids[..., None] == torch.arange(
                router.shape[1], device=x.device)).float()
            auxs.append(kw["n_experts"] * (onehot.sum(1).mean(0)
                                           * probs.mean(0)).sum())
        return out, torch.stack(auxs).mean()

    return contextlib.nullcontext() if n == 1 else _patched(
        moe, "moe_apply", moe_apply)


@contextlib.contextmanager
def _patched(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _state_specs(cfg, rules):
    from repro_torch.distributed.sharding import P
    specs = transformer.param_specs(cfg, rules)
    return {"params": specs, "opt": optim.OptState(P(), specs, specs)}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def shard_train_model(rank: int, device, job: dict, ckpt_dir: str) -> dict:
    """One model on one rank: its slices of the parent's weights (through
    CUDA IPC); step 0's gradient leaves gathered against the one-device
    step's; ``job["steps"]`` steps of ``make_train_step(cfg, rules)``
    counted (bytes into collectives, ms, launches, peak); with
    ``job["crash_after"]`` the state checkpointed after that step, and a
    resume on ``job["resume"]`` from it: the restored state against the
    file and the state saved, and the next step's loss."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib

    cfg, b = job["cfg"], job["batch"]
    rules = sharding.rules_for_mesh(mesh_lib.make_host_mesh(
        device=device, **_mesh_dict(job["mesh"])))
    world = rules.comm(tuple(rules.mesh.axis_names))
    specs = transformer.param_specs(cfg, rules)
    params = sharding.shard_tree(job["params"], specs, rules)
    pipe = data.TokenPipeline(seed=0, batch=b, seq_len=job["seq"],
                              vocab=cfg.vocab, rules=rules)
    out = dict(weight_bytes=sum(t.numel() * t.element_size()
                                for t in tree.leaves(params)),
               rows=len(pipe.batch_at(0)["tokens"]))
    (_, _), grads = tree.value_and_grad(transformer.loss_fn, params,
                                        pipe.batch_at(0), cfg, rules,
                                        batch_size=b)
    grads = sharding.sync_grads(grads, specs, rules)
    errs = []
    for (path, g), s, want in zip(tree.flatten_with_paths(grads),
                                  tree.leaves(specs),
                                  tree.leaves(job["grads"])):
        g = sharding.gather(g, s, rules).float()
        errs.append((((g - want).norm() / want.norm()).item(), path))
    out["leaf_errs"] = errs
    del grads
    pinned = dict(job["routes"])
    with float32_check(), _routing(cfg, params, pinned=pinned,
                                   shard=rules.coordinate(("data", "model"))):
        (loss32, _), grads = tree.value_and_grad(
            transformer.loss_fn, params, pipe.batch_at(0), cfg, rules,
            batch_size=b)
        grads = sharding.sync_grads(grads, specs, rules)
    out["loss32"] = loss32.item()
    out["flips32"] = pinned.get("flips", 0)
    out["leaf_errs32"] = [
        (((sharding.gather(g, s, rules) - want).norm() / want.norm()).item(),
         path) for (path, g), s, want in zip(
            tree.flatten_with_paths(grads), tree.leaves(specs),
            tree.leaves(job["grads32"]))]
    del grads
    opt = optim.adamw_init(params)
    step = transformer.make_train_step(cfg, rules, lr=SHARD_TRAIN_LR,
                                       batch_size=b)
    gc.collect()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    world.psum(torch.zeros(1, device=device))                   # align
    reset_launches()
    losses, norms, step_ms, sent = [], [], [], []
    kept = None
    for i in range(job["steps"]):
        batch = pipe.batch_at(i)
        before = sharding.Collective.payload_bytes
        _sync(device)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        sent.append(sharding.Collective.payload_bytes - before)
        if i == job.get("crash_after"):
            kept = tree.tree_map(lambda x: x.cpu(),
                                 {"params": params, "opt": opt})
            ckpt = CheckpointManager(ckpt_dir, rules=rules,
                                     specs=_state_specs(cfg, rules))
            t0 = time.perf_counter()
            ckpt.save_async(i, {"params": params, "opt": opt})
            ckpt.wait()
            out["save_s"] = time.perf_counter() - t0
    out.update(launches=read_launches(), losses=losses, norms=norms,
               step_ms=step_ms, sent=sent,
               peak_bytes=torch.cuda.max_memory_allocated()
               if device.type == "cuda" else 0)
    if kept is None:
        return out
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    # The crash: a restart on another mesh from the checkpoint.
    old = rules
    rdp, rtp = job["resume"]
    rules = sharding.rules_for_mesh(mesh_lib.make_host_mesh(
        data=rdp, model=rtp, device=device))
    abstract = transformer.abstract_params(cfg, ep=rules.tp,
                                           vocab_pad_to=rules.tp,
                                           dtype=torch.float32)
    like = {"params": abstract, "opt": optim.OptState(
        torch.empty((), dtype=torch.int32, device="meta"), abstract,
        abstract)}
    ckpt = CheckpointManager(ckpt_dir, rules=rules,
                             specs=_state_specs(cfg, rules))
    t0 = time.perf_counter()
    at, state = ckpt.restore_latest(like)
    out["restore_s"] = time.perf_counter() - t0
    saved_equal = restored_equal = True
    with np.load(os.path.join(ckpt_dir, f"step_{at}.npz")) as f:
        for (key, got), mine, s_old, s_new in zip(
                tree.flatten_with_paths(state), tree.leaves(kept),
                tree.leaves(_state_specs(cfg, old)),
                tree.leaves(_state_specs(cfg, rules))):
            arr = torch.from_numpy(f[key])
            saved_equal &= torch.equal(sharding.local_shard(arr, s_old, old),
                                       mine)
            restored_equal &= torch.equal(
                sharding.local_shard(arr, s_new, rules), got.cpu())
    del kept
    pipe = data.TokenPipeline(seed=0, batch=job["batch"], seq_len=job["seq"],
                              vocab=cfg.vocab, rules=rules)
    step = transformer.make_train_step(cfg, rules, lr=SHARD_TRAIN_LR)
    reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    _, _, m = step(state["params"], state["opt"], pipe.batch_at(at + 1))
    out.update(resume=dict(
        step=at, saved_equal=saved_equal, restored_equal=restored_equal,
        loss=m["loss"].item(), ms=(time.perf_counter() - t0) * 1e3,
        launches=read_launches()))
    return out


def f32_step_check(tag: str, loss: float, want_loss: float,
                   leaf_errs: list, what: str = "relative L2") -> dict:
    """A sharded float32 step 0 against one device's (``F32_CHECK``): the
    loss's relative gap and each gathered leaf's error (``leaf_errs``:
    (error, path); ``what`` says how it is taken), printed; fails past the
    limits."""
    gap = abs(loss - want_loss) / abs(want_loss)
    worst, path = max(leaf_errs)
    log(f"{tag} float32 step-0 check ({F32_ROUTE}): loss {loss:.8f} / "
        f"{want_loss:.8f} (gap {gap:.3e}, limit {F32_CHECK['loss']}), each "
        f"gathered gradient leaf ({what}, limit {F32_CHECK['leaf']}): "
        + ", ".join(f"{p} {e:.3e}" for e, p in leaf_errs))
    if not gap <= F32_CHECK["loss"] or not worst <= F32_CHECK["leaf"]:
        raise AssertionError(f"{tag}: float32 step 0 off one device: loss "
                             f"{gap:.3e}, {path} {worst:.3e}")
    return dict(loss_gap=gap, worst_leaf=(path, worst))


def shard_train_rank(rank, device, jobs, ckpt_dir):
    """One rank of the [shard train] phase: each job's model in turn."""
    out = {"rank": rank}
    for job in jobs:
        out[job["key"]] = shard_train_model(rank, device, job, ckpt_dir)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def shard_train_single(cfg, params, batch_size: int, shards: int) -> dict:
    """The one-device step on the same weights and batches: step 0's loss,
    gradient norm and gradient leaves (the balance loss over the mesh's
    ``shards`` token shards), and ms a step (steps 1-2 of three)."""
    device = params["embed"].device
    pipe = data.TokenPipeline(seed=0, batch=batch_size, seq_len=TRAIN_SEQ,
                              vocab=cfg.vocab, device=device)
    step = transformer.make_train_step(cfg, lr=SHARD_TRAIN_LR)
    with _token_shard_balance(shards):
        (loss, _), grads = tree.value_and_grad(transformer.loss_fn, params,
                                               pipe.batch_at(0), cfg)
    # The floor: the same gradient as a batch split takes it, from each
    # half's rows (other matmul shapes, so other bf16 roundings).
    halves = []
    with _token_shard_balance(max(1, shards // 2)):
        for half in (slice(0, batch_size // 2), slice(batch_size // 2, None)):
            b = {k: v[half] for k, v in pipe.batch_at(0).items()}
            halves.append(tree.value_and_grad(transformer.loss_fn, params, b,
                                              cfg)[1])
    floor = [(((a + c) / 2 - w).norm() / w.norm()).item()
             for a, c, w in zip(tree.leaves(halves[0]), tree.leaves(halves[1]),
                                tree.leaves(grads))]
    del halves
    routes: dict = {}
    with float32_check(), _token_shard_balance(shards), _routing(
            cfg, params, record=routes, tokens=batch_size * TRAIN_SEQ):
        (loss32, _), grads32 = tree.value_and_grad(
            transformer.loss_fn, params, pipe.batch_at(0), cfg)
    with _token_shard_balance(shards):
        p, opt, ms, metrics = params, optim.adamw_init(params), [], []
        for i in range(3):
            _sync(device)
            t0 = time.perf_counter()
            p, opt, m = step(p, opt, pipe.batch_at(i))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
            ms.append((time.perf_counter() - t0) * 1e3)
    del p, opt
    # the balance loss of all the tokens at once, for the record
    (plain, _), _ = tree.value_and_grad(transformer.loss_fn, params,
                                        pipe.batch_at(0), cfg)
    return dict(grads=grads, grads32=grads32, routes=routes,
                loss32=loss32.item(),
                floor=floor, loss=metrics[0][0],
                grad_norm=metrics[0][1],
                vg_loss=loss.item(), step_ms=ms[1:], plain_loss=plain.item(),
                losses=[m[0] for m in metrics])


def phase_shard_train(device, smi: str) -> tuple[dict, dict]:
    """The sharded train step (``make_train_step(cfg, rules)``) over
    ``SHARD_RANKS`` ranks sharing the card (gloo, collectives staged
    through pinned host memory), each model's float32 weights drawn once
    here and handed to the ranks through CUDA IPC: lm-100m at full width
    and depth on (2, 2) (DP, FSDP and TP at once), ``SHARD_TRAIN_STEPS``
    steps, a checkpoint after step ``SHARD_TRAIN_CRASH_AFTER`` and a
    resume on (4, 1); granite-moe-3b-a800m at full width, 4 of its 32
    layers, on (1, 4) (EP with the tokens cut over ``model``), capacity
    factor E/k; then lm-100m on the batches the batch axes do not divide
    (``SHARD_TRAIN_UNEVEN``).  Returns (the ranks' launches summed,
    numbers)."""
    from repro_torch.launch import mesh as mesh_lib

    jobs, singles, numbers = [], {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    for arch, mesh_shape, batch, steps in SHARD_TRAIN_JOBS:
        cfg = train.LM_100M if arch == "lm-100m" else configs.get(arch).full
        if cfg.moe:
            cfg = dataclasses.replace(
                cfg, n_layers=SHARD_TRAIN_MOE_LAYERS,
                capacity_factor=max(cfg.capacity_factor,
                                    cfg.n_experts / cfg.top_k))
        dp, tp = mesh_shape
        params = transformer.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device,
            dtype=torch.float32, ep=tp, vocab_pad_to=tp)
        single = shard_train_single(cfg, params, batch,
                                    dp * tp if cfg.moe else 1)
        job = dict(key=cfg.name, cfg=cfg, mesh=mesh_shape, batch=batch,
                   seq=TRAIN_SEQ, steps=steps, params=params,
                   grads=single.pop("grads"), grads32=single.pop("grads32"),
                   routes=single.pop("routes"))
        if arch == "lm-100m":
            job.update(crash_after=SHARD_TRAIN_CRASH_AFTER,
                       resume=SHARD_TRAIN_RESUME)
            dense = job
        jobs.append(job)
        singles[cfg.name] = single
        del params
    # The uneven batches: lm-100m's weights again (tp 1 pads nothing that
    # tp 2 did not), one device's step at each batch.
    for mesh_shape, batch, steps in SHARD_TRAIN_UNEVEN:
        cfg, key = dense["cfg"], f"{dense['cfg'].name} {_mesh_name(mesh_shape)}"
        if batch not in singles:
            singles[batch] = shard_train_single(cfg, dense["params"], batch,
                                                1)
        single = singles[batch]
        singles[key] = single
        jobs.append(dict(key=key, cfg=cfg, mesh=mesh_shape, batch=batch,
                         seq=TRAIN_SEQ, steps=steps,
                         params=dense["params"], grads=single["grads"],
                         grads32=single["grads32"],
                         routes=single["routes"]))
    for mesh_shape, batch, steps in SHARD_TRAIN_UNEVEN:
        for name in ("grads", "grads32", "routes"):
            singles[batch].pop(name, None)
    _sync(device)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as ckpt:
        t0 = time.perf_counter()
        ranks = mesh_lib.spawn(shard_train_rank, SHARD_RANKS, jobs, ckpt,
                               device=device.type,
                               timeout_s=SHARD_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
    log(f"[shard train] {SHARD_RANKS} ranks spawned, both models trained "
        f"and joined in {spawn_s:.3f} s; gloo collectives staged through "
        f"pinned host memory, 4 ranks sharing one card (not 4 cards over "
        f"NVLink) ({smi})")
    launches = launch_counts()
    for job in jobs:
        cfg, key = job["cfg"], job["key"]
        shape = _mesh_dict(job["mesh"])
        dp, tp = shape["data"], shape["model"]
        single = singles[key]
        want_bytes = shard_train_bytes(cfg, dp, tp, job["batch"], TRAIN_SEQ,
                                       shape.get("pod", 0))
        runs = [rank[key] for rank in ranks]
        r0 = runs[0]
        k7_want = launch_counts(
            flash_attention=2 * cfg.n_layers * job["steps"],
            flash_attention_bwd=cfg.n_layers * job["steps"])
        for rank, r in zip(ranks, runs):
            log(f"[shard train] {key} rank {rank['rank']} of "
                f"({_mesh_name(shape)}): {r['weight_bytes']} B of "
                f"weights; {job['steps']} steps of B {job['batch']} x S "
                f"{TRAIN_SEQ} ({r['rows']} rows on the rank): ms a step "
                + " ".join(f"{x:.3f}" for x in r["step_ms"])
                + f" wall; {r['sent'][0]} B into collectives a step; peak "
                f"device memory {r['peak_bytes']} B; K7 "
                f"{r['launches']['flash_attention']}, K7b "
                f"{r['launches']['flash_attention_bwd']} launches ({smi})")
            if r["launches"] != k7_want or set(r["sent"]) != {want_bytes} \
                    or r["losses"] != r0["losses"] \
                    or not np.isfinite(r["losses"]).all():
                raise AssertionError(
                    f"[shard train] {key} rank {rank['rank']}: "
                    f"launches {r['launches']} (want {k7_want}), bytes "
                    f"{set(r['sent'])} (arithmetic {want_bytes}), losses "
                    f"{r['losses']} against rank 0's {r0['losses']}")
            for name in ("flash_attention", "flash_attention_bwd"):
                launches[name] += r["launches"][name]
        worst, path = max(r0["leaf_errs"])
        leaf_tol = SHARD_TRAIN_LEAF_TOL[cfg.name]
        log(f"[shard train] {key} step 0, each gathered gradient leaf "
            f"against one device (relative L2; the one-device floor from "
            f"two half batches in brackets): "
            + ", ".join(f"{p} {e:.3e} ({f:.3e})" for (e, p), f in
                        zip(r0["leaf_errs"], single["floor"])))
        loss_gap = abs(r0["losses"][0] - single["loss"]) / single["loss"]
        norm_gap = abs(r0["norms"][0] - single["grad_norm"]) \
            / single["grad_norm"]
        log(f"[shard train] {key} step 0 sharded against one device: "
            f"loss {r0['losses'][0]:.6f} / {single['loss']:.6f} (gap "
            f"{loss_gap:.3e}), gradient norm {r0['norms'][0]:.6f} / "
            f"{single['grad_norm']:.6f} (gap {norm_gap:.3e}), worst leaf "
            f"{path} at {worst:.3e} relative L2 (limits "
            f"{SHARD_TRAIN_LOSS_TOL}, {SHARD_TRAIN_GNORM_TOL}, "
            f"{leaf_tol}); one device's step 0 with the balance "
            f"loss of all tokens at once: {single['plain_loss']:.6f}; one "
            f"device ms a step "
            + " ".join(f"{x:.3f}" for x in single["step_ms"])
            + f"; bytes a step {want_bytes} by arithmetic = counted ({smi})")
        if loss_gap > SHARD_TRAIN_LOSS_TOL \
                or norm_gap > SHARD_TRAIN_GNORM_TOL \
                or worst > leaf_tol or max(single["floor"]) > leaf_tol:
            raise AssertionError(f"[shard train] {key} step 0 off the "
                                 f"one-device step: {loss_gap}, {norm_gap},"
                                 f" {path} {worst}, floor "
                                 f"{max(single['floor'])}")
        f32 = f32_step_check(
            f"[shard train] {key}", r0["loss32"], single["loss32"],
            r0["leaf_errs32"], "relative L2" + (
                f"; routing pinned to one device's top-k, the ranks' own "
                f"choice differed for {[r['flips32'] for r in runs]} tokens "
                f"(each rank's, summed over the forward and the recompute)"
                if cfg.moe else ""))
        out = dict(mesh=job["mesh"], batch=job["batch"],
                   bytes_a_step=want_bytes, loss_gap=loss_gap,
                   norm_gap=norm_gap, worst_leaf=(path, worst), f32=f32,
                   single=single,
                   ranks=[{k: v for k, v in r.items()
                           if k not in ("leaf_errs", "leaf_errs32")}
                          for r in runs])
        if "resume" in job:
            want_resume = launch_counts(
                flash_attention=2 * cfg.n_layers,
                flash_attention_bwd=cfg.n_layers)
            base = r0["losses"][job["crash_after"] + 1]
            for rank, r in zip(ranks, runs):
                res = r["resume"]
                gap = abs(res["loss"] - base) / base
                log(f"[shard train] {key} rank {rank['rank']}: "
                    f"checkpoint of step {res['step']} written in "
                    f"{r['save_s']:.3f} s, restored on (data "
                    f"{job['resume'][0]}, model {job['resume'][1]}) in "
                    f"{r['restore_s']:.3f} s; the file equal to the state "
                    f"saved: {res['saved_equal']}, the restored slices to "
                    f"the file: {res['restored_equal']}; step "
                    f"{res['step'] + 1} there: loss {res['loss']:.6f} "
                    f"against {base:.6f} uninterrupted (gap {gap:.3e}, limit "
                    f"{SHARD_TRAIN_LOSS_TOL}), {res['ms']:.3f} ms wall")
                if not (res["saved_equal"] and res["restored_equal"]) \
                        or gap > SHARD_TRAIN_LOSS_TOL \
                        or res["launches"] != want_resume:
                    raise AssertionError(f"[shard train] {key} resume "
                                         f"on rank {rank['rank']}: {res}")
                for name in ("flash_attention", "flash_attention_bwd"):
                    launches[name] += res["launches"][name]
        numbers[key] = out
    numbers["spawn_s"] = spawn_s
    del jobs
    gc.collect()
    torch.cuda.empty_cache()
    return {"shard_train": launches}, numbers


# --------------------------------------------------------------------------
# [shard zoo]: the vision and diffusion zoo under rules, 4 ranks sharing
# the card
# --------------------------------------------------------------------------

def _zoo_module(arch: str):
    from repro_torch.models import convnext, dit, efficientnet, vit
    return {"vit": vit, "dit": dit, "convnext": convnext,
            "efficientnet": efficientnet}[arch.split("-")[0]]


def _local_numel(t, spec, rules) -> int:
    n = t.numel()
    for e in spec:
        n //= rules.axis_size(e) if e else 1
    return n


def _zoo_tail_bytes(params, specs, rules, dp: int) -> int:
    """What every train step adds after its backward: the loss's sum over
    the batch axes, ``sync_grads``' one flat psum of the leaves replicated
    over them (float32 masters), and the global norm's one scalar psum a
    set of axes that some leaf is cut on."""
    f32 = 4
    total = f32 if dp > 1 else 0
    if dp > 1:
        total += sum(_local_numel(t, s, rules) for t, s in zip(
            tree.leaves(params), tree.leaves(specs))
            if "data" not in s) * f32
    sets = {tuple(a for a in ("data", "model") if a in s)
            for s in tree.leaves(specs)}
    return total + f32 * sum(1 for a in sets
                             if a and rules.axis_size(a) > 1)


def shard_zoo_bytes(arch: str, cfg, dp: int, tp: int, batch: int, res: int,
                    train: bool) -> int:
    """Bytes one rank hands to collectives in one sharded train step (or,
    with ``train=False``, one serving forward or DDIM sample step) of a
    global ``batch`` at ``res`` on a (dp, tp) mesh, from the shapes alone:
    the ``param_specs`` cut of each leaf and ``models.zoo_mesh`` /
    ``vit.py`` / ``dit.py`` / ``convnext.py`` / ``efficientnet.py``'s
    collectives and their differentiable backwards (float32 masters, so
    weight gathers and their reduce-scatters move float32; activations
    move in bf16, their sums in float32).  Each checkpointed layer's
    forward collectives run again in the backward's recompute, but for
    the row-parallel products under "dots" (kept, sum included)."""
    from repro_torch.distributed import sharding

    mod = _zoo_module(arch)
    rules = sharding.Rules(mesh=_MeshShape(dp, tp))
    f32, bf16 = 4, 2
    b = batch // dp if rules.batch_spec(batch) else batch
    if arch.startswith("efficientnet"):
        return _effnet_bytes(cfg, rules, dp, tp, train)
    specs = mod.param_specs(cfg, rules)
    full = mod.abstract_params(cfg)

    def loc(name, lay=True):
        t = full["layers"][name] if lay else full[name]
        s = specs["layers"][name] if lay else specs[name]
        return _local_numel(t, s, rules) // (cfg.n_layers if lay and
                                             "layers" in full else 1)

    def fsdp(names, lay=True):
        """(forward, backward) bytes of one flat FSDP gather of ``names``
        and its reduce-scatter."""
        tab = specs["layers"] if lay else specs
        n = sum(loc(x, lay) for x in names if "data" in tab[x])
        return (n * f32, n * dp * f32) if dp > 1 else (0, 0)

    if arch.startswith("convnext"):
        return _convnext_bytes(cfg, rules, specs, full, dp, tp, b, res,
                               train)
    lay = specs["layers"]
    d, h, s_tok = cfg.d_model, cfg.n_heads, cfg.n_tokens(res)
    cols = tp > 1 and lay["wqkv"][2] is not None
    heads = cols and h % tp == 0
    wo_rows = tp > 1 and lay["wo"][1] is not None
    ff_cols = tp > 1 and lay["w1"][2] is not None
    fs_fwd, fs_bwd = fsdp(list(lay))
    qkv = (loc("wqkv") * (dp if "data" in lay["wqkv"] else 1)
           + (loc("bqkv") if "bqkv" in lay else 0)) * f32
    mg_fwd = qkv if cols else 0
    mg_bwd = qkv * tp if heads else 0
    act = b * s_tok * d
    if arch.startswith("vit"):
        rows = (wo_rows + ff_cols) * act * f32
        fwd = fs_fwd + mg_fwd + rows
        bwd = (fs_bwd + mg_bwd + (heads + ff_cols) * act * f32
               + (act // tp * bf16 if wo_rows and not heads else 0))
        layer = fwd + (fwd + bwd if train else 0)
        top_fwd = (_local_numel(full["patch_w"], specs["patch_w"], rules)
                   * f32 if specs["patch_w"][0] and tp > 1 else 0)
        head_fwd, head_bwd = fsdp(["head_w"], lay=False)
        total = cfg.n_layers * layer + top_fwd + head_fwd
        if not train:
            return total + (b * cfg.n_classes * bf16 if dp > 1 else 0)
        return total + head_bwd + _zoo_tail_bytes(full, specs, rules, dp)
    # DiT
    ada = tp > 1 and lay["ada_w"][2] is not None
    if not rules.batch_spec(batch):
        raise ValueError(f"shard_zoo_bytes: DiT's batch {batch} does not "
                         f"cut over {rules.batch}")
    seq = (cfg.seq_shard and tp > 1 and s_tok % tp == 0 and heads
           and wo_rows and ff_cols and ada)
    mods_fwd = b * 6 * d // tp * bf16 if ada else 0
    mods_bwd = ((b * 6 * d * bf16 if seq else 0) + b * d * f32) if ada else 0
    if seq:
        enter_fwd, enter_bwd = act // tp * bf16, act * bf16
        out_fwd, out_bwd = act * f32, act // tp * bf16
        ada_b_bwd = 6 * d * f32
    else:
        enter_fwd, enter_bwd = 0, act * f32
        out_fwd, out_bwd = act * f32, 0
        ada_b_bwd = 0
    enter_bwd *= heads + ff_cols
    fwd = (fs_fwd + mg_fwd + mods_fwd + (heads + ff_cols) * enter_fwd
           + (wo_rows + ff_cols) * out_fwd)
    recompute = fwd - ((wo_rows + ff_cols) * out_fwd
                       if cfg.remat_policy == "dots" else 0)
    bwd = (fs_bwd + mg_bwd + mods_bwd + enter_bwd
           + (wo_rows + ff_cols) * out_bwd + ada_b_bwd
           + (act // tp * bf16 if wo_rows and not heads else 0))
    layer = fwd + (recompute + bwd if train else 0)
    top = ["patch_w", "t_mlp1", "t_mlp2", "label_emb", "final_ada_w",
           "final_w"]
    top_fwd, top_bwd = fsdp(top, lay=False)
    ends = act // tp * bf16 if seq else 0       # the residual gathered
    total = cfg.n_layers * layer + top_fwd + ends
    if not train:
        pd = cfg.patch_dim
        return total + (b * s_tok * 2 * pd * bf16 if dp > 1 else 0)
    return (total + top_bwd + ends                # the split's backward
            + _zoo_tail_bytes(full, specs, rules, dp))


def _convnext_bytes(cfg, rules, specs, full, dp, tp, b, res, train) -> int:
    f32 = 4
    cut = tp > 1

    def loc(t, s):
        return _local_numel(t, s, rules)

    total = loc(full["stem_w"], specs["stem_w"]) * f32 if (
        cut and specs["stem_w"][0]) else 0
    hw = res // 4
    for i, (st, sp, depth, dim) in enumerate(zip(
            full["stages"], specs["stages"], cfg.depths, cfg.dims)):
        if i:
            hw //= 2
        if "down_w" in sp and cut and sp["down_w"][0]:
            total += loc(st["down_w"], sp["down_w"]) * f32
        bl, bs = st["blocks"], sp["blocks"]
        ff_cols = cut and bs["w1"][2] is not None
        fs = (loc(bl["w1"], bs["w1"]) + loc(bl["w2"], bs["w2"])) // depth
        fwd = (fs * f32 if dp > 1 else 0)
        if cut and bs["dw_w"][1]:
            fwd += loc(bl["dw_w"], bs["dw_w"]) // depth * f32
        act = b * hw * hw * dim
        fwd += act * f32 if ff_cols else 0
        bwd = (fs * dp * f32 if dp > 1 else 0)
        bwd += (act * f32 + 4 * dim // tp * f32) if ff_cols else 0
        recompute = 0 if cfg.unroll else fwd
        total += depth * (fwd + (recompute + bwd if train else 0))
    head = loc(full["head_w"], specs["head_w"])
    if dp > 1:
        total += head * f32 + (head * dp * f32 if train else 0)
    if not train:
        return total + (b * cfg.n_classes * 2 if dp > 1 else 0)
    return total + _zoo_tail_bytes(full, specs, rules, dp)


def _effnet_bytes(cfg, rules, dp, tp, train) -> int:
    from repro_torch.models import efficientnet
    f32 = 4
    pspecs, _ = efficientnet.param_specs(cfg, rules)
    full, _ = efficientnet.abstract_params(cfg)

    def cut_numel(t, s, strip=0):
        """The local numel of ``t``'s leaves cut over ``model`` (a
        block's one flat gather), ``strip``: a stacked block's layer
        dim."""
        n = 0
        for x, spec in zip(tree.leaves(t), tree.leaves(s)):
            if tp > 1 and any(list(spec)[strip:]):
                k = _local_numel(x, spec, rules)
                n += k // (x.shape[0] if strip else 1)
        return n

    def bn(c):           # a synced BN's two sums, forward or backward
        return 2 * c * f32 if dp > 1 else 0

    if not train:
        raise ValueError("shard_zoo_bytes: EfficientNet's cell trains")
    top = {k: full[k] for k in ("stem_w", "stem_bn_s", "stem_bn_b", "head_w",
                                "head_bn_s", "head_bn_b", "fc_w", "fc_b")}
    total = cut_numel(top, {k: pspecs[k] for k in top}) * f32
    total += 2 * (bn(cfg.stem_ch) + bn(cfg.head_ch))
    for (e, k, s, c_in, c_out, r), st, sp in zip(
            cfg.stages(), full["stages"], pspecs["stages"]):
        for part, n, cin in (("head", 1, c_in), ("rest", r - 1, c_out)):
            if n == 0:
                continue
            mid = cin * e
            chans = ([mid] if e != 1 else []) + [mid, c_out]
            fwd = cut_numel(st[part], sp[part], 1 if part == "rest" else 0
                            ) * f32 + sum(bn(c) for c in chans)
            bwd = sum(bn(c) for c in chans)
            again = fwd if part == "rest" and not cfg.unroll else 0
            total += n * (fwd + again + bwd)
    return total + _zoo_tail_bytes(full, pspecs, rules, dp)


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    """Peak device memory since the last reset (0 off the card)."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def _zoo_pipe(arch: str, cfg, batch: int, res: int, device, seed: int = 0):
    if arch.startswith("dit"):
        return data.LatentPipeline(seed=seed, batch=batch,
                                   latent_res=cfg.latent_res(res),
                                   n_classes=cfg.n_classes, device=device,
                                   prefetch=0)
    return data.ImagePipeline(seed=seed, batch=batch, img_res=res,
                              n_classes=cfg.n_classes, device=device,
                              prefetch=0)


def _zoo_rows(arch: str, batch: dict, rules) -> dict:
    """A train step's batch as the rank takes it: its rows
    (``rules.batch_cut``; DiT: the whole batch, which it cuts itself)."""
    if rules is None or arch.startswith("dit"):
        return batch
    cut = rules.batch_cut(len(batch["labels"]))
    return {k: cut.take(v) for k, v in batch.items()}


def _zoo_vg(arch: str, cfg, params, state, batch, rules=None):
    """(loss, gradient) of the train step's loss."""
    mod = _zoo_module(arch)
    if arch.startswith("efficientnet"):
        (loss, _), grads = tree.value_and_grad(mod.loss_fn, params, state,
                                               batch, cfg, rules)
    else:
        fn = mod.train_loss if arch.startswith("dit") else mod.loss_fn
        (loss, _), grads = tree.value_and_grad(fn, params, batch, cfg, rules)
    return loss.item(), grads


def _zoo_steps(arch: str, step, params, state, pipe, n: int, rules=None):
    """``n`` train steps from fresh optimiser state: (losses, ms each)."""
    eff = arch.startswith("efficientnet")
    opt = optim.sgdm_init(params) if eff else optim.adamw_init(params)
    losses, ms = [], []
    for i in range(n):
        batch = _zoo_rows(arch, pipe.batch_at(i), rules)
        _sync(pipe.device)
        t0 = time.perf_counter()
        if eff:
            params, state, opt, m = step(params, state, opt, batch)
        else:
            params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        _sync(pipe.device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _zoo_serve_fn(arch: str, cfg, job: dict, rules=None):
    """The serving cell's call: a forward of the images, or one DDIM
    sample step of the latents."""
    mod = _zoo_module(arch)
    x = job["serve_x"]
    if arch.startswith("dit"):
        step = mod.make_sample_step(cfg, rules)
        return lambda p: step(p, x, job["serve_t"], job["serve_t"] - 20,
                              job["serve_labels"])
    return lambda p: mod.forward(p, x, cfg, rules)


def _zoo_leaf_errs(grads, want, specs, rules, floor: float) -> list:
    """(relative L2, path) of each gathered gradient leaf against one
    device's ``want`` (its full leaves), each held to max(its norm,
    ``floor`` of the tree's): every rank sums its slice's squares, a
    slice held by c ranks counted 1/c times, one psum over the mesh."""
    from repro_torch.distributed import sharding

    world = rules.comm(("data", "model"))
    rows, paths = [], []
    for (path, g), s, w in zip(tree.flatten_with_paths(grads),
                               tree.leaves(specs), tree.leaves(want)):
        wl = sharding.local_shard(w, s, rules).float()
        copies = world.size // math.prod(
            rules.axis_size(e) if e else 1 for e in s)
        rows.append(torch.stack([(g.float() - wl).square().sum(),
                                 wl.square().sum()]) / copies)
        paths.append(path)
    sums = world.psum(torch.stack(rows)).double().cpu()
    top = floor * float(sums[:, 1].sum().sqrt())
    return [(float(d.sqrt()) / max(float(w.sqrt()), top, 1e-30), p)
            for (d, w), p in zip(sums, paths)]


def shard_zoo_model(rank: int, device, job: dict) -> dict:
    """One arch on one rank: its slices of the parent's float32 weights
    (through CUDA IPC) on SHARD_ZOO_TRAIN_MESH; step 0's gradient leaves
    against the one-device step's, bf16 through K7/K7b and float32
    (``float32_check``); the job's counted train steps; then on
    SHARD_ZOO_SERVE_MESH the serving cell's call counted, bf16 and
    float32."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib

    arch, cfg = job["arch"], job["cfg"]
    mod = _zoo_module(arch)
    eff = arch.startswith("efficientnet")
    dp, tp = job["mesh"]
    rules = sharding.rules_for_mesh(mesh_lib.make_host_mesh(
        data=dp, model=tp, device=device))
    world = rules.comm(("data", "model"))
    specs = mod.param_specs(cfg, rules)
    pspecs = specs[0] if eff else specs
    params = sharding.shard_tree(job["params"], pspecs, rules)
    state = sharding.shard_tree(job["state"], specs[1], rules) if eff \
        else None
    out = dict(weight_bytes=sum(t.numel() * t.element_size()
                                for t in tree.leaves(params)))
    pipe = _zoo_pipe(arch, cfg, job["batch"], job["res"], device)
    b0 = _zoo_rows(arch, pipe.batch_at(0), rules)
    for key, ctx in (("bf16", contextlib.nullcontext()),
                     ("f32", float32_check())):
        with ctx:
            loss, grads = _zoo_vg(arch, cfg, params, state, b0, rules)
            grads = sharding.sync_grads(grads, pspecs, rules)
            out[key] = dict(loss=loss, errs=_zoo_leaf_errs(
                grads, job["grads_" + key], pspecs, rules, SHARD_ZOO_FLOOR))
        del grads
    step = mod.make_train_step(cfg, rules)
    gc.collect()
    _sync(device)
    _reset_peak(device)
    world.psum(torch.zeros(1, device=device))                   # align
    reset_launches()
    sent, ms, losses = [], [], []
    opt = optim.sgdm_init(params) if eff else optim.adamw_init(params)
    for i in range(job["steps"]):
        batch = _zoo_rows(arch, pipe.batch_at(i), rules)
        before = sharding.Collective.payload_bytes
        _sync(device)
        t0 = time.perf_counter()
        if eff:
            params, state, opt, m = step(params, state, opt, batch)
        else:
            params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        sent.append(sharding.Collective.payload_bytes - before)
    out.update(launches=read_launches(), losses=losses, ms=ms, sent=sent,
               peak_bytes=_peak(device))
    if eff:       # each rank's block of the running statistics
        out["state"] = [t.cpu() for t in tree.leaves(state)]
    del params, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    if job["serve"] is None:
        return out
    dp, tp = SHARD_ZOO_SERVE_MESH
    rules = sharding.rules_for_mesh(mesh_lib.make_host_mesh(
        data=dp, model=tp, device=device))
    params = sharding.shard_tree(job["params"], mod.param_specs(cfg, rules),
                                 rules)
    fn = _zoo_serve_fn(arch, cfg, job, rules)
    fn(params)                                                  # warm
    _sync(device)
    _reset_peak(device)
    reset_launches()
    before = sharding.Collective.payload_bytes
    t0 = time.perf_counter()
    y = fn(params)
    _sync(device)
    serve = dict(ms=(time.perf_counter() - t0) * 1e3,
                 sent=sharding.Collective.payload_bytes - before,
                 launches=read_launches(), peak_bytes=_peak(device),
                 finite=bool(torch.isfinite(y.float()).all()))
    with float32_check():
        y32 = fn(params)
    if rank == 0:
        serve.update(out=y.float().cpu(), out32=y32.float().cpu())
    out["serve"] = serve
    return out


def shard_zoo_rank(rank, device, jobs):
    """One rank of the [shard zoo] phase: each arch in turn."""
    out = {"rank": rank}
    for job in jobs:
        t0 = time.perf_counter()
        out[job["key"]] = shard_zoo_model(rank, device, job)
        out[job["key"]]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _zoo_floor_errs(halves, grads, floor: float, rows=(1, 1)) -> list:
    """Each leaf of the mean of two half batches' gradients (of ``rows``
    rows each: their mean weighted by them) against the whole batch's,
    with ``_zoo_leaf_errs``' floor: the one-device noise of a batch cut in
    two (other matmul shapes, other bf16 roundings)."""
    wants = [w.float() for w in tree.leaves(grads)]
    top = floor * float(torch.stack([w.square().sum() for w in wants])
                        .sum().sqrt())
    n, m = rows

    def mean(a, c):
        if n == m:
            return (a.float() + c.float()) / 2
        return (n * a.float() + m * c.float()) / (n + m)
    return [float((mean(a, c) - w).norm())
            / max(float(w.norm()), top, 1e-30)
            for a, c, w in zip(tree.leaves(halves[0]),
                               tree.leaves(halves[1]), wants)]


def shard_zoo_job(arch: str, device, rec=None, cell=None, steps: int =
                  SHARD_ZOO_STEPS) -> tuple[dict, dict]:
    """An arch's job for the ranks (float32 weights, the one-device step
    0's gradients, bf16 and float32, the serving cell's inputs) and the
    one-device numbers: step 0's loss and gradients, the floor from two
    half batches, ms a train step, the serving call's outputs and ms.
    ``rec``: the arch's configs record (default ``configs.get(arch)``;
    FULL config and shapes); ``cell``: ((train shape, batch), serving
    cell or None) in place of SHARD_ZOO_CELLS'; ``steps``: the ranks'
    counted train steps."""
    rec = rec or configs.get(arch)
    cfg = rec.full
    mod = _zoo_module(arch)
    (tname, tb), serve = cell or SHARD_ZOO_CELLS[arch]
    eff, is_dit = arch.startswith("efficientnet"), arch.startswith("dit")
    res = cfg.img_res if eff else rec.shape(tname).img_res
    g = torch.Generator(device=device).manual_seed(0)
    state = None
    if is_dit:
        params = zoo_dit_params(cfg, g, device, torch.float32)
    elif eff:
        params, state = mod.init_params(cfg, g, device, dtype=torch.float32)
    else:
        params = mod.init_params(cfg, g, device, dtype=torch.float32)
    job = dict(arch=arch, key=arch if cell is None else f"{arch} b{tb}",
               cfg=cfg, params=params, state=state, batch=tb, res=res,
               serve=serve, steps=steps, mesh=SHARD_ZOO_TRAIN_MESH,
               bf16_limits=SHARD_ZOO_BF16_LIMITS[arch] if cell is None
               else SHARD_ZOO_UNEVEN_BF16_LIMITS)
    pipe = _zoo_pipe(arch, cfg, tb, res, device)
    b0 = pipe.batch_at(0)
    single = {}
    single["loss"], job["grads_bf16"] = _zoo_vg(arch, cfg, params, state, b0)
    if not eff:     # train-mode BN: a half batch is another function
        halves = [_zoo_vg(arch, cfg, params, state,
                          {k: v[sl] for k, v in b0.items()})[1]
                  for sl in (slice(0, tb // 2), slice(tb // 2, None))]
        single["floor"] = _zoo_floor_errs(halves, job["grads_bf16"],
                                          SHARD_ZOO_FLOOR,
                                          (tb // 2, tb - tb // 2))
        del halves
    with float32_check():
        single["loss32"], job["grads_f32"] = _zoo_vg(arch, cfg, params,
                                                     state, b0)
    losses, ms = _zoo_steps(arch, mod.make_train_step(cfg), params, state,
                            pipe, steps + 1)
    single.update(losses=losses[:steps], ms=ms[1:])
    if serve is not None:
        sname, sb = serve
        sres = rec.shape(sname).img_res
        if is_dit:
            r = cfg.latent_res(sres)
            job["serve_x"] = torch.randn((sb, r, r, cfg.latent_channels),
                                         device=device, generator=g)
            job["serve_t"] = torch.full((sb,), cfg.n_train_timesteps // 2,
                                        device=device)
            job["serve_labels"] = torch.randint(0, cfg.n_classes, (sb,),
                                                device=device, generator=g)
        else:
            job["serve_x"] = torch.rand((sb, sres, sres, 3), device=device,
                                        generator=g)
        job["serve_res"] = sres
        fn = _zoo_serve_fn(arch, cfg, job)
        fn(params)
        _sync(device)
        t0 = time.perf_counter()
        y = fn(params)
        _sync(device)
        single["serve_ms"] = (time.perf_counter() - t0) * 1e3
        single["out"] = y.float().cpu()
        # the floor: the same call a half batch at a time
        halves = {k: job[k] for k in ("serve_x", "serve_t", "serve_labels")
                  if k in job}
        parts = []
        for sl in (slice(0, sb // 2), slice(sb // 2, None)):
            part = dict(job, **{k: v[sl] for k, v in halves.items()})
            parts.append(_zoo_serve_fn(arch, cfg, part)(params).float()
                         .cpu())
        single["out_floor"] = rel_err(torch.cat(parts), single["out"])
        with float32_check():
            single["out32"] = fn(params).float().cpu()
    gc.collect()
    torch.cuda.empty_cache()
    return job, single


def phase_shard_zoo(device, smi: str) -> tuple[dict, dict]:
    """ViT-H/14, DiT-XL/2, ConvNeXt-B and EfficientNet-B7 under ``rules``
    over SHARD_RANKS ranks sharing the card (gloo, collectives staged
    through pinned host memory), full width and depth, float32 weights
    drawn once here and handed to the ranks through CUDA IPC: each arch's
    train cell (SHARD_ZOO_STEPS steps on SHARD_ZOO_TRAIN_MESH) and serving
    cell (on SHARD_ZOO_SERVE_MESH), counted: bytes into collectives equal
    to ``shard_zoo_bytes``, K7 / K7b launches on each rank's heads; step 0
    and the serving output against one device, float32 within
    ``F32_CHECK`` and bf16 beside the one-device floor.  Returns (the
    ranks' launches summed, numbers)."""
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    jobs, singles = [], {}
    arch, tname, tb, steps = SHARD_ZOO_UNEVEN
    runs_of = [(a, None, SHARD_ZOO_STEPS) for a in SHARD_ZOO_ARCHS] + [
        (arch, ((tname, tb), None), steps)]
    for arch, cell, steps in runs_of:
        t0 = time.perf_counter()
        job, single = shard_zoo_job(arch, device, cell=cell, steps=steps)
        singles[job["key"]] = single
        jobs.append(job)
        log(f"[shard zoo] {job['key']}: one device's step 0, {steps + 1}"
            f" steps and the serving cell in {time.perf_counter() - t0:.1f}"
            f" s")
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(shard_zoo_rank, SHARD_RANKS, jobs,
                           device=device.type, timeout_s=SHARD_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    log(f"[shard zoo] {SHARD_RANKS} ranks spawned, the {len(jobs)} cells "
        f"run and joined in {spawn_s:.3f} s; gloo collectives staged "
        f"through pinned host memory, 4 ranks sharing one card ({smi})")
    launches, numbers = launch_counts(), {"spawn_s": spawn_s}
    for job in jobs:
        arch, cfg, key, steps = job["arch"], job["cfg"], job["key"], \
            job["steps"]
        single = singles[key]
        runs = [rank[key] for rank in ranks]
        r0 = runs[0]
        l_n = getattr(cfg, "n_layers", 0)
        attn = arch.startswith(("vit", "dit"))
        dp, tp = job["mesh"]
        want_bytes = shard_zoo_bytes(arch, cfg, dp, tp, job["batch"],
                                     job["res"], True)
        want_launch = launch_counts(
            flash_attention=2 * l_n * steps if attn else 0,
            flash_attention_bwd=l_n * steps if attn else 0)
        for rank, r in zip(ranks, runs):
            log(f"[shard zoo] {key} rank {rank['rank']} of (data {dp}, "
                f"model {tp}): {r['weight_bytes']} B of weights; "
                f"{steps} steps of B {job['batch']} at "
                f"{job['res']}²: ms a step "
                + " ".join(f"{x:.3f}" for x in r["ms"])
                + f" wall; {r['sent'][0]} B into collectives a step; peak "
                f"device memory {r['peak_bytes']} B; K7 "
                f"{r['launches']['flash_attention']}, K7b "
                f"{r['launches']['flash_attention_bwd']} launches; arch "
                f"{r['s']:.1f} s on the rank ({smi})")
            if r["launches"] != want_launch or set(r["sent"]) != {
                    want_bytes} or r["losses"] != r0["losses"] \
                    or not np.isfinite(r["losses"]).all():
                raise AssertionError(
                    f"[shard zoo] {key} rank {rank['rank']}: launches "
                    f"{r['launches']} (want {want_launch}), bytes "
                    f"{set(r['sent'])} (arithmetic {want_bytes}), losses "
                    f"{r['losses']} against rank 0's {r0['losses']}")
            for name in ("flash_attention", "flash_attention_bwd"):
                launches[name] += r["launches"][name]
        bf = r0["bf16"]
        worst, path = max(bf["errs"])
        floor = single.get("floor")
        log(f"[shard zoo] {key} step 0 bf16 through K7/K7b against one "
            f"device: loss {bf['loss']:.6f} / {single['loss']:.6f} (gap "
            f"{abs(bf['loss'] - single['loss']) / abs(single['loss']):.3e})"
            f", worst gathered leaf {path} {worst:.3e} relative L2 (a leaf "
            f"held to max(its norm, {SHARD_ZOO_FLOOR} of the tree's)); the "
            f"one-device floor from two half batches: "
            + (f"worst {max(floor):.3e}" if floor else
               "none (train-mode BN: a half batch is another function)")
            + f"; one device ms a step "
            + " ".join(f"{x:.3f}" for x in single["ms"])
            + f"; bytes a step {want_bytes} by arithmetic = counted ({smi})")
        leaf_lim, loss_lim, out_lim = job["bf16_limits"]
        gap = abs(bf["loss"] - single["loss"]) / abs(single["loss"])
        log(f"[shard zoo] {key} bf16 limits: worst leaf "
            + (f"{worst:.3e} <= {leaf_lim} (floor "
               f"{max(floor):.3e})" if leaf_lim is not None
               else "not bounded (train-mode BN, ROADMAP caveat (i))")
            + f", loss gap {gap:.3e} <= {loss_lim}")
        if (leaf_lim is not None and not worst <= leaf_lim) \
                or not gap <= loss_lim:
            raise AssertionError(f"[shard zoo] {key} bf16 step 0: worst "
                                 f"leaf {path} {worst:.3e} (limit "
                                 f"{leaf_lim}), loss gap {gap:.3e} (limit "
                                 f"{loss_lim})")
        f32 = f32_step_check(
            f"[shard zoo] {key}", r0["f32"]["loss"], single["loss32"],
            r0["f32"]["errs"], f"relative L2 of max(the leaf's norm, "
            f"{SHARD_ZOO_FLOOR} of the tree's)")
        out = dict(train_mesh=job["mesh"], batch=job["batch"],
                   res=job["res"], bytes_a_step=want_bytes,
                   bf16_loss_gap=abs(bf["loss"] - single["loss"])
                   / abs(single["loss"]), bf16_worst_leaf=(path, worst),
                   floor_worst=max(floor) if floor else None, f32=f32,
                   single_ms=single["ms"],
                   ranks=[dict(ms=r["ms"], sent=r["sent"],
                               peak_bytes=r["peak_bytes"],
                               launches=r["launches"], s=r["s"])
                          for r in runs])
        if arch.startswith("efficientnet"):
            # the running statistics: each rank's block equal to its data
            # peer's, bit for bit (ranks r and r + tp share a model block)
            for a, c in ((0, 2), (1, 3)):
                if not all(torch.equal(x, y) for x, y in zip(
                        runs[a]["state"], runs[c]["state"])):
                    raise AssertionError(f"[shard zoo] {key}: the running "
                                         f"statistics of ranks {a} and {c} "
                                         f"differ")
            log(f"[shard zoo] {key}: the synced BN's running statistics "
                f"equal on every data rank after {steps} steps, "
                f"bit for bit")
        if job["serve"] is not None:
            sname, sb = job["serve"]
            sdp, stp = SHARD_ZOO_SERVE_MESH
            want_serve = shard_zoo_bytes(arch, cfg, sdp, stp, sb,
                                         job["serve_res"], False)
            for rank, r in zip(ranks, runs):
                sv = r["serve"]
                log(f"[shard zoo] {key} {sname} rank {rank['rank']} of "
                    f"(data {sdp}, model {stp}): B {sb} at "
                    f"{job['serve_res']}², {sv['ms']:.3f} ms wall, "
                    f"{sv['sent']} B into collectives, peak device memory "
                    f"{sv['peak_bytes']} B, K7 "
                    f"{sv['launches']['flash_attention']} ({smi})")
                if sv["launches"] != launch_counts(
                        flash_attention=l_n if attn else 0) \
                        or sv["sent"] != want_serve or not sv["finite"]:
                    raise AssertionError(
                        f"[shard zoo] {key} {sname} rank {rank['rank']}: "
                        f"launches {sv['launches']}, bytes {sv['sent']} "
                        f"(arithmetic {want_serve}), finite {sv['finite']}")
                for name in ("flash_attention", "flash_attention_bwd"):
                    launches[name] += sv["launches"][name]
            sv = r0["serve"]
            err16 = rel_err(sv["out"], single["out"])
            err32 = rel_err(sv["out32"], single["out32"])
            log(f"[shard zoo] {key} {sname}: one device {single['serve_ms']:.3f}"
                f" ms; bf16 through K7 against one device: max |sharded - "
                f"single| / max |single| {err16:.4e}, the one-device floor "
                f"(two half batches) {single['out_floor']:.4e}; float32 "
                f"check ({F32_ROUTE}): {err32:.4e} (limit "
                f"{F32_CHECK['out']}); bytes {want_serve} by arithmetic = "
                f"counted")
            log(f"[shard zoo] {key} {sname} bf16 limit: {err16:.4e} <= "
                f"{out_lim} (floor {single['out_floor']:.4e})")
            if not err32 <= F32_CHECK["out"] or not err16 <= out_lim:
                raise AssertionError(f"[shard zoo] {key} {sname}: output "
                                     f"off by {err32:.4e} in float32, "
                                     f"{err16:.4e} in bf16 (limit "
                                     f"{out_lim})")
            out["serve"] = dict(batch=sb, res=job["serve_res"],
                                bytes=want_serve, bf16_err=err16,
                                floor=single["out_floor"], f32_err=err32,
                                single_ms=single["serve_ms"],
                                ranks=[dict(ms=r["serve"]["ms"],
                                            peak_bytes=r["serve"]["peak_bytes"])
                                       for r in runs])
        numbers[key] = out
    del jobs
    gc.collect()
    torch.cuda.empty_cache()
    numbers["s"] = time.perf_counter() - t_phase
    log(f"[shard zoo] phase took {numbers['s']:.1f} s")
    return {"shard_zoo": launches}, numbers


# --------------------------------------------------------------------------
# [dryrun]: the port's tracer held against what the card phases ran
# --------------------------------------------------------------------------

# The [dryrun] phase traces the steps the card phases ran, at their meshes
# and cut batches, under FakeTensorMode on fake cuda tensors (attention
# through K7's and K7b's fakes) over fake process groups
# (``launch/cells.trace_step``, ``launch/mesh.fake_group``), in
# DRYRUN_WORKERS subprocesses of this script that must all end within
# DRYRUN_TIMEOUT_S, and holds the counts against the card's: FLOPs equal,
# to the count, to FlopCounterMode's around one real step ([train]'s
# lm-100m step, [zoo]'s ViT-H/14 serve_b128 forward); each rank's bytes
# into collectives equal to shard_bytes / shard_train_bytes /
# shard_zoo_bytes (which the card phases held equal to what they
# counted); each one-device [zoo] train cell's predicted peak within
# DRYRUN_PEAK_TOL of the max_memory_allocated [zoo] measured above the
# model's start; DiT-XL/2 train_1024 predicted past the card's memory at
# its published b32 and inside it at ZOO_CUTS' b16; and one cell of each
# production mesh (launch/dryrun.run_one) traced.
DRYRUN_WORKERS = 8
DRYRUN_TIMEOUT_S = 120
DRYRUN_PEAK_TOL = 0.10
DRYRUN_PRODUCTION = (("minitron-8b", "train_4k", False),
                     ("qwen3-moe-30b-a3b", "decode_32k", True))
DRYRUN_CUT = ("dit-xl2", "train_1024", 32)
# Where the fakes claim to live (the CPU only for a rehearsal of the
# phase's logic off the card: attention then through the plain versions).
DRYRUN_DEVICE = "cuda"


def _sds(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _zoo_train_args(arch: str, cfg, batch: int, res: int, rules=None):
    """(step, meta args) of a zoo train step as the card ran it: float32
    masters, the optimiser's state, the batch (a rank's rows on a mesh;
    DiT's whole)."""
    mod = _zoo_module(arch)
    eff, is_dit = arch.startswith("efficientnet"), arch.startswith("dit")
    if eff:
        full, state = mod.abstract_params(cfg)
    else:
        full, state = mod.abstract_params(cfg), None
    params = full
    if rules is not None:
        specs = mod.param_specs(cfg, rules)
        pspecs = specs[0] if eff else specs
        params = cells.local_args(full, pspecs, rules)
        if eff:
            state = cells.local_args(state, specs[1], rules)
    rows = batch if rules is None or is_dit else batch // rules.dp
    if is_dit:
        lat = (rows, cfg.latent_res(res), cfg.latent_res(res),
               cfg.latent_channels)
        data_ = {"latents": _sds(lat), "labels": _sds((rows,), torch.int32),
                 "t": _sds((rows,), torch.int32), "noise": _sds(lat)}
    else:
        data_ = {"images": _sds((rows, res, res, 3)),
                 "labels": _sds((rows,), torch.int32)}
    if eff:
        return (mod.make_train_step(cfg, rules),
                (params, state, optim.sgdm_init(params), data_))
    return mod.make_train_step(cfg, rules), (params, optim.adamw_init(params),
                                             data_)


def _lm_local(cfg, rules, dtype):
    full = transformer.abstract_params(cfg, ep=rules.tp,
                                       vocab_pad_to=rules.tp, dtype=dtype)
    return cells.local_args(full, transformer.param_specs(cfg, rules), rules)


def _on_mesh(world: int, rank: int, shape, fn):
    """``fn(rules)`` as ``rank`` of a (data, model) = ``shape`` mesh over a
    fake group of ``world`` ranks."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib

    with mesh_lib.fake_group(world, rank):
        rules = sharding.rules_for_mesh(mesh_lib.make_host_mesh(
            data=shape[0], model=shape[1], device=DRYRUN_DEVICE))
        return fn(rules)


def _sent(trace) -> int:
    return sum(r["operand_bytes"] for r in trace["collectives"])


def dryrun_job(job: dict) -> dict:
    """One trace of the [dryrun] phase (in a worker process)."""
    from repro_torch.launch import dryrun

    kind, dev = job["kind"], DRYRUN_DEVICE
    trace = cells.trace_step
    if kind == "flops" and job["what"] == "lm-100m":
        cfg = train.LM_100M
        p = transformer.abstract_params(cfg, dtype=torch.float32)
        batch = {k: _sds((TRAIN_BATCH, TRAIN_SEQ), torch.int32)
                 for k in ("tokens", "labels")}
        t = trace(transformer.make_train_step(cfg),
                  (p, optim.adamw_init(p), batch), dev, memory=False)
        return dict(flops=t["flops"])
    if kind == "flops":                       # ViT-H/14 serve_b128
        from repro_torch.models import vit
        cfg = configs.get("vit-h14").full
        res = configs.get("vit-h14").shape("serve_b128").img_res
        t = trace(lambda p, x: vit.forward(p, x, cfg),
                  (vit.abstract_params(cfg, torch.bfloat16),
                   _sds((128, res, res, 3))), dev, memory=False)
        return dict(flops=t["flops"])
    if kind == "peak":
        rec = configs.get(job["arch"])
        step, args = _zoo_train_args(job["arch"], rec.full, job["batch"],
                                     rec.shape(job["shape"]).img_res)
        return dict(peak=trace(step, args, dev)["peak_bytes"])
    if kind == "shard":
        cfg = _shard_cfg(job["arch"])

        def run(rules):
            p = _lm_local(cfg, rules, layers.COMPUTE_DTYPE)
            prefill = transformer.make_prefill_step(cfg, LM_MAX_SEQ, rules)
            decode = transformer.make_decode_step(cfg, LM_MAX_SEQ, rules)
            tok = _sds((LM_BATCH, LM_SEQ), torch.int32)
            a = trace(prefill, (p, tok), dev, memory=False)
            b = trace(lambda p, t: decode(p, transformer.init_cache(
                cfg, LM_BATCH, LM_MAX_SEQ, dev, rules), t, LM_SEQ),
                (p, _sds((LM_BATCH, 1), torch.int32)), dev, memory=False)
            return dict(prefill=_sent(a), decode=_sent(b))
        return _on_mesh(SHARD_RANKS, job["rank"], (1, SHARD_RANKS), run)
    if kind == "shard_train":
        arch, mesh_shape, batch, _ = SHARD_TRAIN_JOBS[job["index"]]
        cfg = _shard_train_cfg(arch)

        def run(rules):
            p = _lm_local(cfg, rules, torch.float32)
            rows = {k: _sds((batch // rules.dp, TRAIN_SEQ), torch.int32)
                    for k in ("tokens", "labels")}
            t = trace(transformer.make_train_step(cfg, rules,
                                                  lr=SHARD_TRAIN_LR),
                      (p, optim.adamw_init(p), rows), dev, memory=False)
            return dict(step=_sent(t))
        return _on_mesh(SHARD_RANKS, job["rank"], mesh_shape, run)
    if kind == "shard_zoo":
        arch = job["arch"]
        rec = configs.get(arch)
        cfg, mod = rec.full, _zoo_module(arch)
        (tname, tb), serve = SHARD_ZOO_CELLS[arch]
        res = (cfg.img_res if arch.startswith("efficientnet")
               else rec.shape(tname).img_res)

        def run_train(rules):
            step, args = _zoo_train_args(arch, cfg, tb, res, rules)
            return _sent(trace(step, args, dev, memory=False))

        out = dict(train=_on_mesh(SHARD_RANKS, job["rank"],
                                  SHARD_ZOO_TRAIN_MESH, run_train))
        if serve is not None:
            sname, sb = serve
            sres = rec.shape(sname).img_res

            def run_serve(rules):
                p = cells.local_args(mod.abstract_params(cfg),
                                mod.param_specs(cfg, rules), rules)
                if arch.startswith("dit"):
                    r = cfg.latent_res(sres)
                    step = mod.make_sample_step(cfg, rules)
                    i32 = _sds((sb,), torch.int32)
                    args = (p, _sds((sb, r, r, cfg.latent_channels)), i32,
                            i32, i32)
                else:
                    def step(p, x):
                        return mod.forward(p, x, cfg, rules)
                    args = (p, _sds((sb, sres, sres, 3)))
                return _sent(trace(step, args, dev, memory=False))
            out["serve"] = _on_mesh(SHARD_RANKS, job["rank"],
                                    SHARD_ZOO_SERVE_MESH, run_serve)
        return out
    if kind == "production":
        with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as d:
            rep = dryrun.run_one(job["arch"], job["shape"], job["multi_pod"],
                                 d, device=dev)
        return {k: rep[k] for k in (
            "mesh", "n_devices", "flops_per_device", "bytes_per_device",
            "collective_wire_bytes", "peak_memory_bytes", "t_compute",
            "t_memory", "t_collective", "bottleneck", "roofline_fraction",
            "attention", "t_trace_s")}
    raise ValueError(kind)


def _shard_cfg(arch: str):
    """[shard]'s config of ``arch``: FULL, an MoE's capacity factor E/k."""
    cfg = configs.get(arch).full
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=max(
            cfg.capacity_factor, cfg.n_experts / cfg.top_k))
    return cfg


def _shard_train_cfg(arch: str):
    """[shard train]'s config of ``arch``: lm-100m, or the MoE cut to
    SHARD_TRAIN_MOE_LAYERS layers at capacity factor E/k."""
    cfg = train.LM_100M if arch == "lm-100m" else configs.get(arch).full
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, n_layers=SHARD_TRAIN_MOE_LAYERS,
            capacity_factor=max(cfg.capacity_factor,
                                cfg.n_experts / cfg.top_k))
    return cfg


def dryrun_jobs() -> list[dict]:
    """Every trace of the phase, each with a rough cost (seconds of one
    core): the workers take them the longest first."""
    jobs = [dict(kind="flops", what="lm-100m", cost=4),
            dict(kind="flops", what="vit-h14 serve_b128", cost=2)]
    for arch in ZOO_ARCHS:
        names = (ZOO_DIT_TRAIN if arch.startswith("dit")
                 else ZOO_VISION_TRAIN)
        for name in names:
            batch = ZOO_CUTS.get((arch, name),
                                 configs.get(arch).shape(name).batch)
            jobs.append(dict(kind="peak", arch=arch, shape=name,
                             batch=batch,
                             cost=20 if arch.startswith("eff") else 8))
    jobs.append(dict(kind="peak", arch=DRYRUN_CUT[0], shape=DRYRUN_CUT[1],
                     batch=DRYRUN_CUT[2], cost=8))
    for rank in range(SHARD_RANKS):
        for arch in SHARD_ARCHS:
            jobs.append(dict(kind="shard", arch=arch, rank=rank, cost=6))
        for i in range(len(SHARD_TRAIN_JOBS)):
            jobs.append(dict(kind="shard_train", index=i, rank=rank,
                             cost=5))
        for arch in SHARD_ZOO_ARCHS:
            jobs.append(dict(kind="shard_zoo", arch=arch, rank=rank,
                             cost=25 if arch.startswith("eff") else 8))
    for arch, shape, mp in DRYRUN_PRODUCTION:
        jobs.append(dict(kind="production", arch=arch, shape=shape,
                         multi_pod=mp, cost=30))
    return jobs


def dryrun_worker(tmp: str, worker: str) -> int:
    """A worker of the [dryrun] phase: it takes the jobs of ``tmp/jobs.json``
    one at a time, the longest first, each job claimed by creating its
    file (``O_EXCL``: one worker a job), and writes what it traced to
    ``tmp/out<worker>.json`` after each."""
    with open(os.path.join(tmp, "jobs.json")) as f:
        jobs = json.load(f)
    out = []
    for i, job in enumerate(jobs):
        try:
            os.close(os.open(os.path.join(tmp, f"claim{i}"),
                             os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            continue
        t0 = time.perf_counter()
        out.append(dict(job=job, result=dryrun_job(job),
                        s=time.perf_counter() - t0))
        with open(os.path.join(tmp, f"out{worker}.json"), "w") as f:
            json.dump(out, f)
    return 0


def phase_dryrun(numbers: dict, smi: str) -> dict:
    """The tracer against the card (see DRYRUN_WORKERS' comment): the
    traces in DRYRUN_WORKERS subprocesses, which must all end within
    DRYRUN_TIMEOUT_S; any miss raises."""
    t0 = time.perf_counter()
    jobs = sorted(dryrun_jobs(), key=lambda j: -j["cost"])
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as tmp:
        with open(os.path.join(tmp, "jobs.json"), "w") as f:
            json.dump(jobs, f)
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-jobs",
             tmp, str(w)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for w in range(DRYRUN_WORKERS)]
        results, failed = [], []
        try:
            for w, p in enumerate(procs):
                left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
                try:
                    log_text = p.communicate(timeout=max(left, 1))[0]
                except subprocess.TimeoutExpired:
                    failed.append(f"worker {w} past {DRYRUN_TIMEOUT_S} s")
                    continue
                if p.returncode != 0:
                    failed.append(log_text.strip().splitlines()[-12:])
                    continue
                out = os.path.join(tmp, f"out{w}.json")
                if os.path.exists(out):
                    with open(out) as f:
                        results += json.load(f)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    wall = time.perf_counter() - t0
    if failed or len(results) != len(jobs):
        raise AssertionError(f"[dryrun] {len(results)} of {len(jobs)} traces"
                             f" in {wall:.1f} s; failures: {failed}")
    busy = sum(r["s"] for r in results)
    log(f"[dryrun] {len(jobs)} traces on fake cuda tensors (K7/K7b's fakes),"
        f" over fake process groups, in {DRYRUN_WORKERS} worker processes: "
        f"{wall:.1f} s wall, {busy:.1f} s of traces")
    return check_dryrun(results, numbers, smi) | dict(wall_s=wall,
                                                        busy_s=busy)


def check_dryrun(results: list, numbers: dict, smi: str) -> dict:
    """Each trace against what the card counted (see DRYRUN_WORKERS)."""
    by = {}
    for r in results:
        j = r["job"]
        key = tuple(j[k] for k in ("kind", "what", "arch", "shape", "batch",
                                   "index", "rank", "multi_pod") if k in j)
        by[key] = r["result"]
    out, misses = {}, []

    # FLOPs: the card's FlopCounterMode around one real step
    real = {"lm-100m": numbers["train"]["lm100m"]["flops_step"],
            "vit-h14 serve_b128":
                numbers["zoo"]["vit-h14"]["serve_b128"]["flops"]}
    for what, want in real.items():
        got = by["flops", what]["flops"]
        log(f"[dryrun] FLOPs of {what}: traced {got}, the card's "
            f"FlopCounterMode around one real step {want}")
        if got != want:
            misses.append(f"FLOPs {what}: {got} traced, {want} on the card")
        out[f"flops {what}"] = (got, want)

    # Bytes a rank hands to collectives, rank by rank
    for arch in SHARD_ARCHS:
        cfg = _shard_cfg(arch)
        want = (shard_bytes(cfg, SHARD_RANKS, LM_BATCH, LM_SEQ, LM_MAX_SEQ,
                            decode=False),
                shard_bytes(cfg, SHARD_RANKS, LM_BATCH, 1, LM_MAX_SEQ,
                            decode=True))
        got = [(by["shard", arch, r]["prefill"], by["shard", arch, r]["decode"])
               for r in range(SHARD_RANKS)]
        if set(got) != {want}:
            misses.append(f"[shard] {arch} bytes {got}, want {want}")
        out[f"shard {arch}"] = got
    for i, (arch, (dp, tp), batch, _) in enumerate(SHARD_TRAIN_JOBS):
        want = shard_train_bytes(_shard_train_cfg(arch), dp, tp, batch,
                                 TRAIN_SEQ)
        got = [by["shard_train", i, r]["step"] for r in range(SHARD_RANKS)]
        if set(got) != {want}:
            misses.append(f"[shard train] {arch} bytes {got}, want {want}")
        out[f"shard_train {arch}"] = got
    for arch in SHARD_ZOO_ARCHS:
        rec = configs.get(arch)
        cfg = rec.full
        (tname, tb), serve = SHARD_ZOO_CELLS[arch]
        res = (cfg.img_res if arch.startswith("efficientnet")
               else rec.shape(tname).img_res)
        dp, tp = SHARD_ZOO_TRAIN_MESH
        want = shard_zoo_bytes(arch, cfg, dp, tp, tb, res, True)
        got = [by["shard_zoo", arch, r]["train"] for r in range(SHARD_RANKS)]
        if set(got) != {want}:
            misses.append(f"[shard zoo] {arch} train bytes {got}, want "
                          f"{want}")
        if serve is not None:
            sdp, stp = SHARD_ZOO_SERVE_MESH
            swant = shard_zoo_bytes(arch, cfg, sdp, stp, serve[1],
                                    rec.shape(serve[0]).img_res, False)
            sgot = [by["shard_zoo", arch, r]["serve"]
                    for r in range(SHARD_RANKS)]
            if set(sgot) != {swant}:
                misses.append(f"[shard zoo] {arch} serving bytes {sgot}, "
                              f"want {swant}")
        out[f"shard_zoo {arch}"] = got
    log(f"[dryrun] bytes into collectives, each rank's trace: "
        + "; ".join(f"{k} {v[0]}" for k, v in out.items()
                    if k.startswith("shard")) + " (the phases' arithmetic, "
        "which their counts equalled: "
        + ("every rank equal)" if not any("bytes" in m for m in misses)
           else "MISSED)"))

    # Peaks of the one-device [zoo] train cells
    for arch in ZOO_ARCHS:
        names = (ZOO_DIT_TRAIN if arch.startswith("dit")
                 else ZOO_VISION_TRAIN)
        for name in names:
            cell = numbers["zoo"][arch][name]
            got = by["peak", arch, name, cell["batch"]]["peak"]
            want = cell["peak_above_bytes"]
            ratio = got / want
            log(f"[dryrun] peak of [zoo] {arch} {name} at batch "
                f"{cell['batch']}: traced {got} B, measured {want} B above "
                f"the model's start ({ratio:.4f}x; the arithmetic "
                f"ZOO_PREDICTED_PEAK {int(ZOO_PREDICTED_PEAK[arch, name])} "
                f"B, {ZOO_PREDICTED_PEAK[arch, name] / want:.3f}x)")
            if abs(ratio - 1) > DRYRUN_PEAK_TOL:
                misses.append(f"peak {arch} {name}: {got} traced, {want} "
                              f"measured")
            out[f"peak {arch} {name}"] = (got, want)

    # The cut the tool backs: DiT-XL/2 train_1024 at b32 and at b16
    total = torch.cuda.get_device_properties(0).total_memory
    arch, name, b32 = DRYRUN_CUT
    cell = numbers["zoo"][arch][name]
    base = cell["peak_bytes"] - cell["peak_above_bytes"]
    big = by["peak", arch, name, b32]["peak"] + base
    small = by["peak", arch, name, cell["batch"]]["peak"] + base
    log(f"[dryrun] {arch} {name}: at its published batch {b32} the trace "
        f"needs {big} B, at ZOO_CUTS' {cell['batch']} {small} B, with the "
        f"{base} B allocated before the model, against the card's {total} B "
        f"({smi})")
    if not small < total < big:
        misses.append(f"{arch} {name}: b{b32} {big} B and b{cell['batch']} "
                      f"{small} B against {total} B")
    out["cut"] = dict(b32=big, b16=small, total=total)

    # The production meshes
    for arch, shape, mp in DRYRUN_PRODUCTION:
        rep = by["production", arch, shape, mp]
        log(f"[dryrun] production mesh {rep['mesh']} ({rep['n_devices']} "
            f"ranks, attention through {rep['attention']}): {arch} {shape} "
            f"traced in {rep['t_trace_s']} s: {rep['flops_per_device']:.4g} "
            f"FLOPs, {rep['bytes_per_device']:.4g} B (unfused), "
            f"{rep['collective_wire_bytes']:.4g} wire B and a peak of "
            f"{rep['peak_memory_bytes']} B a rank; bound terms (H100 SXM "
            f"constants, not a time measured) compute {rep['t_compute']:.4f}"
            f" s, memory {rep['t_memory']:.4f} s, collective "
            f"{rep['t_collective']:.4f} s ({rep['bottleneck']})")
        out[f"production {arch} {shape}"] = rep
    if misses:
        raise AssertionError("[dryrun] " + "; ".join(misses))
    log("[dryrun] every trace met: FLOPs to the count, bytes on every rank, "
        f"peaks within {DRYRUN_PEAK_TOL:.0%}, the cut backed, both "
        f"production meshes traced")
    return out


def zoo_memory(tag: str) -> int:
    """Device memory allocated before a model, printed; peak reset."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    log(f"[zoo] {tag}: {base} B allocated before")
    return base


# Launches of the counted runs of the arch in hand (a comparison with the
# plain versions or with no remat, a timed repeat or a profile is not
# counted).
ZOO_COUNTED: collections.Counter = collections.Counter()


def zoo_counts(tag: str, want: dict[str, int]) -> dict[str, int]:
    got = read_launches()
    if got != want:
        raise AssertionError(f"[zoo] {tag}: launches {got}, want {want}")
    ZOO_COUNTED.update(got)
    return got


def zoo_finite(tag: str, *ts) -> None:
    for t in ts:
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"[zoo] {tag}: non-finite output")


def zoo_moved(tag: str, before: list, params, share: float = 0.9) -> str:
    """At least ``share`` of the leaves sampled in ``before`` differ from
    their new values (a leaf whose gradient is 0 in exact arithmetic, as a
    bias under a train-mode BN, may stay)."""
    still = [path for (path, old), new in zip(before, tree.leaves(params))
             if torch.equal(old, zoo_sample(new))]
    if len(still) > (1 - share) * len(before):
        raise AssertionError(f"[zoo] {tag}: {len(still)} of {len(before)} "
                             f"leaves did not move: {still[:8]}")
    return f"{len(before) - len(still)} of {len(before)} leaves moved"


def zoo_sample(t: torch.Tensor) -> torch.Tensor:
    """A copy of about 4,096 elements spread over the leaf: what a train
    step moves is checked on these, so the copies stay out of the peak."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // 4096)].clone()


def zoo_snapshot(params) -> list:
    """Samples of every leaf, to check that a train step moved them."""
    return [(p, zoo_sample(t)) for p, t in tree.flatten_with_paths(params)]


def zoo_train(tag: str, step, box: list, batches, layers_n: int,
              kernels: bool, profile_step: bool):
    """ZOO_TRAIN_STEPS steps of ``step(*box[0], batch)`` (the state's
    leading entries are what it returns first; ``box`` holds the state
    alone, so that no old state outlives a step), counted: K7 twice
    ``layers_n`` (the forward and the remat's recompute) and K7b
    ``layers_n`` launches a step when ``kernels``, else none; then, with
    ``profile_step``, one step profiled, its device launches counted the
    same way.  Returns (losses, median ms a step, the profile's device ms
    and K7/K7b ms, or None)."""
    before = zoo_snapshot(box[0][0])
    reset_launches()
    losses, times = [], []
    for i in range(ZOO_TRAIN_STEPS):
        t0 = time.perf_counter()
        *box[0], metrics = step(*box[0], batches(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    n = layers_n * ZOO_TRAIN_STEPS if kernels else 0
    zoo_counts(f"{tag} train", launch_counts(flash_attention=2 * n,
                                             flash_attention_bwd=n))
    if not np.isfinite(losses).all():
        raise AssertionError(f"[zoo] {tag}: losses {losses}")
    log(f"[zoo] {tag}: " + zoo_moved(tag, before, box[0][0]))
    del before
    step_ms = float(np.median(times[1:])) * 1e3
    if not profile_step:
        return losses, step_ms, None
    batch = batches(ZOO_TRAIN_STEPS)
    prof = profiled(lambda: step(*box[0], batch))
    seen = device_launches(prof)
    if (seen["flash_attention"], seen["flash_attention_bwd"]) != (
            2 * layers_n, layers_n):
        raise AssertionError(f"[zoo] {tag}: a profiled step launched "
                             f"{seen}")
    rows = device_time_by_kernel(prof, 1)
    dev = (sum(r[0] for r in rows),
           sum(r[0] for r in rows if "flash_fwd" in r[2]),
           sum(r[0] for r in rows if "flash_bwd" in r[2]))
    log(f"[zoo] {tag}: one step profiled, {sum(r[1] for r in rows):g} "
        f"kernels; the largest:")
    for ms, n, key in rows[:8]:
        log(f"[zoo]   {ms:.3f} ms  x{n:g}  {key[:90]}")
    return losses, step_ms, dev


def zoo_remat_cost(arch: str, step, box: list, pipe) -> dict:
    """ZOO_TRAIN_STEPS steps at ZOO_REMAT_COST_BATCH with remat and as many
    without it: the median ms of steps 1 on and the peak of each, printed
    side by side."""
    out = {}
    for remat in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batches = pipe(ZOO_REMAT_COST_BATCH)
        times = []
        with remat_path(remat):
            for i in range(ZOO_TRAIN_STEPS):
                t0 = time.perf_counter()
                *box[0], _ = step(*box[0], batches(i))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        out["remat" if remat else "plain"] = dict(
            ms=float(np.median(times[1:])) * 1e3,
            peak_bytes=torch.cuda.max_memory_allocated())
    r, p = out["remat"], out["plain"]
    log(f"[zoo] {arch} at batch {ZOO_REMAT_COST_BATCH}, {ZOO_TRAIN_STEPS} "
        f"steps each: with remat {r['ms']:.3f} ms a step, peak "
        f"{r['peak_bytes']} B; without {p['ms']:.3f} ms, peak "
        f"{p['peak_bytes']} B (remat {r['ms'] / p['ms']:.3f}x the time, "
        f"{r['peak_bytes'] / p['peak_bytes']:.3f}x the peak)")
    return out


def zoo_train_cell(arch: str, cfg, shape, step, box: list, pipe,
                   layers_n: int, base: int, profile_step: bool) -> dict:
    """Train steps of one (arch, shape) cell at the shape's published batch,
    halved while a step runs out of the card's memory (each cut printed
    with the allocation that failed), which must end at the batch
    ``ZOO_CUTS`` lists (by default the published one); ``box`` holds the
    state (:func:`zoo_train`), ``pipe(batch)`` gives the cell's batches by
    step.  Returns the cell's numbers."""
    tag = f"{arch} {shape.name}"
    kernels = arch.startswith(("vit", "dit"))
    if arch.startswith("dit"):
        what = "latents"
        size = (f"{cfg.latent_res(shape.img_res)}² latents, "
                f"{cfg.n_tokens(shape.img_res)} tokens")
    else:
        what = "images"
        size = f"{shape.img_res}² images" + (
            f", {cfg.n_tokens(shape.img_res)} tokens" if kernels else "")
    batch = shape.batch
    while True:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        try:
            losses, step_ms, dev = zoo_train(
                f"{tag} batch {batch}", step, box, pipe(batch), layers_n,
                kernels, profile_step)
            break
        except torch.OutOfMemoryError as e:
            if batch == 1:
                raise
            log(f"[zoo] {tag}: batch {batch} does not fit ({base} B "
                f"allocated before the model): {str(e).splitlines()[0]}; "
                f"cut to {batch // 2}")
            batch //= 2
    want = ZOO_CUTS.get((arch, shape.name), shape.batch)
    if batch != want:
        raise AssertionError(f"[zoo] {tag}: ran at batch {batch}, not at "
                             f"{want} (published {shape.batch})")
    predicted = int(ZOO_PREDICTED_PEAK[(arch, shape.name)])
    peak = torch.cuda.max_memory_allocated()
    per_s = batch / step_ms * 1e3
    log(f"[zoo] {tag}: {ZOO_TRAIN_STEPS} train steps at batch {batch} "
        f"(published {shape.batch}), {size}: {step_ms:.3f} ms a step "
        f"(median of steps 1-{ZOO_TRAIN_STEPS - 1}; step 0 the warm-up), "
        f"{per_s:.1f} {what}/s, "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        + (f"one step profiled: device {dev[0]:.3f} ms, K7 {dev[1]:.3f} ms, "
           f"K7b {dev[2]:.3f} ms; " if dev else "")
        + f"device memory {base} B before the model, {held} B with its "
        f"parameters and optimiser state; peak {peak} B, {peak - base} B "
        f"above the model's start against {predicted} B predicted "
        f"({(peak - base) / predicted:.3f}x; {cfg.param_count()} "
        f"parameters)")
    nums = dict(batch=batch, published=shape.batch, ms=step_ms,
                per_s=per_s, losses=losses, held_bytes=held,
                peak_bytes=peak, peak_above_bytes=peak - base,
                predicted_bytes=predicted)
    if dev:
        nums.update(device_ms=dev[0], k7_ms=dev[1], k7b_ms=dev[2])
    return nums


def zoo_serve(tag: str, fn, x, layers_n: int, reps: int) -> dict:
    """One counted call of ``fn(x)`` (K7 ``layers_n`` launches), finite
    output, then its median wall time (CUDA events) and images/s."""
    reset_launches()
    out = fn(x)
    torch.cuda.synchronize()
    zoo_counts(tag, launch_counts(flash_attention=layers_n))
    zoo_finite(tag, *(out if isinstance(out, tuple) else (out,)))
    ms = time_ms(lambda: fn(x), reps)
    with FlopCounterMode(display=False) as fc:       # [dryrun]'s count
        fn(x)
    return dict(ms=ms, images_per_s=x.shape[0] / ms * 1e3,
                flops=fc.get_total_flops())


def zoo_swap(tag: str, loss_fn, params, args, forward) -> dict:
    """Step 0's loss and gradient norm and one forward through K7/K7b and
    through their plain versions (``layers.flash_attention`` swapped)."""
    got = []
    for plain in (False, True):
        loss, norm = loss_and_grad_norm(loss_fn, params, *args, plain=plain)
        with attention_path(plain):
            got.append((loss, norm, forward().float()))
    (lk, gk, ok), (lp, gp, op) = got
    gaps = (abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp),
            ((ok - op).abs().max() / op.abs().max()).item())
    if gaps[0] > SWAP_LOSS_TOL or gaps[1] > ZOO_SWAP_GNORM_TOL \
            or gaps[2] > ZOO_SWAP_OUT_TOL:
        raise AssertionError(f"[zoo] {tag} step 0: kernels ({lk}, {gk}), "
                             f"plain ({lp}, {gp}); gaps {gaps}")
    log(f"[zoo] {tag} step 0 at batch {ZOO_SWAP_BATCH} through K7/K7b: "
        f"loss {lk:.6f}, grad norm {gk:.6f}; through their plain versions: "
        f"{lp:.6f}, {gp:.6f}; relative gaps {gaps[0]:.3e}, {gaps[1]:.3e} "
        f"(tolerances {SWAP_LOSS_TOL}, {ZOO_SWAP_GNORM_TOL}); one forward's "
        f"output {gaps[2]:.3e} of max |plain| (tolerance "
        f"{ZOO_SWAP_OUT_TOL})")
    return dict(loss=(lk, lp), grad_norm=(gk, gp), gaps=gaps)


@contextlib.contextmanager
def remat_path(remat: bool):
    """Train steps with per-layer remat or, without ``remat``, with
    ``layers.scan_layers`` running every layer as a plain loop."""
    saved = layers.scan_layers
    if not remat:
        layers.scan_layers = lambda *a, **kw: saved(*a,
                                                    **{**kw, "remat": False})
    try:
        yield
    finally:
        layers.scan_layers = saved


def zoo_remat_swap(tag: str, loss_fn, params, args) -> dict:
    """Step 0's loss and gradients with remat against the same step
    without it, through K7/K7b both times: the loss within SWAP_LOSS_TOL
    and the gradient norm within ZOO_SWAP_GNORM_TOL; the largest
    differences printed."""
    got = []
    for remat in (True, False):
        with remat_path(remat):
            (loss, _), grads = tree.value_and_grad(loss_fn, params, *args)
        got.append((loss.item(), optim.global_norm(grads).item(), grads))
    (lr, gr, g_r), (ln, gn, g_n) = got
    grad_diff = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(tree.leaves(g_r), tree.leaves(g_n)))
    equal = all(torch.equal(a, b)
                for a, b in zip(tree.leaves(g_r), tree.leaves(g_n)))
    gaps = (abs(lr - ln) / abs(ln), abs(gr - gn) / abs(gn))
    if gaps[0] > SWAP_LOSS_TOL or gaps[1] > ZOO_SWAP_GNORM_TOL:
        raise AssertionError(f"[zoo] {tag} step 0: remat ({lr}, {gr}), no "
                             f"remat ({ln}, {gn}); gaps {gaps}")
    log(f"[zoo] {tag} step 0 at batch {ZOO_SWAP_BATCH} with remat: loss "
        f"{lr:.6f}, grad norm {gr:.6f}; without: {ln:.6f}, {gn:.6f}; "
        f"relative gaps {gaps[0]:.3e}, {gaps[1]:.3e} (tolerances "
        f"{SWAP_LOSS_TOL}, {ZOO_SWAP_GNORM_TOL}); max |loss difference| "
        f"{abs(lr - ln):.3e}, max |gradient difference| {grad_diff:.3e}"
        + ("; every gradient equal bit for bit" if equal else ""))
    return dict(loss=(lr, ln), grad_norm=(gr, gn), gaps=gaps,
                max_grad_diff=grad_diff, bit_equal=equal)


def zoo_vit(arch: str, device) -> tuple[dict, dict]:
    from repro_torch.models import vit
    rec = configs.get(arch)
    cfg, res = rec.full, rec.shape("cls_224").img_res
    l_n, nums = cfg.n_layers, {}
    base = zoo_memory(arch)
    g = torch.Generator(device=device).manual_seed(0)
    params = vit.init_params(cfg, g, device, dtype=torch.bfloat16)
    for b in ZOO_SERVE_BATCHES:
        x = torch.rand((b, res, res, 3), device=device, generator=g)
        nums[f"serve_b{b}"] = zoo_serve(
            f"{arch} serve_b{b}", lambda x: vit.forward(params, x, cfg), x,
            l_n, 10 if b == 1 else 3)
    del params, x
    params = vit.init_params(cfg, g, device, dtype=torch.float32)
    box = [(params, optim.adamw_init(params))]
    del params
    step = vit.make_train_step(cfg)
    for name in ZOO_VISION_TRAIN:
        # cls_384: the position table resized (14 -> 24, 16 -> 27)
        shape = rec.shape(name)
        nums[name] = zoo_train_cell(
            arch, cfg, shape, step, box,
            lambda b, r=shape.img_res: data.ImagePipeline(
                seed=0, batch=b, img_res=r, n_classes=cfg.n_classes,
                device=device, prefetch=0).batch_at, l_n, base,
            name == "cls_224")
    if arch in ZOO_SWAP_ARCHS:
        nums["remat_cost"] = zoo_remat_cost(
            arch, step, box, lambda b: data.ImagePipeline(
                seed=2, batch=b, img_res=res, n_classes=cfg.n_classes,
                device=device, prefetch=0).batch_at)
        b2 = data.ImagePipeline(seed=0, batch=ZOO_SWAP_BATCH, img_res=res,
                                n_classes=cfg.n_classes, device=device,
                                prefetch=0).batch_at(0)
        params = box[0][0]
        nums["swap"] = zoo_swap(arch, vit.loss_fn, params, (b2, cfg),
                                lambda: vit.forward(params, b2["images"],
                                                    cfg))
        nums["remat_swap"] = zoo_remat_swap(arch, vit.loss_fn, params,
                                            (b2, cfg))
        del params
    del box
    per = launch_counts(flash_attention=2 * l_n, flash_attention_bwd=l_n)
    return per, nums


def zoo_dit_params(cfg, g, device, dtype):
    from repro_torch.models import dit
    params = dit.init_params(cfg, g, device, dtype=dtype)
    for tree_ in (params, params["layers"]):
        for name in ZOO_ADALN_LEAVES:
            if name in tree_:
                t = tree_[name]
                t.copy_(torch.randn(t.shape, device=device, generator=g)
                        .mul_(ZOO_ADALN_STD))
    return params


def zoo_dit(arch: str, device) -> tuple[dict, dict]:
    from repro_torch.models import dit
    cfg = configs.get(arch).full
    rec = configs.get(arch)
    l_n, nums = cfg.n_layers, {}
    base = zoo_memory(arch)
    g = torch.Generator(device=device).manual_seed(0)
    params = zoo_dit_params(cfg, g, device, torch.bfloat16)
    sample = dit.make_sample_step(cfg)
    for name, n_steps in (("gen_fast", None),
                          ("gen_1024", ZOO_GEN_1024_STEPS)):
        shape = rec.shape(name)
        r = cfg.latent_res(shape.img_res)
        ts = np.linspace(cfg.n_train_timesteps - 1, 0,
                         shape.steps).round().astype(int)
        prev = list(ts[1:]) + [-1]
        n_steps = n_steps or shape.steps
        x = torch.randn((shape.batch, r, r, cfg.latent_channels),
                        device=device, generator=g)
        labels = torch.randint(0, cfg.n_classes, (shape.batch,),
                               device=device, generator=g)
        reset_launches()
        times = []
        for i in range(n_steps):
            tt = torch.full((shape.batch,), int(ts[i]), device=device)
            tp = torch.full((shape.batch,), int(prev[i]), device=device)
            t0 = time.perf_counter()
            x = sample(params, x, tt, tp, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        zoo_counts(f"{arch} {name}", launch_counts(
            flash_attention=l_n * n_steps))
        zoo_finite(f"{arch} {name}", x)
        step_ms = float(np.median(times[1:] or times)) * 1e3
        log(f"[zoo] {arch} {name}: batch {shape.batch}, {r}² latents, "
            f"{cfg.n_tokens(shape.img_res)} tokens, DDIM steps "
            f"{[int(t) for t in ts[:n_steps]]} of {shape.steps}: "
            f"{step_ms:.3f} ms a sample step, sampled latents finite "
            f"(|x| max {x.abs().max().item():.3f})")
        nums[name] = dict(ms=step_ms, steps=n_steps,
                          tokens=cfg.n_tokens(shape.img_res))
        del x
    del params
    params = zoo_dit_params(cfg, g, device, torch.float32)
    box = [(params, optim.adamw_init(params))]
    del params
    step = dit.make_train_step(cfg)
    for name in ZOO_DIT_TRAIN:
        shape = rec.shape(name)
        nums[name] = zoo_train_cell(
            arch, cfg, shape, step, box,
            lambda b, r=cfg.latent_res(shape.img_res): data.LatentPipeline(
                seed=0, batch=b, latent_res=r, n_classes=cfg.n_classes,
                device=device, prefetch=0).batch_at, l_n, base,
            name == "train_256")
    if arch in ZOO_SWAP_ARCHS:
        nums["remat_cost"] = zoo_remat_cost(
            arch, step, box, lambda b: data.LatentPipeline(
                seed=2, batch=b, latent_res=cfg.latent_res(),
                n_classes=cfg.n_classes, device=device,
                prefetch=0).batch_at)
        b2 = data.LatentPipeline(seed=0, batch=ZOO_SWAP_BATCH,
                                 latent_res=cfg.latent_res(),
                                 n_classes=cfg.n_classes, device=device,
                                 prefetch=0).batch_at(0)
        params = box[0][0]
        nums["swap"] = zoo_swap(
            arch, dit.train_loss, params, (b2, cfg),
            lambda: dit.forward(params, b2["latents"], b2["t"],
                                b2["labels"], cfg)[0])
        nums["remat_swap"] = zoo_remat_swap(arch, dit.train_loss, params,
                                            (b2, cfg))
        del params
    del box
    per = launch_counts(flash_attention=2 * l_n, flash_attention_bwd=l_n)
    return per, nums


def zoo_convnet(arch: str, device) -> tuple[dict, dict]:
    """ConvNeXt-B or EfficientNet-B7: no kernel of the port's (the
    reference leaves their convs to XLA), so K7 and K7b launch 0 times."""
    from repro_torch.models import convnext, efficientnet
    rec = configs.get(arch)
    cfg, res = rec.full, rec.shape("serve_b1").img_res
    eff = arch.startswith("efficientnet")
    nums = {}
    base = zoo_memory(arch)
    g = torch.Generator(device=device).manual_seed(0)
    if eff:
        params, state = efficientnet.init_params(cfg, g, device,
                                                 dtype=torch.bfloat16)

        def serve(x):
            return efficientnet.apply(params, state, x, cfg, train=False)[0]
    else:
        params = convnext.init_params(cfg, g, device, dtype=torch.bfloat16)

        def serve(x):
            return convnext.forward(params, x, cfg)
    runs = [(b, res) for b in ZOO_SERVE_BATCHES]
    if eff:
        runs.append((1, cfg.img_res))          # B7's native 600
    for b, r in runs:
        x = torch.rand((b, r, r, 3), device=device, generator=g)
        key = f"serve_b{b}" + ("" if r == res else f"_{r}")
        nums[key] = zoo_serve(f"{arch} {key}", serve, x, 0,
                              10 if b == 1 else 3)
        del x
    del params
    if eff:
        params, bn = efficientnet.init_params(cfg, g, device,
                                              dtype=torch.float32)
        bn0 = zoo_snapshot(bn)
        box = [(params, bn, optim.sgdm_init(params))]
        del bn
        step = efficientnet.make_train_step(cfg)
    else:
        params = convnext.init_params(cfg, g, device, dtype=torch.float32)
        box = [(params, optim.adamw_init(params))]
        step = convnext.make_train_step(cfg)
    del params
    for name in ZOO_VISION_TRAIN:
        shape = rec.shape(name)
        nums[name] = zoo_train_cell(
            arch, cfg, shape, step, box,
            lambda b, r=shape.img_res: data.ImagePipeline(
                seed=0, batch=b, img_res=r, n_classes=cfg.n_classes,
                device=device, prefetch=0).batch_at, 0, base, False)
    if eff:
        log(f"[zoo] {arch} BN state: "
            + zoo_moved(f"{arch} BN state", bn0, box[0][1], share=1.0))
    del box
    return launch_counts(), nums


def phase_zoo(device, smi: str) -> tuple[dict, dict, dict]:
    """The vision and diffusion archs at full width and depth, one at a
    time (memory before, peak after): serving, sampling and training on
    the card; K7 and K7b counted.  Returns (launches of the counted runs
    by arch, launches a forward and a train step by arch, numbers)."""
    t0 = time.perf_counter()
    log(f"[zoo] card: {smi}")
    launches, per_step, numbers = {}, {}, {}
    for arch in ZOO_ARCHS:
        t1 = time.perf_counter()
        ZOO_COUNTED.clear()
        if arch.startswith("vit"):
            per, nums = zoo_vit(arch, device)
        elif arch.startswith("dit"):
            per, nums = zoo_dit(arch, device)
        else:
            per, nums = zoo_convnet(arch, device)
        launches[f"zoo_{arch}"] = launch_counts(**ZOO_COUNTED)
        per_step[f"zoo_{arch}"] = per
        numbers[arch] = nums
        for key, v in nums.items():
            if key.startswith("serve"):
                log(f"[zoo] {arch} {key}: {v['ms']:.3f} ms a forward, "
                    f"{v['images_per_s']:.1f} images/s")
        log(f"[zoo] {arch} took {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log("[zoo] K7, K7b launches of the counted runs " + str(
        {a: (c["flash_attention"], c["flash_attention_bwd"])
         for a, c in launches.items()}) + "; a train step each " + str(
        {a: (c["flash_attention"], c["flash_attention_bwd"])
         for a, c in per_step.items()}))
    log(f"[zoo] phase took {time.perf_counter() - t0:.1f} s")
    return launches, per_step, numbers


# The autotune phase: (workload, buckets tuned in order).  VGG16 (224²)
# only at bucket 1, to keep the run's time.
AUTO_RUNS = [("alexnet_imagenet", (8, 1)), ("yolov2_tiny_voc", (8, 1)),
             ("vgg16_imagenet", (1,))]
# The wrapper a node's backend launches: (first layer, other layers).
AUTO_KERNELS = {
    "cuda_direct": ("direct_conv_bn_binarize_planes",
                    "direct_conv_bn_binarize"),
    "cuda_direct_pool": ("direct_conv_bn_binarize_planes",
                         "direct_conv_bn_binarize"),
    "cuda_pm1": ("xnor_popcount_matmul_planes", "mxu_pm1_matmul"),
    "cuda_popcount": ("fused_matmul_bn_binarize",
                      "fused_matmul_bn_binarize"),
}


def auto_launches(engine, exe) -> dict[str, int]:
    """The launches one forward of a tuned executor must make: K4 once,
    and each node's winner's kernel (the first layer's bit-plane variant
    where the winner has one)."""
    want = launch_counts(bitplane_pack=1)
    for row in exe.backend_report():
        first = bool(engine._graph.nodes[row["node"]].attrs.get("first"))
        want[AUTO_KERNELS[row["backend"]][0 if first else 1]] += 1
    return want


def default_ms(node, shape, entry: dict) -> tuple[str, float | None]:
    """The default path's backend for ``node`` and its time in a sweep
    (``cuda_direct_pool`` degraded along the fallback order, at
    ``plan_mma``'s tile, the sweep's first of that backend)."""
    from repro_torch.runtime import autotune, executor
    backend = executor.resolve_backend(node.op, "cuda_direct_pool")
    tile = autotune.tile_candidates(
        backend, node, shape, k3.mma_limits(torch.device("cuda", 0)))[0]
    return backend, entry["timings_ms"].get(autotune.label(backend, tile))


def phase_autotune(device) -> dict:
    """Engines under ``matmul_mode="auto"`` on the paper nets: tune each
    bucket (AlexNet and YOLOv2-Tiny at 8 then 1, VGG16 at 1), print every
    node's winner, tile and sweep, hold each bucket's output to
    ``cross_check`` and its launches to its winners; bucket 1 must reuse
    bucket 8's winners (``xfer_hit``), and a second engine must re-time
    nothing.  At bucket 1 a fresh sweep of each transferred K3 node times
    the transferred winner beside the fastest.  Returns the winners, the
    outcomes and the launches a forward."""
    # Imported here, not at the top: tools/kernel_times.py runs this
    # script's timing phase on trees that predate the autotuner.
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.runtime import autotune
    out: dict = {"runs": [], "launches": {}}
    g = torch.Generator(device=device).manual_seed(4)
    for name, buckets in AUTO_RUNS:
        wl = workloads.get(name, seed=0, matmul_mode="auto")
        eng = wl.engine.engine
        h, w = wl.input_hw
        for b in buckets:
            with obs_metrics.use_registry() as reg:
                t0 = time.perf_counter()
                eng.compile(b, capture=False)     # tuned, eagerly timed
                tune_s = time.perf_counter() - t0
                outcomes = dict(collections.Counter(
                    e["outcome"] for e in reg.events("autotune")))
            # Bucket 1 after 8 re-times nothing: bucket 8's winners
            # transfer (a node identical to an earlier one of the same
            # graph is a plain hit).
            if b == 1 and len(buckets) > 1 and (
                    "xfer_hit" not in outcomes
                    or not set(outcomes) <= {"xfer_hit", "hit"}):
                raise AssertionError(f"[autotune] {name} bucket 1 after 8: "
                                     f"{outcomes}, want xfer_hit")
            x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                              device=device, generator=g)
            reset_launches()
            exe = eng.compile(b)                   # the winners, captured
            torch.cuda.synchronize()
            counted = read_launches()
            launches = auto_launches(eng, exe)
            replayed = replay_launches(exe)
            if counted != scaled(launches, capture_calls()) \
                    or replayed != scaled(launches, REPLAYS):
                raise AssertionError(f"[autotune] {name} bucket {b} "
                                     f"launches {counted} over the "
                                     f"capture, {replayed} in {REPLAYS} "
                                     f"replays; want {launches} a forward")
            eng.cross_check(x)
            out["launches"][f"auto_{name}_{b}"] = launches
            types = runtime_types(eng, b)
            rows = []
            for r in exe.backend_report():
                node = eng._graph.nodes[r["node"]]
                shape = types[node.inputs[0]].shape
                entry = eng._tuner.entry(node, shape)
                if r["backend"] in autotune.PLAIN_BACKENDS:
                    raise AssertionError(f"[autotune] {name} node "
                                         f"{r['node']} won by {r['backend']}")
                dflt, dflt_ms = default_ms(node, shape, entry)
                won_ms = entry["timings_ms"][autotune.label(r["backend"],
                                                             r["tile"])]
                rows.append(dict(node=r["node"], op=r["op"],
                                 channels=r["channels"],
                                 winner=r["backend"], tile=r["tile"],
                                 winner_ms=won_ms, default=dflt,
                                 default_ms=dflt_ms,
                                 transferred=bool(
                                     entry.get("reused_across_batch")),
                                 timings_ms=entry["timings_ms"]))
                log(f"[autotune] {name} bucket {b} node {r['node']} "
                    f"{r['op']} ({r['channels']} ch): {r['backend']} "
                    f"{r['tile'] or ''} {won_ms:.4f} ms"
                    + (" (bucket 8's)" if rows[-1]["transferred"] else "")
                    + f"; default {dflt} {dflt_ms} ms; sweep "
                    f"{entry['timings_ms']}")
            log(f"[autotune] {name} bucket {b}: tuned in {tune_s:.3f} s, "
                f"outcomes {outcomes}, launches a forward "
                f"{ {k: v for k, v in launches.items() if v} }, output == "
                f"cross_check")
            out["runs"].append(dict(workload=name, bucket=b, tune_s=tune_s,
                                    outcomes=outcomes, nodes=rows))
            if b == 1 and len(buckets) > 1:
                out["runs"][-1]["fresh"] = fresh_sweep(eng, exe, types, b)
        # A second engine in this process re-times nothing.
        again = workloads.get(name, seed=0, matmul_mode="auto").engine.engine
        with obs_metrics.use_registry() as reg:
            for b in buckets:
                again.compile(b, capture=False)
            seen = set(e["outcome"] for e in reg.events("autotune"))
        if not seen <= {"hit", "disk_hit"}:
            raise AssertionError(f"[autotune] {name} second engine: {seen}")
        log(f"[autotune] {name} second engine, buckets {buckets}: outcomes "
            f"{sorted(seen)} (nothing re-timed)")
    wl = workloads.get("alexnet_imagenet", seed=0, matmul_mode="auto")
    out["profile"] = phase_profile(wl)
    return out


def runtime_types(eng, b: int):
    from repro_torch.runtime.graph import infer_types
    return infer_types(eng._graph, eng._plan_shape(b))


def fresh_sweep(eng, exe, types, b: int) -> list[dict]:
    """At bucket ``b``, time each K3 node's transferred winner beside a
    fresh sweep's fastest (a tuner with empty caches, persisting
    nothing): the cost of the transfer rule."""
    from repro_torch.runtime import autotune
    fresh = autotune.Autotuner(cache={}, agnostic_cache={}, persist=False,
                               device=eng.device)
    rows = []
    for r in exe.backend_report():
        if r["backend"] not in ("cuda_direct", "cuda_direct_pool"):
            continue
        node = eng._graph.nodes[r["node"]]
        t = types[node.inputs[0]]
        entry = fresh._tune_node(node, t.shape, t.dtype)
        x = torch.zeros(t.shape, dtype=t.dtype, device=eng.device)
        kept_ms = fresh._time_node(node, x, r["backend"], r["tile"]) * 1e3
        best = min(entry["timings_ms"].items(), key=lambda kv: kv[1])
        dflt, dflt_ms = default_ms(node, t.shape, entry)
        rows.append(dict(node=r["node"], transferred=r["backend"],
                         tile=r["tile"], transferred_ms=kept_ms,
                         fresh_winner=best[0], fresh_ms=best[1],
                         default=dflt, default_ms=dflt_ms))
        log(f"[autotune] bucket {b} node {r['node']}: transferred "
            f"{r['backend']} {r['tile']} {kept_ms:.4f} ms; a fresh sweep's "
            f"fastest {best[0]} {best[1]:.4f} ms, its default {dflt} "
            f"{dflt_ms} ms")
    return rows


def check_chain_tiles(engine, inp: Inputs) -> int:
    """Every tile ``tune_chains`` timed for the regions of ``engine``'s
    compiled buckets, run through K5 and its plain version on random
    entry words, bit for bit.  Returns the tiles checked."""
    from repro_torch.runtime import autotune
    params = {str(nid): n.params for nid, n in engine._graph.nodes.items()
              if n.params}
    checked = 0
    for (b, _), exe in sorted(engine._compiled.items()):
        for chain in exe.regions:
            # Entry words of random bits with 0 pad bits, as K4 or a
            # packed node leaves them.
            n, h, w, _ = chain.in_shape
            if chain.stages[0].first:
                x = inp.channel_words((n, h, w, bitplanes.NUM_PLANES),
                                      engine._plan_shape(n)[3])
            else:
                src = engine._graph.nodes[chain.head].inputs[0]
                x = inp.channel_words(
                    (n, h, w), engine._graph.nodes[src].attrs["channels"])
            x = x.reshape(chain.in_shape).contiguous()
            ops = chain.operands(params)
            entry = engine._tuner.chain_entry(chain)
            tiles = autotune.chain_tile_candidates(chain)
            for tile in tiles:
                offs, words = chain.arena(tile)
                kw = dict(tile, arena_offsets=offs, arena_words=words)
                check_equal(f"chain tile {tile} bucket {b}",
                            k5.chain_conv(x, chain.stages, ops, **kw),
                            k5.chain_conv_plain(x, chain.stages, ops, **kw))
                checked += 1
            log(f"[chain tiles] bucket {b} region "
                f"{'+'.join(map(str, chain.node_ids))} {chain.in_shape}: "
                f"{len(tiles)} tiles == plain version; sweep "
                f"{entry['timings_ms']}, chosen {chain.tile or 'whole map'}")
    return checked


def phase_traced_serve(wl, rng: np.random.Generator) -> list[str]:
    """One batch of 8 served untraced, then traced: equal rows, and the
    Chrome export passes ``validate_trace``.  Returns the span names."""
    from repro_torch.obs import trace as obs_trace
    imgs = [rng.integers(0, 256, (227, 227, 3), dtype=np.uint8)
            for _ in range(BATCH)]

    def serve():
        server = wl.server(max_batch=BATCH, buckets=(BATCH,))
        reqs = [server.submit(im) for im in imgs]
        server.drain()
        if not all(r.outcome == "served" for r in reqs):
            raise AssertionError("[trace] a request was not served")
        return np.stack([r.result for r in reqs]), server
    plain, _ = serve()
    tracer = obs_trace.install()
    try:
        traced, server = serve()
    finally:
        obs_trace.uninstall()
    if not np.array_equal(plain, traced):
        raise AssertionError("[trace] traced rows != untraced rows")
    doc = tracer.to_chrome()
    spans = obs_trace.validate_trace(doc)
    names = sorted({e["name"] for e in doc["traceEvents"]})
    need = {"serve.submit", "serve.assemble", "serve.stage",
            "serve.dispatch", "serve.device", "serve.scatter",
            "executor.call"}
    if not need <= set(names):
        raise AssertionError(f"[trace] missing {need - set(names)}")
    log(f"[trace] {wl.matmul_mode} batch of {BATCH} traced: rows == "
        f"untraced, {len(spans)} spans + "
        f"{len(doc['traceEvents']) - len(spans)} instants validate, names "
        f"{names}; device {doc['metadata']['device_kind']}; flight "
        f"recorder {len(server.flight)} records, last "
        f"{server.flight.last()[0]}")
    return names


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


# Idle host time at each end of a profiler session's kept step.
PROFILE_MARGIN_S = 0.05


def profiled(run, first=None) -> profile:
    """A torch.profiler session (CPU and CUDA) over two steps, each closed
    by a synchronize: ``first`` (default: ``run``) is traced and dropped,
    then ``run`` is kept, with ``PROFILE_MARGIN_S`` of idle time before
    and after it.  The profiler keeps a device record only if its time,
    mapped from the card's clock to the host's, falls inside the kept
    step; late in a long run that mapping drifts, and sessions without
    the margins lost their first records (3 of 20 a kernel in the timing
    phase, and once all 20)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                  active=1)) as prof:
        (first or run)()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        run()                         # the session ends on this step
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return prof


def device_time_by_kernel(prof, reps: int) -> list[tuple[float, float, str]]:
    """(ms per rep, records per rep, name) of each device-side event.

    A session may miss the records of the first few launches (late in a
    long run, 3 of 20 at every kernel of the timing phase) or catch a
    stray event from before it began, so an event's time a rep is the
    mean of its records times its launches a rep (its records a rep,
    rounded); an event of less than half a record a rep is a stray and is
    left out.  Every session that missed records or left strays out says
    so in the log."""
    rows, missing, strays = [], 0, 0
    for e in prof.key_averages():
        # Device-side events only (kernels, copies): a CPU op may report
        # its kernels' time too, which would count them twice.
        us = getattr(e, "self_device_time_total", 0) or 0
        # ProfilerStep* is the session step's own range (see profiled).
        if us <= 0 or e.device_type == torch.autograd.DeviceType.CPU \
                or e.key.startswith("ProfilerStep"):
            continue
        per_rep = round(e.count / reps)
        if per_rep >= 1:
            rows.append((us / e.count * per_rep / 1e3, e.count / reps, e.key))
            missing += max(0, per_rep * reps - e.count)
        else:
            strays += e.count
    if missing or strays:
        log(f"[profiler] a session of {reps} reps missed {missing} of "
            f"{sum(round(n) for _, n, _ in rows) * reps} records "
            f"(rescaled) and left out {strays} stray records")
    rows.sort(reverse=True)
    return rows


# The [faults] phase's LM run: the cut cadence and the tick the decode
# faults start at (in the second wave of requests, all four slots busy).
LM_CHECKPOINT_EVERY, LM_FAULT_AFTER = 8, 20


def lm_faults(server: LMServer, prompts, want_tokens, step_ms: float) -> dict:
    """The captured ``LMServer`` (full depth) serving ``prompts`` again with
    ``checkpoint_every=8`` under a plan: ``lm.step`` faults from tick
    ``LM_FAULT_AFTER`` as many times as the retry budget, so the server
    restores the last cut into the captured step's buffers and replays
    the ticks since; one cadence ``kv.snapshot`` fault keeps the cut
    before it.  The tokens must equal the unfaulted captured run's, with
    one restore; no K7 launch.  Each snapshot is timed (host time to queue
    its copies, their device time, bytes)."""
    with torch.inference_mode():
        server._restart()
        for t in server.cache.values():
            t.zero_()
    server.checkpoint_every = LM_CHECKPOINT_EVERY
    ck, stats = server.checkpointer, []
    take = ck.take

    def timed_take(*a, **kw):
        cut = take(*a, **kw)
        stats.append(dict(reason=cut.reason, seqs=len(cut.seqs),
                          bytes=ck.last_bytes,
                          enqueue_ms=ck.last_enqueue_s * 1e3,
                          copy_ms=ck.last_copy_ms()))
        return cut
    ck.take = timed_take
    plan = FaultPlan([
        FaultSpec("lm.step", "device_fault", after=LM_FAULT_AFTER,
                  times=server.retry.max_attempts),
        FaultSpec("kv.snapshot", "device_fault", times=1,
                  match={"reason": "cadence"})], seed=7)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with faults.inject(plan):
        reqs = [server.submit(p, max_new=m) for p, m in prompts]
        server.drain()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    del ck.take
    tokens = [r.result for r in reqs]
    restored = [f for f in server.flight.dump()
                if f.get("outcome") == "restored"]
    if tokens != want_tokens or server.restores != 1 or len(restored) != 1 \
            or ck.failed != 1 or launches != launch_counts() \
            or [f["site"] for f in plan.log] \
            != ["kv.snapshot"] + ["lm.step"] * server.retry.max_attempts:
        raise AssertionError(f"[lm] faulted run: tokens equal "
                             f"{tokens == want_tokens}, restores "
                             f"{server.restores}, snapshot faults "
                             f"{ck.failed}, launches {launches}, fault log "
                             f"{plan.log}")
    full = [st for st in stats if st["seqs"] == LM_SERVER_SLOTS]
    out = dict(snapshots=len(stats), snapshot_faults=ck.failed,
               full_cut=full[-1] if full else None,
               replayed=restored[0]["replayed"],
               restore_ms=restored[0]["restore_s"] * 1e3,
               retries=server.metrics()["retries"], wall_s=wall_s)
    cut = out["full_cut"]
    log(f"[lm] faulted run, checkpoint_every {LM_CHECKPOINT_EVERY}: "
        f"lm.step faulted {server.retry.max_attempts} times from tick "
        f"{LM_FAULT_AFTER} (retries {out['retries']}), one restore replayed "
        f"{out['replayed']} ticks through the captured step in "
        f"{out['restore_ms']:.3f} ms (copies back, replay, synchronize); "
        f"one cadence snapshot fault kept the cut; {len(stats)} snapshots; "
        f"the {sum(map(len, tokens))} tokens == the unfaulted captured "
        f"run's; K7 launches 0; {wall_s:.3f} s")
    if cut is not None:
        log(f"[lm] a {cut['seqs']}-slot cut ({cut['reason']}): "
            f"{cut['bytes']} B, {cut['enqueue_ms']:.3f} ms of host time to "
            f"queue its copies, {cut['copy_ms']:.3f} ms of device time for "
            f"them, beside a {step_ms:.3f} ms decode step")
    server.checkpoint_every = None
    return out


# The [placement] phase's LM lanes: LM_REQUESTS routed over 2 lanes of
# LM_SERVER_SLOTS slots; then a faulted round: LANE_FAULT_REQUESTS pinned
# (lane, prompt length, max_new), lm1's decode faulting from its
# LANE_FAULT_AFTER-th tick on, past one restore.
LANE_FAULT_REQUESTS = [("lm0", 16, 8), ("lm0", 16, 8), ("lm1", 16, 32),
                       ("lm1", 16, 32)]
LANE_FAULT_AFTER = 10


def lm_lanes(cfg, params, device) -> tuple[dict, dict]:
    """``LMReplicaGroup`` of ``cfg`` at full width and depth: 2 lanes over
    the one params dict (no weight copied), each with its own cache and
    captured decode step.  The 8 requests are routed over both lanes and
    served; then lm1's decode faults outlast its restore budget
    (``max_restore_attempts=1``), its flight migrates to lm0 by replay
    prefill, every request is served, each migrated one keeps the tokens
    it had emitted verbatim, lm1 is quarantined, and no K7 launches (the
    lanes prefill through the decode step).  Returns (launches, numbers)."""
    from repro_torch.distributed import LMReplicaGroup

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    grp = LMReplicaGroup(cfg, None, params, n_slots=LM_SERVER_SLOTS,
                         max_seq=LM_SERVER_MAX_SEQ, device=device,
                         checkpoint_every=4, max_restore_attempts=1)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    lanes = [ln.server for ln in grp.lanes.values()]
    if any(s.params is not params for s in lanes) \
            or lanes[0].cache["k"].data_ptr() == lanes[1].cache["k"].data_ptr() \
            or any(s.capture_count != 1 for s in lanes):
        raise AssertionError("[placement] LM lanes copy the weights, share a "
                             "cache or lack a captured step")
    lane_bytes = torch.cuda.memory_allocated() - base
    rng = np.random.default_rng(5)
    prompts = [([int(t) for t in rng.integers(0, cfg.vocab, n)], m)
               for n, m in LM_REQUESTS]
    reset_launches()
    t0 = time.perf_counter()
    reqs = [grp.submit(p, max_new=m) for p, m in prompts]
    grp.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    clean = read_launches()
    m = grp.metrics()
    per_lane = {n: v["served"] for n, v in m["lanes"].items()}
    if not all(r.outcome == "served" and len(r.result) == mn
               for r, (_, mn) in zip(reqs, LM_REQUESTS)) \
            or min(per_lane.values()) == 0 or grp.migrations \
            or clean != launch_counts():
        raise AssertionError(f"[placement] LM lanes: "
                             f"{[r.outcome for r in reqs]}, {per_lane}, "
                             f"launches {clean}")
    generated = sum(len(r.result) for r in reqs)
    log(f"[placement] LMReplicaGroup of {cfg.name} (full width and depth), "
        f"2 lanes x {LM_SERVER_SLOTS} slots, max_seq {LM_SERVER_MAX_SEQ}: "
        f"boot {boot_s:.3f} s, {lane_bytes} B for both lanes' caches and "
        f"graphs (the weights shared); {len(reqs)} requests routed "
        f"{per_lane}, all served, {generated} tokens in {serve_s:.3f} s "
        f"({generated / serve_s:.2f} generated tokens/s); K7 launches 0")

    # The faulted round: lm1's decode faults from its
    # LANE_FAULT_AFTER-th tick on; its flight migrates to lm0.
    prefixes = {}
    hook = grp.lanes["lm1"].server.evacuate

    def spy(items):
        prefixes.update({r.id: list(seq.tokens) for r, seq in items})
        return hook(items)
    grp.lanes["lm1"].server.evacuate = spy
    fault_reqs = []
    reset_launches()
    t0 = time.perf_counter()
    with faults.inject([FaultSpec("lm.step", "device_fault",
                                  after=LANE_FAULT_AFTER,
                                  match={"tenant": "lm1"})]) as plan:
        for lane, n, mn in LANE_FAULT_REQUESTS:
            prompt = [int(t) for t in rng.integers(0, cfg.vocab, n)]
            fault_reqs.append((grp.submit(prompt, max_new=mn, lane=lane),
                               mn))
        grp.drain()
    torch.cuda.synchronize()
    fault_s = time.perf_counter() - t0
    faulted = read_launches()
    m = grp.metrics()
    adopted = [f for f in grp.lanes["lm0"].server.flight.dump()
               if f.get("kind") == "migration"]
    migrated = [r for r, _ in fault_reqs if r.id in prefixes]
    if not all(r.outcome == "served" and len(r.result) == mn
               for r, mn in fault_reqs) \
            or grp.migrations < 1 or len(migrated) != grp.migrations \
            or not all(prefixes[r.id] and r.result[:len(prefixes[r.id])]
                       == prefixes[r.id] for r in migrated) \
            or not m["routing"]["lm1"]["quarantined"] \
            or m["routing"]["lm0"]["quarantined"] \
            or len(adopted) != 1 or faulted != launch_counts():
        raise AssertionError(f"[placement] LM migration: outcomes "
                             f"{[r.outcome for r, _ in fault_reqs]}, "
                             f"migrations {grp.migrations}, prefixes "
                             f"{prefixes}, routing {m['routing']}, launches "
                             f"{faulted}")
    # Each adoption replays the prompt and all but the last emitted token.
    replayed = sum(len(r.payload[0]) + len(prefixes[r.id]) - 1
                   for r in migrated)
    adopt_ms = adopted[0]["adopt_s"] * 1e3
    log(f"[placement] lm1's decode faulted {len(plan.log)} times from its "
        f"tick {LANE_FAULT_AFTER + 1} (restores {m['routing']['lm1']['restores']}"
        f", then evacuation): {len(migrated)} sequences migrated to lm0 with "
        f"their emitted prefixes ({[len(p) for p in prefixes.values()]} "
        f"tokens) kept verbatim, every request served; the replay prefill "
        f"of {replayed} tokens took {adopt_ms:.3f} ms on lm0; lm1 "
        f"quarantined; the round took {fault_s:.3f} s; K7 launches 0")
    numbers = dict(boot_s=boot_s, lane_bytes=lane_bytes,
                   served=per_lane, generated_tokens_per_s=generated / serve_s,
                   migrations=grp.migrations, replayed_tokens=replayed,
                   adopt_ms=adopt_ms, fault_round_s=fault_s,
                   restores=m["routing"]["lm1"]["restores"])
    return {k: clean[k] + faulted[k] for k in clean}, numbers


def decode_step_numbers(srv: LMServer, reps: int = 5) -> tuple[dict, list]:
    """Host wall a step of ``srv``'s decode step (no profiler) and its
    device time, busy share and device events under the profiler, over
    ``reps`` steps each at its own position (the tokens as they are).
    Returns (those numbers, the profile's rows by kernel)."""
    srv._run_decode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        srv._run_decode(1 + i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    prof = profiled(lambda: [srv._run_decode(1 + reps + i)
                             for i in range(reps)])
    rows = device_time_by_kernel(prof, reps)
    dev_ms = sum(r[0] for r in rows)
    return dict(batch=srv.n_slots, wall_ms=wall_ms, device_ms=dev_ms,
                busy_share=dev_ms / wall_ms,
                device_events=sum(r[1] for r in rows)), rows


def captured_vs_eager(cfg, params, device, prompt: list[int],
                      max_new: int) -> LMServer:
    """``LMServer``'s decode step on ``LM_SERVER_SLOTS`` slots, captured
    and eager: the logits at every position of one generated sequence
    (``prompt``, then ``max_new`` tokens) equal bit for bit, or it
    raises.  Returns the captured server."""
    logits_at = {}
    for capture in (True, False):
        srv = LMServer(cfg, params, n_slots=LM_SERVER_SLOTS,
                       max_seq=LM_SERVER_MAX_SEQ, device=device,
                       capture=capture)
        run, log_ = srv._run_decode, []

        def record(pos, run=run, log_=log_):
            out = run(pos)
            log_.append(out.clone())
            return out
        srv._run_decode = record
        srv.generate(prompt, max_new=max_new)
        del srv._run_decode     # the method again (and no cycle)
        logits_at[capture] = torch.stack(log_)
        if capture:
            captured = srv
    same = torch.equal(logits_at[True], logits_at[False])
    log(f"[lm] {cfg.name} ({cfg.n_layers} layers) captured vs eager decode "
        f"step, {LM_SERVER_SLOTS} slots: logits at "
        f"{logits_at[False].shape[0]} positions "
        + ("equal bit for bit" if same else "DIFFER"))
    if not same or not torch.isfinite(logits_at[False]).all():
        diff = (logits_at[True].float()
                - logits_at[False].float()).abs().max().item()
        raise AssertionError(f"[lm] {cfg.name}: captured logits != eager "
                             f"(max |diff| {diff})")
    return captured


def phase_lm(device) -> tuple[dict, dict]:
    """minitron-8b at full width and depth: prefill through K7, the same
    prompt through the decode step, and LMServer answering requests.
    Returns (launches of each LM path, numbers)."""
    cfg = minitron_8b.FULL
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), device=device,
                           generator=gen)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [params["embed"], params["lm_head"],
                        *params["layers"].values()])
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}: {cfg.param_count()} params, "
        f"{weight_bytes} B on the card, drawn in "
        f"{time.perf_counter() - t0:.3f} s")

    prefill = transformer.make_prefill_step(cfg, LM_MAX_SEQ)
    prefill(params, tokens)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {"lm_prefill": read_launches()}
    peak = torch.cuda.max_memory_allocated()
    want = launch_counts(flash_attention=cfg.n_layers)
    if launches["lm_prefill"] != want:
        raise AssertionError(f"[lm] prefill launches "
                             f"{launches['lm_prefill']}, want {want}")
    if logits.shape != (LM_BATCH, cfg.vocab) \
            or not torch.isfinite(logits).all() \
            or not torch.isfinite(cache["k"]).all():
        raise AssertionError(f"[lm] bad prefill output {tuple(logits.shape)}")
    prof = profiled(lambda: prefill(params, tokens))
    rows = device_time_by_kernel(prof, 1)
    device_ms = sum(r[0] for r in rows)
    k7_ms = sum(r[0] for r in rows if "flash_fwd" in r[2])
    log(f"[lm] prefill B {LM_BATCH} x S {LM_SEQ} (max_seq {LM_MAX_SEQ}): "
        f"{prefill_s * 1e3:.3f} ms wall, "
        f"{LM_BATCH * LM_SEQ / prefill_s:.1f} tokens/s; K7 launches "
        f"{launches['lm_prefill']['flash_attention']}; device "
        f"{device_ms:.3f} ms (profiled), K7 {k7_ms:.3f} ms = "
        f"{k7_ms / device_ms:.4f} of it; peak device memory {peak} B")
    for ms, n, key in rows[:8]:
        log(f"[lm]   {ms:.4f} ms  x{n:g}  {key[:90]}")

    del logits, cache

    # The same prompt, token by token, through the decode step, at the
    # depth of the first LM_CHECK_LAYERS layers (the same weights): the
    # step LMServer captures, with LM_BATCH slots (captured logits equal
    # eager ones bit for bit: checked below).
    check_cfg = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS)
    check_params = dict(params, layers={
        n: t[:LM_CHECK_LAYERS] for n, t in params["layers"].items()})
    logits, cache = transformer.make_prefill_step(check_cfg, LM_MAX_SEQ)(
        check_params, tokens)
    torch.cuda.synchronize()
    reset_launches()
    filler = LMServer(check_cfg, check_params, n_slots=LM_BATCH,
                      max_seq=LM_MAX_SEQ, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(LM_SEQ):
            filler.tokens.copy_(tokens[:, i:i + 1])
            dlogits = filler._run_decode(i)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dcache = filler.cache
    launches["lm_decode"] = read_launches()
    if launches["lm_decode"] != launch_counts():
        raise AssertionError(f"[lm] decode launches {launches['lm_decode']}")
    errs = {"logits": rel_err(logits, dlogits)}
    for name in ("k", "v"):
        errs[name] = rel_err(cache[name][:, :, :, :LM_SEQ],
                             dcache[name][:, :, :, :LM_SEQ])
    same_argmax = (logits.argmax(-1) == dlogits.argmax(-1)).float().mean()
    log(f"[lm] decode fill of the same {LM_SEQ} tokens, first "
        f"{LM_CHECK_LAYERS} layers, captured step: "
        f"{decode_s / LM_SEQ * 1e3:.3f} ms a step "
        f"at B {LM_BATCH}, K7 launches 0; prefill vs decode relative max "
        f"error: last logits {errs['logits']:.4e} (bound {LM_LOGIT_BOUND}), "
        f"cache K {errs['k']:.4e}, V {errs['v']:.4e} (bound "
        f"{LM_CACHE_BOUND}); same argmax in {same_argmax.item():.2f} of the "
        f"rows")
    if errs["logits"] > LM_LOGIT_BOUND or max(errs["k"], errs["v"]) \
            > LM_CACHE_BOUND:
        raise AssertionError(f"[lm] prefill and decode disagree: {errs}")
    if not torch.isfinite(dlogits).all():
        raise AssertionError("[lm] decode logits not finite")
    del logits, cache, dlogits, dcache, check_params, filler

    # Full-depth decode steps at the server's shape, eager then captured,
    # each a server's step over its own cache: host wall per step (no
    # profiler), device time and busy share under the profiler, and the
    # peak device memory above what was allocated before the server.
    step_tokens = tokens[:, :1].repeat(LM_SERVER_SLOTS // LM_BATCH, 1)
    reps = 5
    steps, servers = {}, {}
    for label, capture in (("eager", False), ("captured", True)):
        # The server's buffers are inference tensors, written as its own
        # methods write them.
        with torch.inference_mode():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            srv = LMServer(cfg, params, n_slots=LM_SERVER_SLOTS,
                           max_seq=LM_SERVER_MAX_SEQ, device=device,
                           capture=capture)
            torch.cuda.synchronize()
            boot_s = time.perf_counter() - t0
            srv.tokens.copy_(step_tokens)
            st, drows = decode_step_numbers(srv, reps)
            step_ms, dev_ms = st["wall_ms"], st["device_ms"]
            step_peak = torch.cuda.max_memory_allocated() - base
            steps[label] = dict(st, peak_bytes_above=step_peak,
                                boot_s=boot_s)
            log(f"[lm] full-depth decode step at B {LM_SERVER_SLOTS}, "
                f"max_seq {LM_SERVER_MAX_SEQ}, {label}: host wall "
                f"{step_ms:.3f} ms (no profiler), device {dev_ms:.3f} ms in "
                f"{steps[label]['device_events']:g} device events, busy "
                f"share {dev_ms / step_ms:.3f}; server boot {boot_s:.3f} s, "
                f"peak device memory {step_peak} B above the weights (cache "
                f"and the step's temporaries"
                f"{', its graph pool' if capture else ''}); weights alone "
                f"take {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 "
                f"TB/s")
            for ms, n, key in drows[:6]:
                log(f"[lm]   {ms:.4f} ms  x{n:g}  {key[:90]}")
            # Back to a fresh server's state for the requests below.
            srv._restart()
            for t in srv.cache.values():
                t.zero_()
            servers[label] = srv

    # LMServer answers requests through its captured step (decode only: no
    # K7), then the eager server answers the same ones: equal tokens.
    rng = np.random.default_rng(1)
    prompts = [([int(t) for t in rng.integers(0, cfg.vocab, n)], m)
               for n, m in LM_REQUESTS]
    served = {}
    for label in ("captured", "eager"):
        server = servers[label]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        reqs = [server.submit(p, max_new=m) for p, m in prompts]
        too_long = server.submit([1] * (LM_SERVER_MAX_SEQ - 8), max_new=16)
        server.drain()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches[f"lm_server_{label}"] = read_launches()
        m = server.metrics()
        generated = sum(len(r.result or []) for r in reqs)
        if not all(r.outcome == "served" and len(r.result) == mn
                   for r, (_, mn) in zip(reqs, LM_REQUESTS)) \
                or m["served"] != len(LM_REQUESTS):
            raise AssertionError(f"[lm] LMServer: "
                                 f"{[r.outcome for r in reqs]}, {m}")
        if too_long.outcome != "rejected" or m["rejected"] != 1:
            raise AssertionError(f"[lm] over-long prompt {too_long.outcome}")
        if m["retries"] or m["errors"]:
            raise AssertionError(f"[lm] with no fault plan: {m}")
        if launches[f"lm_server_{label}"] != launch_counts():
            raise AssertionError(f"[lm] LMServer launches "
                                 f"{launches[f'lm_server_{label}']}")
        if not all(0 <= t < cfg.vocab for r in reqs for t in r.result):
            raise AssertionError("[lm] LMServer produced an out-of-vocab "
                                 "token")
        served[label] = dict(
            tokens=[r.result for r in reqs], served_per_s=m["throughput"],
            p50_ms=m["p50_ms"], p95_ms=m["p95_ms"],
            generated_tokens_per_s=generated / serve_s,
            ms_per_step=serve_s / server.pos * 1e3)
        log(f"[lm] LMServer {label}, {LM_SERVER_SLOTS} slots, max_seq "
            f"{LM_SERVER_MAX_SEQ}: {len(reqs)} requests served, 1 rejected "
            f"({too_long.error}); served/s {m['throughput']:.3f}, p50 "
            f"{m['p50_ms']:.3f} ms, p95 {m['p95_ms']:.3f} ms; {generated} "
            f"tokens in {serve_s:.3f} s ({generated / serve_s:.2f} generated "
            f"tokens/s), {server.pos} decode steps "
            f"({serve_s / server.pos * 1e3:.3f} ms a step); K7 launches 0")
    if served["captured"]["tokens"] != served["eager"]["tokens"]:
        raise AssertionError("[lm] the captured server's tokens differ from "
                             "the eager server's")
    launches["lm_server"] = launches.pop("lm_server_captured")
    del launches["lm_server_eager"]
    log(f"[lm] captured and eager LMServer: the same "
        f"{sum(len(t) for t in served['eager']['tokens'])} tokens")
    recovery = lm_faults(servers["captured"], prompts,
                         served["captured"]["tokens"],
                         steps["captured"]["wall_ms"])
    del servers, server
    launches["placement_lm_lanes"], lanes = lm_lanes(cfg, params, device)

    # Captured logits against eager logits, bit for bit, at every position
    # of one generated sequence, on the first LM_CHECK_LAYERS layers.
    check_params = dict(params, layers={
        n: t[:LM_CHECK_LAYERS] for n, t in params["layers"].items()})
    captured_vs_eager(check_cfg, check_params, device, prompts[0][0], 16)
    numbers = dict(
        prefill=dict(tokens_per_s=LM_BATCH * LM_SEQ / prefill_s,
                     wall_ms=prefill_s * 1e3, device_ms=device_ms,
                     k7_ms=k7_ms, k7_share=k7_ms / device_ms,
                     peak_bytes=peak),
        decode_fill=dict(layers=LM_CHECK_LAYERS,
                         ms_per_step=decode_s / LM_SEQ * 1e3,
                         rel_err=errs),
        decode_step=steps["eager"], decode_step_captured=steps["captured"],
        server={k: v for k, v in served["captured"].items()
                if k != "tokens"},
        server_eager={k: v for k, v in served["eager"].items()
                      if k != "tokens"},
        recovery=recovery, lanes=lanes)
    del params, check_params
    torch.cuda.empty_cache()
    return launches, numbers


def recount_dispatch(flat: np.ndarray, n_experts: int, cap: int):
    """The capacity drops, counted on the host one assignment at a time in
    token-major order: (dest, keep) as ``moe._dispatch_indices`` gives
    them."""
    seen = np.zeros(n_experts, np.int64)
    dest = np.empty(len(flat), np.int64)
    keep = np.empty(len(flat), bool)
    for i, e in enumerate(flat):
        keep[i] = seen[e] < cap
        dest[i] = e * cap + seen[e] if keep[i] else n_experts * cap
        seen[e] += 1
    return dest, keep


@torch.inference_mode()
def moe_layer_check(cfg, params, tokens) -> dict:
    """Layer 0's MoE on the prefill's B·S normed tokens: at a capacity
    factor that drops nothing (the capacity covers the fullest bucket)
    against the dense oracle ``moe_reference`` within ``LM_LOGIT_BOUND``;
    at the published factor, ``_dispatch_indices``' destinations and keep
    mask against a host recount of the same ids, exactly."""
    lp = {n: t[0] for n, t in params["layers"].items()}
    x = transformer._embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x, _, _ = transformer._attention(x, lp, cfg, positions)
    h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
    t, k = h.shape[0], cfg.top_k
    experts = (lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"])
    e_pad = experts[1].shape[0]
    kw = dict(n_experts=cfg.n_experts, top_k=k, act=cfg.mlp_act)
    _, ids, _ = moe._route(h, lp["router"], n_real=cfg.n_experts, top_k=k)
    flat = ids.reshape(-1).cpu().numpy()
    load = int(np.bincount(flat, minlength=e_pad).max())
    factor = load * e_pad / (t * k)
    cap = moe.capacity(t, k, e_pad, factor)
    _, keep = moe._dispatch_indices(ids, n_experts=e_pad, cap=cap)
    out, aux = moe.moe_apply(h, *experts, capacity_factor=factor, **kw)
    want = torch.cat([moe.moe_reference(h[i:i + MOE_ORACLE_CHUNK], *experts,
                                        **kw)
                      for i in range(0, t, MOE_ORACLE_CHUNK)])
    err = rel_err(out, want)
    pub = moe.capacity(t, k, e_pad, cfg.capacity_factor)
    dest, pkeep = moe._dispatch_indices(ids, n_experts=e_pad, cap=pub)
    want_dest, want_keep = recount_dispatch(flat, e_pad, pub)
    exact = bool(np.array_equal(dest.cpu().numpy(), want_dest)
                 and np.array_equal(pkeep.cpu().numpy(), want_keep))
    kept = int(pkeep.sum())
    log(f"[moe] {cfg.name} layer 0 on {t} prefill tokens, top-{k} of "
        f"{cfg.n_experts} experts ({e_pad} slots): fullest bucket {load}; "
        f"at factor {factor:.4f} (capacity {cap}, nothing dropped: "
        f"{bool(keep.all())}) moe_apply vs moe_reference relative max "
        f"error {err:.4e} (bound {LM_LOGIT_BOUND}), aux {float(aux):.4f}; "
        f"at the published {cfg.capacity_factor} (capacity {pub}): "
        f"{kept} of {t * k} assignments kept, {t * k - kept} dropped, dest "
        f"and keep == the host recount: {exact}")
    if not keep.all() or err > LM_LOGIT_BOUND or not exact \
            or not torch.isfinite(out).all():
        raise AssertionError(f"[moe] {cfg.name} MoE layer check failed")
    return dict(tokens=t, fullest_bucket=load, no_drop_factor=factor,
                rel_err=err, aux=float(aux), capacity=pub, kept=kept,
                dropped=t * k - kept, recount_exact=exact)


def serve_requests(server: LMServer, cfg) -> dict:
    """``LMServer`` (captured) answering ``LM_REQUESTS``: every request
    served with its tokens, no K7 launch."""
    rng = np.random.default_rng(3)
    prompts = [([int(t) for t in rng.integers(0, cfg.vocab, n)], m)
               for n, m in LM_REQUESTS]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    reqs = [server.submit(p, max_new=m) for p, m in prompts]
    server.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_launches()
    m = server.metrics()
    generated = sum(len(r.result or []) for r in reqs)
    if not all(r.outcome == "served" and len(r.result) == mn
               for r, (_, mn) in zip(reqs, LM_REQUESTS)) \
            or m["served"] != len(LM_REQUESTS) or m["retries"] \
            or m["errors"] or launches != launch_counts() \
            or not all(0 <= t < cfg.vocab for r in reqs for t in r.result):
        raise AssertionError(f"[moe] {cfg.name} LMServer: "
                             f"{[r.outcome for r in reqs]}, {m}, launches "
                             f"{launches}")
    log(f"[moe] {cfg.name} LMServer captured, {LM_SERVER_SLOTS} slots, "
        f"max_seq {LM_SERVER_MAX_SEQ}: {len(reqs)} requests served; "
        f"served/s {m['throughput']:.3f}, p50 {m['p50_ms']:.3f} ms, p95 "
        f"{m['p95_ms']:.3f} ms; {generated} tokens in {serve_s:.3f} s "
        f"({generated / serve_s:.2f} generated tokens/s), {server.pos} "
        f"decode steps ({serve_s / server.pos * 1e3:.3f} ms a step); K7 "
        f"launches 0")
    return dict(served=m["served"], served_per_s=m["throughput"],
                p50_ms=m["p50_ms"], p95_ms=m["p95_ms"],
                generated_tokens_per_s=generated / serve_s,
                ms_per_step=serve_s / server.pos * 1e3)


def phase_moe(device) -> tuple[dict, dict]:
    """qwen3-moe-30b-a3b, granite-moe-3b-a800m and command-r-35b at full
    width and depth, one at a time (each alone fills most of the card):
    weights drawn on the card, prefill through K7, the MoE layer against
    its oracle and its drops recounted, the captured decode step against
    the eager one, and qwen3 serving requests.  Returns (the prefills'
    launches, numbers)."""
    launches, numbers = {}, {}
    for arch in MOE_PHASE_ARCHS:
        cfg = configs.get(arch).full
        t_arch = time.perf_counter()
        # The previous model's weights (minitron's first) go before this
        # one's are drawn: a server kept in a reference cycle holds them
        # until the collector runs.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        log(f"[moe] {cfg.name}: device memory allocated before "
            f"{torch.cuda.memory_allocated()} B")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(0)
        params = transformer.init_params(cfg, gen, device)
        tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ),
                               device=device, generator=gen)
        torch.cuda.synchronize()
        weight_bytes = sum(t.numel() * t.element_size() for t in
                           [params["embed"], *params["layers"].values()]
                           + ([params["lm_head"]] if "lm_head" in params
                              else []))
        log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
            f"{cfg.d_head}, "
            + (f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff "
               f"{cfg.d_ff_expert}" if cfg.moe else f"d_ff {cfg.d_ff}")
            + f", vocab {cfg.vocab}: {cfg.param_count()} params "
            f"({cfg.active_param_count()} active), {weight_bytes} B on the "
            f"card, drawn in {time.perf_counter() - t0:.3f} s")

        prefill = transformer.make_prefill_step(cfg, LM_MAX_SEQ)
        prefill(params, tokens)                   # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill(params, tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches[f"moe_phase_prefill_{arch}"] = read_launches()
        prefill_peak = torch.cuda.max_memory_allocated() - base
        want = launch_counts(flash_attention=cfg.n_layers)
        if launches[f"moe_phase_prefill_{arch}"] != want:
            raise AssertionError(f"[moe] {cfg.name} prefill launches "
                                 f"{launches[f'moe_phase_prefill_{arch}']}, "
                                 f"want {want}")
        if logits.shape != (LM_BATCH, cfg.vocab) \
                or not torch.isfinite(logits).all() \
                or not torch.isfinite(cache["k"]).all() \
                or not torch.isfinite(cache["v"]).all():
            raise AssertionError(f"[moe] {cfg.name}: bad prefill output")
        del logits, cache
        prof = profiled(lambda: prefill(params, tokens))
        rows = device_time_by_kernel(prof, 1)
        device_ms = sum(r[0] for r in rows)
        k7_ms = sum(r[0] for r in rows if "flash_fwd" in r[2])
        log(f"[moe] {cfg.name} prefill B {LM_BATCH} x S {LM_SEQ} (max_seq "
            f"{LM_MAX_SEQ}): {prefill_s * 1e3:.3f} ms wall, "
            f"{LM_BATCH * LM_SEQ / prefill_s:.1f} tokens/s; K7 launches "
            f"{cfg.n_layers}; device {device_ms:.3f} ms (profiled), K7 "
            f"{k7_ms:.3f} ms = {k7_ms / device_ms:.4f} of it; peak device "
            f"memory {prefill_peak} B above the weights")
        for ms, n, key in rows[:8]:
            log(f"[moe]   {ms:.4f} ms  x{n:g}  {key[:90]}")
        out = dict(prefill=dict(tokens_per_s=LM_BATCH * LM_SEQ / prefill_s,
                                wall_ms=prefill_s * 1e3,
                                device_ms=device_ms, k7_ms=k7_ms,
                                k7_share=k7_ms / device_ms,
                                peak_bytes_above=prefill_peak),
                   weight_bytes=weight_bytes)
        if cfg.moe:
            out["moe_layer"] = moe_layer_check(cfg, params, tokens)
        prompt = [int(t) for t in tokens[0, :MOE_DECODE_PROMPT]]
        server = captured_vs_eager(cfg, params, device, prompt,
                                   MOE_DECODE_NEW)
        with torch.inference_mode():
            out["decode"], _ = decode_step_numbers(server)
            server._restart()
            for t in server.cache.values():
                t.zero_()
        st = out["decode"]
        log(f"[moe] {cfg.name} full-depth decode step at B "
            f"{LM_SERVER_SLOTS}, captured: host wall {st['wall_ms']:.3f} "
            f"ms, device {st['device_ms']:.3f} ms in "
            f"{st['device_events']:g} device events, busy share "
            f"{st['busy_share']:.3f}")
        if arch == MOE_SERVE_ARCH:
            out["server"] = serve_requests(server, cfg)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["phase_s"] = time.perf_counter() - t_arch
        log(f"[moe] {cfg.name}: peak device memory {out['peak_bytes']} B "
            f"(weights, prefill and both servers); {out['phase_s']:.3f} s")
        numbers[arch] = out
        del params, tokens, server, prefill, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def pm1_library(a, b):
    """One PyTorch call computing K6's +-1 dots from operands already
    unpacked (unpacking not timed): ``torch._int_mm`` on int8 where its
    shape rules allow (more than 16 rows, K and N multiples of 8), else a
    float32 matmul with TF32 off.  Returns (the call, its name); the call
    gives the dots over all 32·W bits."""
    bits = a.shape[1] * packing.WORD_BITS
    av = packing.unpack_to_pm1(a, bits, dtype=torch.int8)
    bv = packing.unpack_to_pm1(b, bits, dtype=torch.int8)
    if a.shape[0] > 16 and bits % 8 == 0 and b.shape[0] % 8 == 0:
        bt = bv.t().contiguous()
        return (lambda: torch._int_mm(av, bt)), "torch._int_mm (int8)"
    af, bft = av.float(), bv.float().t().contiguous()

    def f32():
        with binary_ops.full_float32():
            return af @ bft
    return f32, "torch.matmul (float32, TF32 off)"


def count_library(a, b, ww):
    """One PyTorch call computing K1's counts from operands already
    unpacked (unpacking not timed), and the map from its result to the
    counts (not timed either).  Without word weights it is
    :func:`pm1_library`'s dot over all 32·W bits, and cnt = (32·W - dot)/2;
    with them, a float32 matmul (TF32 off) of ``a``'s +-1 bits scaled by
    their word's weight against ``b``'s, and cnt = (32·sum(ww) - dot)/2,
    exact while 32·sum(ww) < 2^24.  Returns (the call, its name, the map)."""
    if ww is None:
        call, name = pm1_library(a, b)
        total = a.shape[1] * packing.WORD_BITS
    else:
        total = packing.WORD_BITS * int(ww.sum())
        if total >= 1 << 24:
            raise AssertionError(f"[timing] weighted dots of {total} "
                                 f"terms are not exact in float32")
        bits = a.shape[1] * packing.WORD_BITS
        av = (packing.unpack_to_pm1(a, bits, dtype=torch.float32)
              * ww.float().repeat_interleave(packing.WORD_BITS))
        bt = packing.unpack_to_pm1(b, bits, dtype=torch.float32).t() \
            .contiguous()

        def call():
            with binary_ops.full_float32():
                return av @ bt
        name = "torch.matmul (float32, TF32 off, word-weighted a)"

    def to_counts(dot):
        twice = total - dot.to(torch.int64)
        if (twice % 2).any():
            raise AssertionError(f"[timing] {name}: odd total - dot")
        return (twice // 2).to(torch.int32)
    return call, name, to_counts


def sdpa_backwards(q, k, v, do, grads, name: str, causal: bool = True):
    """SDPA's backward on K7b's inputs, causal or not, under each backend
    pinned
    with ``sdpa_kernel`` (flash, cuDNN, memory-efficient): the backward of
    one forward, repeated (``retain_graph``), with GQA where the backend
    takes it and K/V expanded to H heads where not (the expansion's
    backward counted).  Each is held against K7b's gradients within twice
    ``K7B_TOL`` · (1 + |K7b|): both are bf16 backwards within ``K7B_TOL``
    of the float32 one, rounded at other places.  Returns (backend,
    single-call ms, device ms) of each backend that took the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    out = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for expand in (False, True):
            leaves = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v)]
            qt, kt, vt = leaves
            if expand:
                kt, vt = (t.repeat_interleave(g, 1) for t in (kt, vt))
            try:
                with sdpa_kernel(backend):
                    o = F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal,
                        enable_gqa=not expand)
                    dot = do.transpose(1, 2)

                    def bwd(o=o, leaves=leaves, dot=dot):
                        return torch.autograd.grad(o, leaves, dot,
                                                   retain_graph=True)
                    for part, got, want in zip(
                            ("dq", "dk", "dv"),
                            (t.transpose(1, 2) for t in bwd()), grads):
                        diff = (got.float() - want.float()).abs()
                        if (diff > 2 * K7B_TOL
                                * (1 + want.float().abs())).any():
                            raise AssertionError(
                                f"[timing] {name}: SDPA backward "
                                f"({backend.name}) {part} off K7b's by "
                                f"{diff.max().item():.3e}")
                    ms = time_ms(bwd, 20)
                    dev = device_ms(bwd)
            except RuntimeError as e:      # the backend refuses the shape
                if "No available kernel" not in str(e):
                    raise
                continue
            label = f"{backend.name}{' (K/V expanded)' if expand else ''}"
            log(f"[timing] flash_attention_bwd {name}: SDPA backward, "
                f"{label} pinned: single {ms:.4f} ms, device {dev:.4f} ms")
            out.append((label, ms, dev))
            del o, bwd
            break
    if not out:
        raise AssertionError(f"[timing] {name}: no SDPA backend took K7b's "
                             f"shape")
    return out


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` after a
    warm-up: the call's host work (the wrapper's checks, its allocation,
    the ctypes call) included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


DEVICE_REPS = 20


def device_ms(fn, reps: int = DEVICE_REPS) -> float:
    """The device time of one call of ``fn``: the torch.profiler duration
    of every CUDA kernel it launches, over ``reps`` calls after a warm-up
    (:func:`device_time_by_kernel`)."""
    fn()
    torch.cuda.synchronize()
    prof = profiled(lambda: [fn() for _ in range(reps)])
    rows = device_time_by_kernel(prof, reps)
    if not rows:
        raise RuntimeError("torch.profiler recorded no kernel")
    return sum(r[0] for r in rows)


def kernel_ms(fn, reps: int) -> tuple[float, float]:
    """(single-call event median, device time a call) of a kernel call."""
    return time_ms(fn, reps), device_ms(fn)


def phase_timing(device, launches: dict, per_forward: dict,
                 errs: dict) -> list[dict]:
    """Kernel medians at AlexNet's batch-8 shapes.  ``launches`` and
    ``per_forward`` map each serving path to its counts."""
    inp = Inputs(device, seed=2)
    rows = {}

    def add(name, shape, times, plain_ms, nbytes, ops, library=None,
            ops_per_s=INT8_OPS_PER_S, real_ops=None):
        """``times``: :func:`kernel_ms` of the kernel.  ``real_ops``: a
        bit-plane variant's operations over the real channels alone (exact
        only when the input's pad bits are 0, as K4 leaves them); its
        bound is kept beside the contract's."""
        ms, dev_ms = times
        b, by = bound_ms(nbytes, ops, ops_per_s)
        r = rows.setdefault(name, dict(ms=0.0, device_ms=0.0, plain_ms=0.0,
                                       bound_ms=0.0, t_bytes=0.0, t_ops=0.0,
                                       library_ms=None, shapes=[]))
        r["ms"] += ms
        r["device_ms"] += dev_ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += b
        r["t_bytes"] += nbytes / HBM_BYTES_PER_S * 1e3
        r["t_ops"] += ops / ops_per_s * 1e3
        shape_row = dict(shape=shape, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by)
        extra = ""
        if real_ops is not None:
            rb, rby = bound_ms(nbytes, real_ops, ops_per_s)
            r["bound_real_ms"] = r.get("bound_real_ms", 0.0) + rb
            shape_row.update(bound_real_ms=rb, bound_real_by=rby)
            extra = f", real-channel bound {rb:.5f} ms ({rby})"
        if library is not None:
            lib_ms, lib_name = library
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
            shape_row.update(library_ms=lib_ms, library=lib_name)
            extra += f", library {lib_ms:.4f} ms ({lib_name})"
        r["shapes"].append(shape_row)
        log(f"[timing] {name} {shape}: kernel {ms:.4f} ms, device "
            f"{dev_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.5f} ms "
            f"({by}){extra}")

    x = torch.randint(0, 256, (BATCH, 227, 227, 3), dtype=torch.uint8,
                      device=device, generator=inp.g)
    out = k4.bitplane_pack(x)
    add("bitplane_pack", str(tuple(x.shape)),
        kernel_ms(lambda: k4.bitplane_pack(x), 50),
        time_ms(lambda: k4.bitplane_pack_plain(x), 10),
        x.numel() + out.numel() * 4, 0.0)
    # K4 at bucket 1 (the serving buckets below 8): timed, not summed.
    x1 = x[:1].contiguous()
    ms, dev = kernel_ms(lambda: k4.bitplane_pack(x1), 50)
    b, by = bound_ms(x1.numel() + out[:1].numel() * 4, 0.0)
    log(f"[timing] bitplane_pack {tuple(x1.shape)} (bucket 1): kernel "
        f"{ms:.4f} ms, device {dev:.4f} ms, bound {b:.5f} ms ({by})")
    # conv1 on the main path: K3's bit-plane variant (u8 x s8 over every
    # bit position of each input word); conv2-conv5: K3 without word
    # weights.  conv1 with random plane weights takes the generic weighted
    # kernel, off the main path: timed beside the variant, not summed.
    # Its bound counts a u8 multiply-add for every bit position of each
    # word (the contract: any pad bits); the real-channel bound counts
    # KH·KW·C of them.
    args, kw, _, _, k_bytes = plane_conv_case(inp, PLANE_CONVS[0])
    out = k3.direct_conv_bn_binarize_planes(*args, **kw)
    x, filters, thr, sgn = args
    n, h, w, _ = x.shape
    oh, ow = (conv_out_size(d, kw["kh"], kw["stride"], kw["pad"])
              for d in (h, w))
    positions = 2.0 * n * oh * ow * filters.signs.shape[0]
    add("direct_conv_bn_binarize_planes", "conv1",
        kernel_ms(lambda: k3.direct_conv_bn_binarize_planes(*args, **kw),
                  20),
        time_ms(lambda: k3.direct_conv_bn_binarize_planes_plain(*args, **kw),
                3),
        (x.numel() + filters.signs.numel() + filters.const.numel()
         + thr.numel() + out.numel()) * 4 + sgn.numel(),
        positions * k_bytes,
        real_ops=positions * kw["kh"] * kw["kw"] * PLANE_CONVS[0][1][3])
    for case in ALEXNET_CONVS:
        args, kw, k_bits = conv_case(inp, case)
        out = k3.direct_conv_bn_binarize(*args, **kw)
        times = kernel_ms(lambda: k3.direct_conv_bn_binarize(*args, **kw),
                          20)
        if case[7]:
            log(f"[timing] direct_conv_bn_binarize {case[0]} with random "
                f"plane weights (the generic weighted kernel, off the main "
                f"path): kernel {times[0]:.4f} ms, device {times[1]:.4f} ms")
            continue
        nbytes, ops = conv_cost(args, kw, out, k_bits)
        add("direct_conv_bn_binarize", case[0], times,
            time_ms(lambda: k3.direct_conv_bn_binarize_plain(*args, **kw),
                    3),
            nbytes, ops)
    for case in ALEXNET_DENSE:
        args = dense_case(inp, case)
        out = k2.fused_matmul_bn_binarize(*args)
        nbytes, ops = dense_cost(args, out)
        add("fused_matmul_bn_binarize", case[0],
            kernel_ms(lambda: k2.fused_matmul_bn_binarize(*args), 50),
            time_ms(lambda: k2.fused_matmul_bn_binarize_plain(*args), 5),
            nbytes, ops)
    # K2 at conv2's im2col rows, as cuda_popcount runs it (off the main
    # path: timed, not summed).
    args = dense_case(inp, DENSE_EDGES[2])
    out = k2.fused_matmul_bn_binarize(*args)
    ms, dev = kernel_ms(lambda: k2.fused_matmul_bn_binarize(*args), 20)
    b, by = bound_ms(*dense_cost(args, out))
    log(f"[timing] fused_matmul_bn_binarize conv2 im2col "
        f"a{tuple(args[0].shape)} (cuda_popcount, off the main path): "
        f"kernel {ms:.4f} ms, device {dev:.4f} ms, bound {b:.5f} ms ({by})")
    # K1 at every count node of the trained path's unfused graph: conv1
    # (cuda_pm1's one K1 launch) through K1's bit-plane variant, conv2-fc7
    # without word weights; conv1 with random plane weights (the generic
    # weighted kernel, off the main path) timed beside it.  K6 at
    # cuda_pm1's six.
    a, filters, wp, ww, bits, cw = plane_matmul_case(inp, PLANE_MATMULS[0],
                                                     False)
    out = k1.xnor_popcount_matmul_planes(a, filters, cw)
    lib, lib_name, to_counts = count_library(a, wp, ww)
    if not torch.equal(to_counts(lib()), out):
        raise AssertionError(f"[timing] {lib_name} != "
                             f"xnor_popcount_matmul_planes at conv1")
    add("xnor_popcount_matmul_planes", "conv1",
        kernel_ms(lambda: k1.xnor_popcount_matmul_planes(a, filters, cw),
                  20),
        time_ms(lambda: k1.xnor_popcount_matmul_planes_plain(a, filters,
                                                             cw), 3),
        (a.numel() + filters.signs.numel() + filters.const.numel()
         + out.numel()) * 4,
        2.0 * a.shape[0] * out.shape[1] * filters.signs.shape[1] * 32,
        library=(time_ms(lib, 20), lib_name),
        real_ops=2.0 * a.shape[0] * out.shape[1] * float(bits.sum()) / 8)
    for case in ALEXNET_MATMULS:
        a, b, ww, bits = matmul_case(inp, case)
        out = k1.xnor_popcount_matmul(a, b, ww)
        times = kernel_ms(lambda: k1.xnor_popcount_matmul(a, b, ww), 20)
        if ww is not None:
            log(f"[timing] xnor_popcount_matmul {case[0]} with random "
                f"plane weights (the generic weighted kernel, off the main "
                f"path): kernel {times[0]:.4f} ms, device {times[1]:.4f} ms")
            continue
        lib, lib_name, to_counts = count_library(a, b, ww)
        if not torch.equal(to_counts(lib()), out):
            raise AssertionError(f"[timing] {lib_name} != "
                                 f"xnor_popcount_matmul at {case[0]}")
        add("xnor_popcount_matmul", case[0], times,
            time_ms(lambda: k1.xnor_popcount_matmul_plain(a, b, ww), 3),
            *matmul_cost(a, b, out, bits, ww),
            library=(time_ms(lib, 20), lib_name))
    for case in ALEXNET_MATMULS[1:]:
        a, b, _, bits = matmul_case(inp, case)
        k_valid = int(bits.sum())
        out = k6.mxu_pm1_matmul(a, b, k_valid)
        lib, lib_name = pm1_library(a, b)
        if not torch.equal(lib().to(torch.int32)
                           - (a.shape[1] * 32 - k_valid), out):
            raise AssertionError(f"[timing] {lib_name} != mxu_pm1_matmul "
                                 f"at {case[0]}")
        add("mxu_pm1_matmul", case[0],
            kernel_ms(lambda: k6.mxu_pm1_matmul(a, b, k_valid), 20),
            time_ms(lambda: k6.mxu_pm1_matmul_plain(a, b, k_valid), 5),
            *matmul_cost(a, b, out, bits),
            library=(time_ms(lib, 20), lib_name))
    x, ops, kw, convs = chain_case(inp, CHAIN_CASES[0])
    out = k5.chain_conv(x, ALEXNET_CHAIN, ops, **kw)
    add("chain_conv", CHAIN_CASES[0][0],
        kernel_ms(lambda: k5.chain_conv(x, ALEXNET_CHAIN, ops, **kw), 10),
        time_ms(lambda: k5.chain_conv_plain(x, ALEXNET_CHAIN, ops, **kw), 3),
        *chain_cost(x, ops, out, convs))
    # Every cluster size the card can schedule, beside the wrapper's C:
    # batch 8 is 8 clusters, which may exceed what the card holds at once.
    words = kw["arena_words"]
    for c in k5.CLUSTER_SIZES:
        active = k5.max_clusters(words, c)
        if active < 1:
            log(f"[timing] chain_conv alexnet region, cluster {c}: cannot "
                f"be scheduled")
            continue
        if not torch.equal(k5.chain_conv(x, ALEXNET_CHAIN, ops, cluster=c,
                                         **kw), out):
            raise AssertionError(f"[timing] chain_conv cluster {c} != "
                                 f"the wrapper's cluster")
        ms = time_ms(lambda: k5.chain_conv(x, ALEXNET_CHAIN, ops, cluster=c,
                                           **kw), 10)
        log(f"[timing] chain_conv alexnet region, cluster {c} ({active} "
            f"clusters at once, the grid has {BATCH}): kernel {ms:.4f} ms"
            + (" (the wrapper's)" if c == k5.cluster_size(words, BATCH)
               else ""))
    # The region's other tiles: timed by tune_chains under cuda_chain, and
    # each held against the plain version there (check_chain_tiles).

    # K7 at minitron's prefill layer (head width 128) and granite's (64),
    # causal, and at the zoo's ViT-H/14 serve_b128 layer (hd 80) and
    # DiT-XL/2 gen_fast layer (hd 72), non-causal, each beside one SDPA
    # call on the same tensors (in its (B, H, S, hd) layout, as views).
    # The bound counts the products at the true width over the causal
    # triangle or the whole Sq x Skv.
    for case in FLASH_TIMED + ZOO_TIMED:
        q, k, v = flash_inputs(inp, case)
        _, b, sq, skv, h, kvh, hd, causal = case
        out = k7.flash_attention(q, k, v, causal)
        blocks = plain_blocks(case)
        flash_error(f"flash_attention {case[0]}", out,
                    k7.flash_attention_plain(q, k, v, causal, *blocks))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        flash_error("F.scaled_dot_product_attention",
                    sdpa().transpose(1, 2), out)
        pairs_n = sq * (sq + 1) / 2 if causal else sq * skv
        add("flash_attention", case[0],
            kernel_ms(lambda: k7.flash_attention(q, k, v, causal), 20),
            time_ms(lambda: k7.flash_attention_plain(q, k, v, causal,
                                                     *blocks), 3),
            (q.numel() + k.numel() + v.numel() + out.numel()) * 2,
            4.0 * b * h * hd * pairs_n,
            library=(time_ms(sdpa, 20), "F.scaled_dot_product_attention ("
                     + ("is_causal, " if causal else "") + "enable_gqa)"),
            ops_per_s=BF16_FLOPS_PER_S)
        del q, k, v, out, qt, kt, vt
        torch.cuda.empty_cache()

    # K7b at lm-100m's layer (the train step's shape) and minitron-8b's
    # prefill layer, causal, and at the zoo's two layers above,
    # non-causal: each launch's device time, beside SDPA's backward with
    # each backend pinned.
    for case in K7B_CASES[:2] + list(ZOO_TIMED):
        q, k, v, do = k7b_inputs(inp, case)
        _, b, sq, skv, h, kvh, hd, causal = case
        out, lse = k7.flash_attention_fwd(q, k, v, causal)

        def k7b(q=q, k=k, v=v, out=out, lse=lse, do=do, causal=causal):
            return k7.flash_attention_bwd(q, k, v, out, lse, do, causal)
        grads = k7b()
        by_kernel = device_time_by_kernel(
            profiled(lambda: [k7b() for _ in range(DEVICE_REPS)]),
            DEVICE_REPS)
        for ms, n, key in by_kernel:
            log(f"[timing] flash_attention_bwd {case[0]}: {ms:.4f} ms "
                f"device x{n:g}  {key[:70]}")
        times = (time_ms(k7b, 20), sum(r[0] for r in by_kernel))
        libs = sdpa_backwards(q, k, v, do, grads, case[0], causal)
        best = min(libs, key=lambda x: x[2])
        nbytes = sum(t.numel() for t in (q, k, v, out, do, *grads)) * 2 \
            + lse.numel() * 4
        pairs_n = sq * (sq + 1) / 2 if causal else sq * skv
        add("flash_attention_bwd", case[0], times,
            time_ms(lambda: k7.flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal, *plain_blocks(case)), 3),
            nbytes, 10.0 * b * h * hd * pairs_n,
            library=(best[2], f"F.scaled_dot_product_attention backward, "
                     f"{best[0]} pinned, device time (the fastest backend; "
                     f"a call's single time carries autograd's host "
                     f"work)"),
            ops_per_s=BF16_FLOPS_PER_S)
        rows["flash_attention_bwd"]["shapes"][-1].update(
            launches_device_ms={key: ms for ms, _, key in by_kernel},
            library_backends=[dict(backend=n, ms=ms, device_ms=dev)
                              for n, ms, dev in libs])
        del q, k, v, do, out, lse, grads
        torch.cuda.empty_cache()

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(v[name] for v in launches.values()),
            launches_per_forward={m: v[name]
                                  for m, v in per_forward.items()},
            max_abs_err=errs[name], ms=r["ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by="bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
            library_ms=r["library_ms"], per_shape=r["shapes"],
            **({"bound_real_ms": r["bound_real_ms"]}
               if "bound_real_ms" in r else {})))
    return kernels


class PhaseClock:
    """Each phase's wall seconds, printed as it ends (``[time]`` lines)
    and kept for the numbers line."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.s: dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.last
        log(f"[time] {name} {now - self.last:.1f} s (run {now - self.t0:.1f}"
            f" s)")
        self.last = now


def main() -> int:
    if sys.argv[1:2] == ["--dryrun-jobs"]:      # a [dryrun] worker
        return dryrun_worker(*sys.argv[2:4])
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    # The autotuner's winners persist to a file of this run alone.
    cache_dir = tempfile.TemporaryDirectory(prefix="chip-smoke-autotune-")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cache_dir.name,
                                                      "autotune.json")
    clock = PhaseClock()
    smi = phase_build()
    clock.mark("build")
    errs = phase_kernels(device)
    clock.mark("kernels")
    rng = np.random.default_rng(0)
    launches, per_forward, numbers = {}, {}, {}
    chain_inputs = Inputs(device, seed=6)
    for mode in WANT_LAUNCHES:
        wl, launches[mode], per_forward[mode], numbers[mode] = \
            phase_serve(rng, mode)
        numbers[mode]["profile"] = phase_profile(wl)
        if mode == "cuda_chain":
            chain_wl = wl
            numbers["chain_tiles_checked"] = check_chain_tiles(
                wl.engine.engine, chain_inputs)
        if mode == "cuda_direct_pool":
            numbers["trace_names"] = phase_traced_serve(wl, rng)
    clock.mark("serve")
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in [(375, 500), (416, 416)]]
    rows = {}
    for mode in WANT_DETECT:
        rows[mode], wl = phase_detect(images, mode)
        if mode == "cuda_direct_pool":
            numbers["yolo_profile"] = phase_profile(wl)
        if mode == "cuda_chain":
            numbers["chain_tiles_checked"] += check_chain_tiles(
                wl.engine.engine, chain_inputs)
    first = next(iter(rows.values()))
    if not all(torch.equal(r, first) for r in rows.values()):
        raise AssertionError("[detect] the paths' rows differ on the same "
                             "images")
    log(f"[detect] the same images on {list(rows)}: rows equal bit for bit")
    clock.mark("detect")
    numbers["multiplex"] = phase_multiplex(rng)
    clock.mark("multiplex")
    numbers["faults"] = phase_faults(chain_wl)
    del chain_wl
    clock.mark("faults")
    placed, placed_forward, numbers["placement"] = phase_placement(rng, device)
    launches.update(placed)
    per_forward.update(placed_forward)
    clock.mark("placement")
    for name, counts in phase_trained(device).items():
        launches[f"trained_{name}"] = per_forward[f"trained_{name}"] = counts
    train_launches, numbers["train"] = phase_train(device, errs)
    launches.update(train_launches)
    per_forward.update(train_launches)
    clock.mark("trained, train")
    zoo_launches, zoo_per_step, numbers["zoo"] = phase_zoo(device, smi)
    launches.update(zoo_launches)
    per_forward.update(zoo_per_step)
    clock.mark("zoo")
    lm_launches, numbers["lm"] = phase_lm(device)
    launches.update(lm_launches)
    per_forward.update(lm_launches)
    clock.mark("lm")
    moe_launches, numbers["moe"] = phase_moe(device)
    launches.update(moe_launches)
    per_forward.update(moe_launches)
    clock.mark("moe")
    auto = phase_autotune(device)
    launches.update(auto["launches"])
    per_forward.update(auto["launches"])
    clock.mark("autotune")
    numbers["artifact"] = phase_artifact(rng)
    cache_dir.cleanup()
    clock.mark("artifact")
    kernels = phase_timing(device, launches, per_forward, errs)
    clock.mark("timing")
    # Last: a torch.profiler session late in a long run loses its device
    # records (the card-to-host clock mapping drifts), and [shard] uses no
    # profiler; its launches join the kernels line here.
    shard_launches, numbers["shard"] = phase_shard(device, smi)
    clock.mark("shard")
    train_launches, numbers["shard_train"] = phase_shard_train(device, smi)
    shard_launches.update(train_launches)
    clock.mark("shard train")
    zoo_launches, numbers["shard_zoo"] = phase_shard_zoo(device, smi)
    shard_launches.update(zoo_launches)
    clock.mark("shard zoo")
    numbers["dryrun"] = phase_dryrun(numbers, smi)
    clock.mark("dryrun")
    numbers["phase_s"] = clock.s
    for k in kernels:
        k["launches"] += sum(v[k["name"]] for v in shard_launches.values())
        k["launches_per_forward"].update(
            {m: v[k["name"]] for m, v in shard_launches.items()})
    log(f"[autotune] json {json.dumps(auto)}")
    log(f"[serve] numbers {json.dumps(numbers)}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
