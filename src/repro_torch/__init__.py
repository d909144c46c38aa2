"""PhoneBit on PyTorch and CUDA: the port of the ``repro`` package.

The JAX package ``repro`` is the reference; this package mirrors its module
names so each counterpart is easy to find, imports neither ``jax`` nor
``repro``, and runs its entry points on the CUDA card unless the caller
passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).
Ported so far:

core       packing, bit-planes, BN folding, xor-popcount counts, packed
           conv/pool, the flat packed oracle, the converter, the STE sign
           and the BNN's training forward
configs    the LM configs the port runs (minitron-8b, command-r-35b,
           qwen3-moe-30b-a3b, granite-moe-3b-a800m)
models     the paper nets' specs (AlexNet, VGG16, YOLOv2-Tiny); the LM
           stack (layers, transformer, MoE), serving and training
runtime    operator IR, the passes, the per-node executor, chain regions,
           the autotuner (per-node backends and tiles) and the placement
           pass (pipeline stages, data-parallel shards)
kernels    hand-written CUDA kernels (``csrc/``) with their plain PyTorch
           versions, and the backend dispatch
serving    PhoneBitEngine, the batch scheduler, InferenceServer; the KV
           cache manager and LMServer
workloads  preprocess, postprocess heads, the workload registry
obs        metrics registry, span tracing, flight recorder, provenance
distributed  serving placements (Pipelined, DataParallel), replica groups
           (ReplicaGroup, LMReplicaGroup) and the straggler monitor
optim      AdamW, SGD-momentum, global-norm clipping, the cosine schedule
data       step-indexed token, image and latent pipelines
checkpoint atomic npz checkpoints in the reference's keys, async writer
tree       parameter-tree paths, maps and value_and_grad
launch     the serving and training drivers
"""
