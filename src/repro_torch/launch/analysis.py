"""A traced cell's cost, memory and collective bytes, and its roofline
(counterpart of ``repro.launch.analysis``).

The reference compiles each (arch × shape × mesh) cell to a post-SPMD HLO
module and reads XLA's cost and memory analysis and the module's text.
The port has no compiled program: :meth:`repro_torch.launch.cells.
CellBuild.trace` runs one rank's step once under ``FakeTensorMode`` over a
fake process group and counts what it runs.  From those counts come the
three roofline terms, for one NVIDIA H100 SXM a rank:

    compute    = FLOPs a rank / 989 TFLOP/s (dense bf16)
    memory     = bytes a rank / 3.35 TB/s (HBM3)
    collective = wire bytes a rank / 450 GB/s (NVLink, within a node of 8)
                 + wire bytes a rank / 50 GB/s (between nodes)

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step, each
  op that runs counted (there is no loop body counted once), K7, K7b and
  the row-parallel product by their formulas (their ops'
  ``register_flop_formula``).
* Bytes: over the aten ops of the step, the inputs read plus the outputs
  written; views, metadata ops, allocations without a write and the
  collectives are left out, and a custom op counts its operands once.
  This is the eager port's traffic with no fusion: an upper bound of its
  HBM traffic, where XLA's count is of its fused program.
* Collectives: each call of ``distributed.sharding.Collective`` over more
  than one rank, recorded as the reference's HLO kinds (the counterpart
  of its ``parse_collectives`` / ``shape_bytes``, which read HLO text the
  port does not have), turned into wire bytes with the reference's ring
  factors (:func:`wire_bytes`).  A group whose ranks leave one run of 8
  consecutive ranks (one node of 8 H100s) goes at the between-node rate.
* Memory: the live fake storages across the step
  (``torch.distributed._tools.mem_tracker.MemTracker``): the peak, the
  arguments', the outputs', and temp = peak - arguments.

The port traces bf16 as it runs, so ``dtype_factor`` stays 1.0 (the
reference's float32 accounting mode exists because XLA:CPU has no bf16).
No figure here is a time measured on a card: every t_* is a bound.
"""

from __future__ import annotations

import dataclasses
import json
import types
from typing import Any

# ---- NVIDIA H100 SXM constants (a GPU; NVIDIA's data sheet) ----------------
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4, bytes/s a direction a GPU (900 GB/s
#                              both ways), within an HGX node
NODE_GPUS = 8                # GPUs a node joined by NVLink
NETWORK_BW = 50e9            # between nodes: one 400 Gb/s NIC a GPU
CHIP_WATTS = 700.0           # the SXM part's power limit, as
#                              ``nvidia-smi --query-gpu=power.limit`` gives it


def wire_bytes(rec: dict) -> float:
    """Per-device wire bytes of one collective (ring-algorithm factors)."""
    n = rec["group"]
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    k = rec["kind"]
    if k == "all-reduce":
        return 2.0 * rec["operand_bytes"] * frac
    if k == "all-gather":
        return rec["out_bytes"] * frac
    if k == "reduce-scatter":
        return rec["operand_bytes"] * frac
    if k == "all-to-all":
        return rec["operand_bytes"] * frac
    if k == "collective-permute":
        return float(rec["operand_bytes"])
    return 0.0


def between_nodes(rec: dict) -> bool:
    """Whether the group's ranks span more than one node of
    ``NODE_GPUS`` consecutive ranks."""
    return len({r // NODE_GPUS for r in rec["ranks"]}) > 1


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    kind: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float          # unfused: an upper bound (see above)
    collective_wire_bytes: float
    collective_operand_bytes: float
    collective_counts: dict
    peak_memory_bytes: int
    argument_bytes: int
    temp_bytes: int                  # peak - argument bytes
    output_bytes: int
    model_flops: float          # 6·N_active·tokens (train) / analytic fwd
    # 1.0: the port traces bf16 as it runs (see the module's docstring).
    dtype_factor: float = 1.0
    bytes_raw: float = 0.0
    wire_raw: float = 0.0
    note: str = ""
    # The wire bytes whose group spans nodes (the rest go over NVLink).
    wire_between_nodes: float = 0.0
    # "K7/K7b fakes" (a cuda trace) or "plain versions" (a cpu trace).
    attention: str = ""

    # ---- roofline -----------------------------------------------------
    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        inside = self.collective_wire_bytes - self.wire_between_nodes
        return inside / NVLINK_BW + self.wire_between_nodes / NETWORK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-at-peak time / bound time (the score)."""
        if self.t_bound <= 0:
            return 0.0
        t_model = self.model_flops / (self.n_devices * PEAK_FLOPS)
        return t_model / self.t_bound

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def collect(trace: dict) -> dict:
    """Per-device metrics of one trace (``CellBuild.trace``'s dict): FLOPs,
    bytes, wire and operand bytes of its collectives (and the wire bytes
    between nodes), and the count of each collective kind."""
    colls = trace["collectives"]
    counts: dict[str, float] = {}
    for c in colls:
        counts[c["kind"]] = counts.get(c["kind"], 0) + 1
    return dict(
        flops=float(trace["flops"]),
        bytes=float(trace["bytes"]),
        wire=float(sum(wire_bytes(c) for c in colls)),
        operand=float(sum(c["operand_bytes"] for c in colls)),
        inter=float(sum(wire_bytes(c) for c in colls if between_nodes(c))),
        counts=counts,
    )


def extrapolate(m1: dict, m2: dict, n_layers: int) -> dict:
    """metrics(L) = metrics(1) + (L-1)·(metrics(2) - metrics(1)).

    The reference's probes: exact where one layer's cost is the same at
    every depth (the L=2/L=1 delta is one layer's cost, the L=1 value
    carries the prologue/epilogue once).  The port traces full depth too,
    and prints both."""
    out = {}
    for k in ("flops", "bytes", "wire", "operand", "inter"):
        if k in m1 and k in m2:
            out[k] = m1[k] + (n_layers - 1) * (m2[k] - m1[k])
    counts = {}
    for kind in set(m1["counts"]) | set(m2["counts"]):
        c1 = m1["counts"].get(kind, 0)
        c2 = m2["counts"].get(kind, 0)
        counts[kind] = c1 + (n_layers - 1) * (c2 - c1)
    out["counts"] = counts
    return out


def analyze(arch: str, shape: str, kind: str, mesh, trace: dict,
            model_flops: float, metrics: dict | None = None,
            note: str = "") -> CellReport:
    """Build a CellReport.  ``metrics`` overrides :func:`collect` of
    ``trace`` (as the reference's probe-extrapolated numbers do); memory
    always comes from the full-depth ``trace``.  ``mesh``: anything with
    ``sizes`` (a :class:`~repro_torch.launch.mesh.Mesh`)."""
    if metrics is None:
        metrics = collect(trace)
    n_dev = 1
    for n in mesh.sizes:
        n_dev *= n
    return CellReport(
        arch=arch, shape=shape, kind=kind,
        mesh="x".join(str(s) for s in mesh.sizes),
        n_devices=n_dev,
        flops_per_device=metrics["flops"],
        bytes_per_device=metrics["bytes"],
        collective_wire_bytes=metrics["wire"],
        collective_operand_bytes=metrics["operand"],
        collective_counts=metrics["counts"],
        peak_memory_bytes=int(trace["peak_bytes"]),
        argument_bytes=int(trace["argument_bytes"]),
        temp_bytes=int(trace["peak_bytes"] - trace["argument_bytes"]),
        output_bytes=int(trace["output_bytes"]),
        model_flops=model_flops, dtype_factor=1.0,
        bytes_raw=metrics["bytes"], wire_raw=metrics["wire"], note=note,
        wire_between_nodes=metrics.get("inter", 0.0),
        attention=trace.get("attention", ""))


# --------------------------------------------------------------------------
# MODEL_FLOPS per cell (analytic "useful work")
# --------------------------------------------------------------------------

def model_flops_for(build) -> float:
    """Analytic useful FLOPs for one step (the roofline numerator), from
    the cell's global argument shapes (``build.global_args``).

    Counts matmul work only: per-token layer matmuls (2·params_matmul,
    embeddings/norms excluded), the *ideal* attention FLOPs (causal
    S²/2), and the logits head.  Backward = 2× forward.  Traced FLOPs
    above this ratio are framework waste (remat recompute, masked
    attention, dead expert slots, replicated work)."""
    from repro_torch.models.convnext import ConvNeXtConfig
    from repro_torch.models.dit import DiTConfig
    from repro_torch.models.efficientnet import EffNetConfig
    from repro_torch.models.transformer import LMConfig
    from repro_torch.models.vit import ViTConfig

    cfg, kind = build.cfg, build.kind
    args = build.global_args

    if isinstance(cfg, LMConfig):
        d, l = cfg.d_model, cfg.n_layers
        attn_p = d * cfg.qkv_dim + 2 * d * cfg.kv_dim + cfg.qkv_dim * d
        if cfg.moe:
            mlp_p = d * cfg.n_experts + 3 * cfg.top_k * d * cfg.d_ff_expert
        else:
            n_mats = 3 if cfg.mlp_act == "swiglu" else 2
            mlp_p = n_mats * d * cfg.d_ff
        per_tok_fwd = 2.0 * l * (attn_p + mlp_p)
        head_fwd = 2.0 * d * cfg.vocab

        def attn_fwd(b, s_q, s_kv, causal):
            pairs = s_q * s_kv * (0.5 if causal else 1.0)
            return 4.0 * b * cfg.n_heads * cfg.d_head * pairs

        if kind == "train":
            b, s = args[2]["tokens"].shape
            fwd = (b * s * (per_tok_fwd + head_fwd)
                   + l * attn_fwd(b, s, s, True))
            return 3.0 * fwd
        if kind == "prefill":
            b, s = args[1].shape
            return (b * s * per_tok_fwd + b * head_fwd
                    + l * attn_fwd(b, s, s, True))
        if kind == "decode":
            b = args[2].shape[0]
            s_cache = args[1]["k"].shape[3]
            return (b * (per_tok_fwd + head_fwd)
                    + l * attn_fwd(b, 1, s_cache, False))

    if isinstance(cfg, DiTConfig):
        d, l = cfg.d_model, cfg.n_layers
        per_tok_fwd = 2.0 * l * (4 * d * d + 2 * d * cfg.d_ff)
        if kind == "train":
            b = args[2]["latents"].shape[0]
            lat = args[2]["latents"].shape[1]
        else:
            b, lat = args[1].shape[0], args[1].shape[1]
        n_tok = (lat // cfg.patch) ** 2
        cond_fwd = 2.0 * b * l * d * 6 * d          # adaLN projections
        attn = 4.0 * b * l * cfg.n_heads * cfg.d_head * n_tok * n_tok
        fwd = b * n_tok * per_tok_fwd + cond_fwd + attn
        return 3.0 * fwd if kind == "train" else fwd

    if isinstance(cfg, ViTConfig):
        d, l = cfg.d_model, cfg.n_layers
        if kind == "train":
            b, res = (args[2]["images"].shape[0],
                      args[2]["images"].shape[1])
        else:
            b, res = args[1].shape[0], args[1].shape[1]
        n_tok = (res // cfg.patch) ** 2 + 1
        per_tok_fwd = 2.0 * l * (4 * d * d + 2 * d * cfg.d_ff)
        patch_fwd = 2.0 * b * (n_tok - 1) * cfg.patch ** 2 * 3 * d
        attn = 4.0 * b * l * cfg.n_heads * cfg.d_head * n_tok * n_tok
        fwd = b * n_tok * per_tok_fwd + patch_fwd + attn
        return 3.0 * fwd if kind == "train" else fwd

    if isinstance(cfg, ConvNeXtConfig):
        imgs = args[-1]["images"] if kind == "train" else args[-1]
        b, res = imgs.shape[0], imgs.shape[1]
        macs = _convnext_macs(cfg, res)
        return (6.0 if kind == "train" else 2.0) * b * macs

    if isinstance(cfg, EffNetConfig):
        imgs = args[-1]["images"] if kind == "train" else args[-1]
        b, res = imgs.shape[0], imgs.shape[1]
        macs = _effnet_macs(cfg, res)
        return (6.0 if kind == "train" else 2.0) * b * macs
    return 0.0


def model_flops_cell(arch_id: str, shape_name: str) -> float:
    """Mesh-free analytic FLOPs for a cell."""
    import torch
    from repro_torch import configs

    rec = configs.get(arch_id)
    shape = rec.shape(shape_name)
    cfg = rec.full
    kind = shape.kind

    def sds(shp):
        return torch.empty(shp, device="meta")

    if rec.family == "lm":
        b, s = shape.global_batch, shape.seq_len
        if kind == "train":
            args = (None, None, {"tokens": sds((b, s))})
        elif kind == "prefill":
            args = (None, sds((b, s)))
        else:
            cache = {"k": sds((cfg.n_layers, b, cfg.n_kv_heads, s,
                               cfg.d_head))}
            args = (None, cache, sds((b, 1)))
    elif rec.family == "diffusion":
        lat = shape.img_res // cfg.vae_downsample
        x = sds((shape.batch, lat, lat, cfg.latent_channels))
        if kind == "train":
            args = (None, None, {"latents": x})
        else:
            args = (None, x)
    else:
        # the cell's own arity: EfficientNet's steps take a BN state more
        # (the reference passes its tuples to ViT too, whose branch then
        # reads None)
        x = sds((shape.batch, shape.img_res, shape.img_res, 3))
        lead = (None,) * (2 if arch_id == "efficientnet-b7" else 1)
        args = (*lead, None, {"images": x}) if kind == "train" else (*lead, x)
    build = types.SimpleNamespace(cfg=cfg, kind=kind, global_args=args)
    return model_flops_for(build)


def _convnext_macs(cfg, res: int) -> float:
    """Per-image MACs of the ConvNeXt forward at input res."""
    macs = (res // 4) ** 2 * 4 * 4 * 3 * cfg.dims[0]      # stem
    hw = res // 4
    prev = cfg.dims[0]
    for depth, dim in zip(cfg.depths, cfg.dims):
        if dim != prev:
            hw //= 2
            macs += hw * hw * 2 * 2 * prev * dim           # downsample
        macs += depth * hw * hw * (7 * 7 * dim              # dw conv
                                   + 2 * dim * 4 * dim)     # pw convs
        prev = dim
    macs += cfg.dims[-1] * cfg.n_classes
    return float(macs)


def _effnet_macs(cfg, res: int) -> float:
    """Per-image MACs of the EfficientNet forward at input res."""
    hw = res // 2
    macs = hw * hw * 3 * 3 * 3 * cfg.stem_ch
    for e, k, s, c_in, c_out, r in cfg.stages():
        for i in range(r):
            cin_i = c_in if i == 0 else c_out
            mid_i = cin_i * e
            if s == 2 and i == 0:
                hw //= 2
            if e != 1:
                macs += hw * hw * cin_i * mid_i            # expand 1x1
            macs += hw * hw * k * k * mid_i                # depthwise
            se = max(1, int(cin_i * cfg.se_ratio))
            macs += 2 * mid_i * se                         # SE
            macs += hw * hw * mid_i * c_out                # project 1x1
    macs += hw * hw * cfg.stages()[-1][4] * cfg.head_ch
    macs += cfg.head_ch * cfg.n_classes
    return float(macs)


def save_report(path: str, report: CellReport | dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(report.to_json() if isinstance(report, CellReport)
                  else report, f, indent=2)
