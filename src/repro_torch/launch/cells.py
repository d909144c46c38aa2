"""Cell builders: (architecture × input shape × mesh) -> one rank's step,
traced (counterpart of ``repro.launch.cells``).

For every dry-run cell this module produces

* the step function (train / prefill / decode / sample / serve), as the
  port runs it on one rank under ``rules``;
* ``global_args``: meta tensors of the step's inputs at their global
  shapes and dtypes, the reference's ``ShapeDtypeStruct`` stand-ins;
* ``in_specs``: each input's partition spec, the reference's
  ``in_shardings``;
* ``abstract_args``: meta tensors of what one rank's step is called with:
  the parameters and optimiser state narrowed by their specs, the batch,
  cache and tokens as the port's entry points take them (a train batch's
  rows and the decode cache cut to the rank's; the serving and sampling
  steps and DiT's train step take the whole batch on every rank and cut
  their own rows).

Smoke mode swaps the FULL config for the reduced SMOKE config and shrinks
the input shapes, as the reference does, so that the same builder drives
the CPU tests.  :meth:`CellBuild.trace` stands for the reference's
``lower()``: one run of the step under ``FakeTensorMode`` (on a fake
process group for a mesh of more than one rank), counted by
:func:`trace_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, optim, tree
from repro_torch.configs.shapes import Shape
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P, Rules
from repro_torch.models import (convnext, dit, efficientnet, layers,
                                transformer, vit)


@dataclasses.dataclass
class CellBuild:
    arch_id: str
    shape_name: str
    kind: str
    step_fn: Callable
    abstract_args: tuple
    in_specs: tuple
    global_args: tuple
    cfg: Any
    rules: Rules
    note: str = ""

    def trace(self) -> dict:
        """One run of the step on fakes of ``abstract_args`` on the rules'
        device: :func:`trace_step`'s counts."""
        return trace_step(self.step_fn, self.abstract_args,
                          self.rules.device)


class SkippedCell(Exception):
    """Raised for cells the assignment marks skip (reason in args[0])."""


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _opt_specs(pspecs):
    return optim.OptState(step=P(), mu=pspecs, nu=pspecs)


def _sgd_specs(pspecs):
    return optim.OptState(step=P(), mu=pspecs, nu=None)


def local_args(args, specs, rules: Rules):
    """Meta tensors of the rank's blocks of ``args`` under ``specs``."""
    def one(x, spec):
        shape = [n // rules.axis_size(sharding._axes(e))
                 for n, e in zip(x.shape, spec)]
        return _sds(shape, x.dtype)
    return tree.tree_map(one, args, specs)


def _whole(spec_tree):
    """A spec tree of ``spec_tree``'s structure that cuts nothing: inputs
    the port's step takes whole on every rank."""
    return tree.tree_map(lambda s: P(*(None,) * len(s)), spec_tree)


def _lazy(make: Callable) -> Callable:
    """A step that ``make()`` builds when it is called: building reads
    the rank's place on the mesh (its collectives), which a cell built on
    a stand-in mesh for its specs alone does not have."""
    def step(*args):
        return make()(*args)
    return step


def _build(rec, shape, kind, step, args, specs, local_specs, cfg, rules,
           note="") -> CellBuild:
    return CellBuild(rec.arch_id, shape.name, kind, step,
                     local_args(args, local_specs, rules), specs, args, cfg,
                     rules, note)


# --------------------------------------------------------------------------
# LM family
# --------------------------------------------------------------------------

def _lm_cell(rec, shape: Shape, rules: Rules, smoke: bool) -> CellBuild:
    cfg = rec.smoke if smoke else rec.full
    b, s = shape.global_batch, shape.seq_len
    if smoke:
        b, s = max(2, rules.dp), 64
    pspecs = transformer.param_specs(cfg, rules)
    params = transformer.abstract_params(cfg, ep=rules.tp,
                                         vocab_pad_to=rules.tp,
                                         dtype=torch.float32)

    if shape.kind == "train":
        step = _lazy(lambda: transformer.make_train_step(cfg, rules,
                                                         batch_size=b))
        opt = optim.adamw_init(params)
        batch = {"tokens": _sds((b, s), torch.int32),
                 "labels": _sds((b, s), torch.int32)}
        bspecs = {"tokens": P(rules.batch_spec(b), None),
                  "labels": P(rules.batch_spec(b), None)}
        specs = (pspecs, _opt_specs(pspecs), bspecs)
        # the rank's rows of the batch (``TokenPipeline(rules=)``)
        return _build(rec, shape, shape.kind, step, (params, opt, batch),
                      specs, specs, cfg, rules)

    if shape.kind == "prefill":
        tokens = _sds((b, s), torch.int32)
        specs = (pspecs, P(rules.batch_spec(b), None))

        step = _lazy(lambda: transformer.make_prefill_step(cfg, s, rules))
        return _build(rec, shape, shape.kind, step, (params, tokens), specs,
                      (pspecs, _whole(specs[1])), cfg, rules)

    if shape.kind == "decode":
        # Weights-stationary serving, as the reference: decode replicates
        # the params over the data axis (no optimizer states at serve
        # time) and keeps only the TP sharding.  The port's step reads
        # its leaves' layout from the rules it is built with.
        serve_rules = dataclasses.replace(rules, fsdp=None)
        pspecs = transformer.param_specs(cfg, serve_rules)
        cshape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.d_head)
        cache = {"k": _sds(cshape, layers.COMPUTE_DTYPE),
                 "v": _sds(cshape, layers.COMPUTE_DTYPE)}
        cspecs = transformer.cache_specs(cfg, rules, b, s)
        tokens = _sds((b, 1), torch.int32)
        pos = _sds((), torch.int32)
        specs = (pspecs, cspecs, P(rules.batch_spec(b), None), P())

        step = _lazy(lambda: transformer.make_decode_step(cfg, s,
                                                          serve_rules))
        return _build(rec, shape, shape.kind, step,
                      (params, cache, tokens, pos), specs,
                      (pspecs, cspecs, _whole(specs[2]), P()), cfg, rules)

    raise ValueError(shape.kind)


# --------------------------------------------------------------------------
# Diffusion family
# --------------------------------------------------------------------------

def _dit_cell(rec, shape: Shape, rules: Rules, smoke: bool) -> CellBuild:
    cfg = rec.smoke if smoke else rec.full
    b, res = shape.batch, shape.img_res
    if smoke:
        b, res = max(2, rules.dp), cfg.img_res
    lat = res // cfg.vae_downsample
    pspecs = dit.param_specs(cfg, rules)
    params = dit.abstract_params(cfg)
    bspec = rules.batch_spec(b)
    latent = (b, lat, lat, cfg.latent_channels)

    if shape.kind == "train":
        step = _lazy(lambda: dit.make_train_step(cfg, rules))
        opt = optim.adamw_init(params)
        batch = {"latents": _sds(latent, torch.float32),
                 "labels": _sds((b,), torch.int32),
                 "t": _sds((b,), torch.int32),
                 "noise": _sds(latent, torch.float32)}
        bspecs = {"latents": P(bspec, None, None, None),
                  "labels": P(bspec), "t": P(bspec),
                  "noise": P(bspec, None, None, None)}
        specs = (pspecs, _opt_specs(pspecs), bspecs)
        return _build(rec, shape, shape.kind, step, (params, opt, batch),
                      specs, (pspecs, specs[1], _whole(bspecs)), cfg, rules,
                      note=f"steps={shape.steps}")

    if shape.kind == "sample":
        step = _lazy(lambda: dit.make_sample_step(cfg, rules))
        args = (params, _sds(latent, layers.COMPUTE_DTYPE),
                _sds((b,), torch.int32), _sds((b,), torch.int32),
                _sds((b,), torch.int32))
        specs = (pspecs, P(bspec, None, None, None), P(bspec), P(bspec),
                 P(bspec))
        return _build(rec, shape, shape.kind, step, args, specs,
                      (pspecs, *_whole(specs[1:])), cfg, rules,
                      note=f"steps={shape.steps} (1 traced)")

    raise ValueError(shape.kind)


# --------------------------------------------------------------------------
# Vision family
# --------------------------------------------------------------------------

def _vision_common(rec, shape: Shape, rules: Rules, smoke: bool):
    cfg = rec.smoke if smoke else rec.full
    b, res = shape.batch, shape.img_res
    if smoke:
        b, res = max(2, rules.dp), cfg.img_res
    return cfg, b, res


def _train_batch(b, res, bspec):
    batch = {"images": _sds((b, res, res, 3), torch.float32),
             "labels": _sds((b,), torch.int32)}
    return batch, {"images": P(bspec, None, None, None), "labels": P(bspec)}


def _dense_vision_cell(mod, rec, shape, rules, smoke) -> CellBuild:
    """ViT and ConvNeXt: AdamW train steps on the rank's rows, the serving
    forward on the whole images."""
    cfg, b, res = _vision_common(rec, shape, rules, smoke)
    pspecs = mod.param_specs(cfg, rules)
    params = mod.abstract_params(cfg)
    bspec = rules.batch_spec(b)

    if shape.kind == "train":
        step = _lazy(lambda: mod.make_train_step(cfg, rules))
        opt = optim.adamw_init(params)
        batch, bspecs = _train_batch(b, res, bspec)
        specs = (pspecs, _opt_specs(pspecs), bspecs)
        return _build(rec, shape, shape.kind, step, (params, opt, batch),
                      specs, specs, cfg, rules)

    def step(p, x):
        return mod.forward(p, x, cfg, rules)

    images = _sds((b, res, res, 3), torch.float32)
    specs = (pspecs, P(bspec, None, None, None))
    return _build(rec, shape, shape.kind, step, (params, images), specs,
                  (pspecs, _whole(specs[1])), cfg, rules)


def _vit_cell(rec, shape, rules, smoke) -> CellBuild:
    return _dense_vision_cell(vit, rec, shape, rules, smoke)


def _convnext_cell(rec, shape, rules, smoke) -> CellBuild:
    return _dense_vision_cell(convnext, rec, shape, rules, smoke)


def _effnet_cell(rec, shape, rules, smoke) -> CellBuild:
    cfg, b, res = _vision_common(rec, shape, rules, smoke)
    pspecs, sspecs = efficientnet.param_specs(cfg, rules)
    params, state = efficientnet.abstract_params(cfg)
    bspec = rules.batch_spec(b)

    if shape.kind == "train":
        step = _lazy(lambda: efficientnet.make_train_step(cfg, rules))
        opt = optim.sgdm_init(params)
        batch, bspecs = _train_batch(b, res, bspec)
        specs = (pspecs, sspecs, _sgd_specs(pspecs), bspecs)
        return _build(rec, shape, shape.kind, step,
                      (params, state, opt, batch), specs, specs, cfg, rules)

    def step(p, s, x):
        return efficientnet.apply(p, s, x, cfg, rules=rules, train=False)[0]

    images = _sds((b, res, res, 3), torch.float32)
    specs = (pspecs, sspecs, P(bspec, None, None, None))
    return _build(rec, shape, shape.kind, step, (params, state, images),
                  specs, (pspecs, sspecs, _whole(specs[2])), cfg, rules)


_VISION_BUILDERS = {
    "vit-l16": _vit_cell,
    "vit-h14": _vit_cell,
    "convnext-b": _convnext_cell,
    "efficientnet-b7": _effnet_cell,
}


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

def input_specs(arch_id: str, shape_name: str, rules: Rules) -> tuple:
    """Meta tensors of every input of the cell's step at the global
    shapes and dtypes (the reference's ``input_specs``)."""
    return build_cell(arch_id, shape_name, rules).global_args


def build_cell(arch_id: str, shape_name: str, rules: Rules,
               smoke: bool = False,
               overrides: dict | None = None) -> CellBuild:
    """overrides: dataclasses.replace(...) fields applied to the config
    (dry-run probes: n_layers=1/2).  ``rules`` may stand on any object
    with ``.shape`` and ``.axis_names`` to build; tracing needs a
    :class:`~repro_torch.launch.mesh.Mesh`."""
    rec = configs.get(arch_id)
    if overrides:
        rec = dataclasses.replace(
            rec, full=dataclasses.replace(rec.full, **overrides),
            smoke=dataclasses.replace(rec.smoke, **overrides))
    shape = rec.shape(shape_name)
    if shape.kind == "skip":
        raise SkippedCell(shape.note)
    if rec.family == "lm":
        return _lm_cell(rec, shape, rules, smoke)
    if rec.family == "diffusion":
        return _dit_cell(rec, shape, rules, smoke)
    if rec.family == "vision":
        return _VISION_BUILDERS[arch_id](rec, shape, rules, smoke)
    raise ValueError(rec.family)


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------

#: Ops that move no bytes of their own: allocations without a write and
#: aliases (views are told by ``OpOverload.is_view``, metadata ops by
#: their ``prim`` namespace).
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense"}
_SKIPPED_NAMESPACES = ("prim", "c10d", "_c10d_functional",
                       "c10d_functional", "_dtensor")


class ByteCounter(TorchDispatchMode):
    """Bytes each op reads and writes: its tensor inputs' and outputs'
    sizes, summed over the ops that run (views, aliases, allocations and
    collectives left out; a custom op counted once, its operands and its
    results, whatever it runs inside).  The eager port's traffic with
    nothing fused: an upper bound of its HBM traffic."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        ns, _, op = name.partition("::")
        if not (func.is_view or op in _NO_TRAFFIC
                or ns in _SKIPPED_NAMESPACES):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree.leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _storage_bytes(ts) -> int:
    seen, total = set(), 0
    for t in tree.leaves(ts):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            key = id(st)
            if key not in seen:
                seen.add(key)
                total += st.nbytes()
    return total


def trace_step(step: Callable, args: tuple, device, *,
               memory: bool = True) -> dict:
    """Run ``step(*fakes of args on device)`` once under
    ``FakeTensorMode`` and count it: FLOPs (``FlopCounterMode``: every op
    that runs, K7, K7b and the row-parallel product by their formulas),
    bytes (:class:`ByteCounter`), each collective of more than one rank
    (``Collective.recording``), and, with ``memory``, the peak of live
    fake storages across the step with the arguments in it (``MemTracker``;
    the arguments are made inside it), the arguments' and the outputs'
    bytes.  ``args``: a tuple of trees of tensors (meta or fake) whose
    shapes and dtypes the fakes take.  Attention on a ``cuda`` device
    goes through K7's and K7b's fakes, on the CPU through their plain
    versions (``attention`` in the result says which).  Runs with
    ``torch.distributed`` as it is initialised: a mesh of more than one
    rank needs a fake process group (``launch.mesh.fake_group``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    device = torch.device(device)
    counter = ByteCounter()
    tracker = MemTracker() if memory else None
    with FakeTensorMode(), sharding.Collective.recording() as records:
        if tracker is not None:
            tracker.__enter__()
        try:
            fakes = tree.tree_map(
                lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      device=device), args)
            arg_bytes = _storage_bytes(fakes)
            with FlopCounterMode(display=False) as flops, counter:
                out = step(*fakes)
            out_bytes = _storage_bytes(out)
            del out, fakes
        finally:
            if tracker is not None:
                tracker.__exit__(None, None, None)
    peak = 0
    if tracker is not None:
        peak = sum(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values())
    return dict(flops=flops.get_total_flops(), bytes=counter.bytes,
                collectives=records, peak_bytes=peak,
                argument_bytes=arg_bytes, output_bytes=out_bytes,
                attention=("K7/K7b fakes" if device.type == "cuda"
                           else "plain versions"))
