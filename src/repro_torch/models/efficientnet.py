"""EfficientNet-B7 (Tan & Le, arXiv:1905.11946; width 2.0, depth 3.1), on
one device or on a mesh.

Counterpart of ``repro.models.efficientnet``: MBConv blocks (1×1 expand,
k×k depthwise, squeeze-excite, 1×1 project) with batch norm and SiLU; the
B7 scaling gives 55 blocks in 7 stages.  Each stage keeps its first block
("head") apart and its stride-1 repeats ("rest") stacked on a leading dim
as in the reference (its ``scan``), run as a Python loop
(``layers.scan_layers``); each "rest" block is checkpointed under
autograd with the "nothing" policy unless ``cfg.unroll``, as the
reference's ``nothing_saveable``.  No Pallas kernel runs here in the
reference, which leaves every conv to XLA: the stem and depthwise convs
are ``F.conv2d``, the 1×1 convs (expand, project, squeeze-excite, head)
matmuls over the channels.

Batch norm keeps its running statistics in a separate ``state`` tree:
``apply(params, state, x, train=True)`` normalises by the batch's mean and
population variance and returns the running stats moved 1% toward them
(momentum 0.99); ``train=False`` normalises by the running stats (the
serve shapes) and runs under ``torch.inference_mode``.  The new
statistics are outputs of a checkpointed block, not updates in place, so
the block's recompute in the backward cannot move them a second time.
The ``"SAME"`` padding is XLA's: at stride 2 it pads low = total // 2 and
high the rest, which is not PyTorch's symmetric padding.

``binary_pointwise=True`` runs the 1×1 expand/project as STE-sign binary
convs on latent float weights (the depthwise convs and SE stay float).
Layouts: images and activations NHWC; conv kernels stored (O, I, KH, KW)
(a depthwise (k, k, 1, C) as (C, 1, k, k)).  The squeeze-excite and the
head run in float32, as the reference's.

On a mesh (``rules``): ``param_specs`` is the reference's, every conv's
output channels (and every other leaf's last dim, the BN state's too) cut
over ``model``.  The batch runs over the batch axes.  The layout over
``model`` is the port's: activations keep their channels whole on every
model rank and each block gathers its leaves whole (their gradient each
rank's own block), so no activation crosses ``model`` (a channel-cut
1×1 conv would move a whole feature map a block).  Train-mode batch norm
is synced: each channel's mean, then its variance about it, is summed
over the batch axes (``sharding.sum_stats``, whose backward sums the
cotangents likewise), the statistics of the reference's global batch;
the running statistics come out equal on every data rank, each rank
keeping its block of them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.binarize import ste_sign
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import P
from repro_torch.models import layers
from repro_torch.models.zoo_mesh import Layout, dim_of, shard_params
from repro_torch.optim import sgdm_update
from repro_torch.tree import value_and_grad

# (expand_ratio, kernel, stride, base_out_channels, base_repeats)
_BASE_BLOCKS = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2),
                (6, 3, 2, 80, 3), (6, 5, 1, 112, 3), (6, 5, 2, 192, 4),
                (6, 3, 1, 320, 1))
_BN_MOM = 0.99
_BN_EPS = 1e-3


def round_filters(c: float, width: float) -> int:
    c *= width
    new = max(8, int(c + 4) // 8 * 8)
    if new < 0.9 * c:
        new += 8
    return int(new)


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    name: str
    img_res: int = 600
    width: float = 2.0
    depth: float = 3.1
    n_classes: int = 1000
    se_ratio: float = 0.25
    binary_pointwise: bool = False
    # the reference's dry-run knob: the blocks run without remat under it
    unroll: bool = False

    @property
    def stem_ch(self) -> int:
        return round_filters(32, self.width)

    @property
    def head_ch(self) -> int:
        return round_filters(1280, self.width)

    def stages(self):
        """Resolved per-stage (expand, kernel, stride, in_c, out_c,
        repeats)."""
        out = []
        prev = self.stem_ch
        for e, k, s, c, r in _BASE_BLOCKS:
            oc = round_filters(c, self.width)
            out.append((e, k, s, prev, oc, round_repeats(r, self.depth)))
            prev = oc
        return out

    def param_count(self) -> int:
        """Parameters, counted from the shapes (nothing allocated)."""
        return sum(math.prod(s) for s in _leaves(_param_shapes(self)))


#: Leaves stored (O, I, KH, KW); the reference keeps them HWIO.
CONV_LEAVES = frozenset({"stem_w", "exp_w", "dw_w", "se_w1", "se_w2",
                         "proj_w", "head_w"})
#: Leaves the forward reads in float32 (BN scales and biases, the
#: squeeze-excite, the float32 head): kept float32 whatever ``dtype``
#: (the BN state is float32 throughout).
FLOAT32_LEAVES = frozenset({
    "stem_bn_s", "stem_bn_b", "exp_bn_s", "exp_bn_b", "dw_bn_s", "dw_bn_b",
    "proj_bn_s", "proj_bn_b", "head_bn_s", "head_bn_b", "se_w1", "se_b1",
    "se_w2", "se_b2", "fc_w", "fc_b"})


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


# Parameter and state trees as ("kind", shape) leaves: "conv" (O, I, KH,
# KW) He-normal, "normal" N(0, 0.02²), "zeros", "ones".
def _block_shapes(e, k, c_in, c_out, se_ratio, n: int | None):
    mid = c_in * e
    se = max(1, int(c_in * se_ratio))

    def st(kind, *shape):
        return (kind, shape if n is None else (n, *shape))
    p = {}
    if e != 1:
        p["exp_w"] = st("conv", mid, c_in, 1, 1)
        p["exp_bn_s"], p["exp_bn_b"] = st("ones", mid), st("zeros", mid)
    p["dw_w"] = st("conv", mid, 1, k, k)
    p["dw_bn_s"], p["dw_bn_b"] = st("ones", mid), st("zeros", mid)
    p["se_w1"] = st("conv", se, mid, 1, 1)
    p["se_b1"] = st("zeros", se)
    p["se_w2"] = st("conv", mid, se, 1, 1)
    p["se_b2"] = st("zeros", mid)
    p["proj_w"] = st("conv", c_out, mid, 1, 1)
    p["proj_bn_s"], p["proj_bn_b"] = st("ones", c_out), st("zeros", c_out)
    s = {}

    def zo(c):
        shape = (c,) if n is None else (n, c)
        return {"mean": ("zeros", shape), "var": ("ones", shape)}
    if e != 1:
        s["exp_bn"] = zo(mid)
    s["dw_bn"] = zo(mid)
    s["proj_bn"] = zo(c_out)
    return p, s


def _trees(cfg: EffNetConfig):
    params: dict = {"stem_w": ("conv", (cfg.stem_ch, 3, 3, 3)),
                    "stem_bn_s": ("ones", (cfg.stem_ch,)),
                    "stem_bn_b": ("zeros", (cfg.stem_ch,)), "stages": []}
    state: dict = {"stem_bn": {"mean": ("zeros", (cfg.stem_ch,)),
                               "var": ("ones", (cfg.stem_ch,))},
                   "stages": []}
    for e, k, s, c_in, c_out, r in cfg.stages():
        hp, hs = _block_shapes(e, k, c_in, c_out, cfg.se_ratio, None)
        sp, ss = {"head": hp}, {"head": hs}
        if r > 1:
            sp["rest"], ss["rest"] = _block_shapes(e, k, c_out, c_out,
                                                   cfg.se_ratio, r - 1)
        params["stages"].append(sp)
        state["stages"].append(ss)
    last = cfg.stages()[-1][4]
    params.update(head_w=("conv", (cfg.head_ch, last, 1, 1)),
                  head_bn_s=("ones", (cfg.head_ch,)),
                  head_bn_b=("zeros", (cfg.head_ch,)),
                  fc_w=("normal", (cfg.head_ch, cfg.n_classes)),
                  fc_b=("zeros", (cfg.n_classes,)))
    state["head_bn"] = {"mean": ("zeros", (cfg.head_ch,)),
                        "var": ("ones", (cfg.head_ch,))}
    return params, state


def _param_shapes(cfg: EffNetConfig):
    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return t[1]
    return shapes(_trees(cfg)[0])


@torch.no_grad()
def init_params(cfg: EffNetConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32):
    """(params, state) with the reference's shapes and scales (convs
    He-normal over their fan-in, the classifier N(0, 0.02²), biases 0, BN
    scales 1; running means 0, variances 1), drawn in float32 from
    ``generator`` on ``device``; params stored in ``dtype`` but for
    ``FLOAT32_LEAVES``, the state float32."""
    device = resolve_device(device)

    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        if isinstance(t, list):
            return [make(v) for v in t]
        kind, shape = t
        if kind == "conv":
            return layers.draw(shape, math.sqrt(
                2.0 / math.prod(shape[-3:])), generator, device)
        if kind == "normal":
            return layers.draw(shape, 0.02, generator, device)
        return (torch.zeros if kind == "zeros" else torch.ones)(
            shape, device=device)

    params, state = _trees(cfg)
    return layers.store(make(params), dtype, FLOAT32_LEAVES), make(state)


def _map_named(fn, t, name=""):
    if isinstance(t, dict):
        return {k: _map_named(fn, v, k) for k, v in t.items()}
    if isinstance(t, list):
        return [_map_named(fn, v, name) for v in t]
    return fn(name, t)


def param_specs(cfg: EffNetConfig, rules):
    """(params' specs, state's specs): the reference's, each conv's output
    channels (the (O, I, KH, KW) kernel's O) and every other leaf's last
    dim over ``rules.model`` where it divides."""
    def spec(name, leaf):
        shape = leaf[1]
        dim = len(shape) - 4 if name in CONV_LEAVES else len(shape) - 1
        entries = [None] * len(shape)
        entries[dim] = rules.shard_if(shape[dim], rules.model)
        return P(*entries)

    params, state = _trees(cfg)
    return _map_named(spec, params), _map_named(spec, state)


def abstract_params(cfg: EffNetConfig, dtype: torch.dtype = torch.float32):
    """(params, state) of full shapes and dtypes as meta tensors (no
    memory)."""
    return init_params(cfg, None, "meta", dtype)


@torch.no_grad()
def params_from_numpy(tree, cfg: EffNetConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype = torch.float32, rules=None):
    """(params, state) from the reference's ``init_params`` pair as numpy
    arrays: the same values, conv kernels in (O, I, KH, KW), stored as
    :func:`init_params` stores them; with ``rules`` this rank's slices of
    :func:`param_specs`."""
    device = resolve_device(device)
    params, state = tree
    full = (layers.tree_from_numpy(params, device, dtype, CONV_LEAVES,
                                   FLOAT32_LEAVES),
            layers.tree_from_numpy(state, device, torch.float32))
    return shard_params(full, rules and param_specs(cfg, rules), rules)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _bn(x, scale, bias, stats, train: bool, mesh=None):
    """Batch norm over N, H, W in float32.  Returns (y in x's dtype,
    new_stats).  ``mesh`` (a block's :class:`_Mesh`): the statistics
    summed over the batch axes, ``stats`` and the new ones the rank's
    block of the channels."""
    xf = x.float()
    if train and mesh is not None and mesh.sync.size > 1:
        n = xf.shape[0] * xf.shape[1] * xf.shape[2] * mesh.sync.size
        mean = sharding.sum_stats(xf.sum(dim=(0, 1, 2)), mesh.sync) / n
        var = sharding.sum_stats((xf - mean).square().sum(dim=(0, 1, 2)),
                                 mesh.sync) / n
    elif train:
        mean = xf.mean(dim=(0, 1, 2))
        var = xf.var(dim=(0, 1, 2), correction=0)
    if train:
        own = mesh.own if mesh is not None else (lambda t: t)
        new = {"mean": _BN_MOM * stats["mean"] + (1 - _BN_MOM) * own(mean),
               "var": _BN_MOM * stats["var"] + (1 - _BN_MOM) * own(var)}
    else:
        mean, var = stats["mean"], stats["var"]
        new = stats
    y = (xf - mean) * torch.rsqrt(var + _BN_EPS) * scale.float() \
        + bias.float()
    return y.to(x.dtype), new


class _Mesh:
    """A rank's hooks for one block under ``rules``: its leaves whole,
    the batch statistics' sum, each statistic's own block."""

    def __init__(self, lay: Layout, pspecs, sspecs, strip: int = 0):
        self.lay, self.pspecs, self.sspecs = lay, pspecs, sspecs
        self.strip = strip            # 1: a stacked block's layer dim
        self.sync = lay.batch
        self.model = lay.model

    def params(self, p: dict) -> dict:
        names = list(p)
        got = self.lay.whole([p[n] for n in names],
                             [P(*list(self.pspecs[n])[self.strip:])
                              for n in names])
        return dict(zip(names, got))

    def state(self, s: dict, train: bool) -> dict:
        """Train mode keeps the rank's block (it moves only that);
        eval mode reads the running statistics whole."""
        if train:
            return s
        out = {}
        for name, st in s.items():
            spec = self.sspecs[name]["mean"]
            dim = dim_of(P(*list(spec)[self.strip:]),
                         self.lay.rules.model)
            out[name] = {k: v if dim is None
                         else self.model.all_gather(v, axis=dim)
                         for k, v in st.items()}
        return out

    def own(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[-1] % self.model.size or self.model.size == 1:
            return t
        n = t.shape[-1] // self.model.size
        return t[..., self.model.index * n:(self.model.index + 1) * n]


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (low, high), low = total //
    2; out = ceil(size / stride)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """NHWC conv with XLA's "SAME" padding, in ``x``'s dtype; the kernel
    (O, I/groups, KH, KW).  Asymmetric pads go through ``F.pad``."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[1 + a], w.shape[2 + a], stride)
                          for a in (0, 1))
    xc = x.permute(0, 3, 1, 2)
    if hl == hh and wl == wh:
        pad = (hl, wl)
    else:
        xc, pad = F.pad(xc, (wl, wh, hl, hh)), 0
    y = F.conv2d(xc, w.to(x.dtype), stride=stride, padding=pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _pointwise(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 1×1 conv over NHWC channels: x (..., I) @ w (O, I, 1, 1)ᵀ, in
    ``x``'s dtype."""
    return x @ w[:, :, 0, 0].to(x.dtype).t()


def _pointwise_binary(x, w, binary: bool):
    if not binary:
        return _pointwise(x, w)
    return _pointwise(ste_sign(x.float()).to(x.dtype), ste_sign(w))


def _mb_block(x, p, s, *, expand, stride, train, binary, mesh=None):
    """One MBConv block.  Returns (y, new_state).  ``mesh``: the rank's
    hooks under ``rules`` (its slices in, its blocks of the state out)."""
    if mesh is not None:
        p, s = mesh.params(p), mesh.state(s, train)
    ns = dict(s)
    h = x
    if expand != 1:
        h = _pointwise_binary(h, p["exp_w"], binary)
        h, ns["exp_bn"] = _bn(h, p["exp_bn_s"], p["exp_bn_b"], s["exp_bn"],
                              train, mesh)
        h = layers.silu(h, exact=binary)
    h = conv_same(h, p["dw_w"], stride=stride, groups=h.shape[-1])
    h, ns["dw_bn"] = _bn(h, p["dw_bn_s"], p["dw_bn_b"], s["dw_bn"], train,
                         mesh)
    h = layers.silu(h, exact=binary)
    # squeeze-excite, float32
    se = h.float().mean(dim=(1, 2), keepdim=True)
    se = layers.silu(_pointwise(se, p["se_w1"].float()) + p["se_b1"].float())
    se = torch.sigmoid(_pointwise(se, p["se_w2"].float())
                       + p["se_b2"].float())
    h = h * se.to(h.dtype)
    h = _pointwise_binary(h, p["proj_w"], binary)
    h, ns["proj_bn"] = _bn(h, p["proj_bn_s"], p["proj_bn_b"], s["proj_bn"],
                           train, mesh)
    if stride == 1 and x.shape[-1] == h.shape[-1]:
        h = h + x
    return h, ns


def _apply(params, state, images, cfg: EffNetConfig, train: bool,
           rules=None):
    cd = layers.COMPUTE_DTYPE
    lay = Layout(rules)
    if lay.on:
        pspecs, sspecs = param_specs(cfg, rules)
        top = _Mesh(lay, pspecs, sspecs)

        def mesh(i, part):
            st_p, st_s = pspecs["stages"][i][part], sspecs["stages"][i][part]
            return _Mesh(lay, st_p, st_s, 1 if part == "rest" else 0)
        names = ["stem_w", "stem_bn_s", "stem_bn_b", "head_w", "head_bn_s",
                 "head_bn_b", "fc_w", "fc_b"]
        params = {**params, **top.params({n: params[n] for n in names})}
        state = {**state, **top.state({n: state[n] for n in
                                       ("stem_bn", "head_bn")}, train)}
    else:
        top = None

        def mesh(i, part):
            return None
    new_state: dict = {"stages": []}
    x = conv_same(images.to(cd), params["stem_w"], stride=2)
    x, new_state["stem_bn"] = _bn(x, params["stem_bn_s"],
                                  params["stem_bn_b"], state["stem_bn"],
                                  train, top)
    x = layers.silu(x, exact=cfg.binary_pointwise)
    for i, ((e, k, s, c_in, c_out, r), sp, ss) in enumerate(zip(
            cfg.stages(), params["stages"], state["stages"])):
        x, head_ns = _mb_block(x, sp["head"], ss["head"], expand=e,
                               stride=s, train=train,
                               binary=cfg.binary_pointwise,
                               mesh=mesh(i, "head"))
        stage_ns = {"head": head_ns}
        if r > 1:
            # ``e`` bound now, for the recompute (as ConvNeXt's ``dim``)
            def body(x, ps, e=e, m=mesh(i, "rest")):
                return _mb_block(x, *ps, expand=e, stride=1, train=train,
                                 binary=cfg.binary_pointwise, mesh=m)

            x, stage_ns["rest"] = layers.scan_layers(
                body, x, (sp["rest"], ss["rest"]), n_layers=r - 1,
                remat=not cfg.unroll)
        new_state["stages"].append(stage_ns)
    x = _pointwise(x, params["head_w"])
    x, new_state["head_bn"] = _bn(x, params["head_bn_s"],
                                  params["head_bn_b"], state["head_bn"],
                                  train, top)
    x = layers.silu(x).float().mean(dim=(1, 2))
    return x @ params["fc_w"].float() + params["fc_b"].float(), new_state


def apply(params, state, images: torch.Tensor, cfg: EffNetConfig, *,
          train: bool, rules=None):
    """images (B, R, R, 3) float -> (logits (B, n_classes) float32,
    new_state).  ``train=True`` uses the batch's statistics under autograd;
    ``train=False`` the running ones, under ``torch.inference_mode``.
    With ``rules``: train mode takes the rank's rows
    (``rules.batch_cut``) and gives its rows' logits and its blocks of the
    state; eval mode takes the whole images on every rank and gives the
    whole logits."""
    if train:
        return _apply(params, state, images, cfg, True, rules)
    with torch.inference_mode():
        lay = Layout(rules)
        out, new = _apply(params, state, lay.rows(images), cfg, False, rules)
        return lay.gather_rows(out, images.shape[0]), new


def loss_fn(params, state, batch: dict, cfg: EffNetConfig, rules=None):
    """(mean cross entropy of the batch in train mode, new BN state).
    With ``rules``: the rank's rows; the loss is the global mean, the same
    on every rank."""
    lg, new_state = apply(params, state, batch["images"], cfg, train=True,
                          rules=rules)
    lg = lg.float()
    gold = torch.take_along_dim(lg, batch["labels"].long()[:, None],
                                dim=-1)[:, 0]
    ce = torch.logsumexp(lg, dim=-1) - gold
    if rules is None:
        return ce.mean(), new_state
    return Layout(rules).mean_over_batch(ce.sum(), ce.shape[0]), new_state


def make_train_step(cfg: EffNetConfig, rules=None, *, lr=0.016
                    ) -> Callable:
    """(params, state, opt_state, batch) -> (params, state, opt_state,
    metrics): the loss's gradient in train mode, the moved BN state, then
    one SGD-momentum step with the reference's defaults.  With ``rules``
    (every rank on its slices and rows): the gradient summed over the
    batch axes, the norm over every rank's leaves, the state the rank's
    blocks."""
    specs = param_specs(cfg, rules)[0] if rules is not None else None
    lay = Layout(rules)

    def train_step(params, state, opt_state, batch):
        (loss, new_state), grads = value_and_grad(loss_fn, params, state,
                                                  batch, cfg, rules)
        grads = lay.sync(grads, specs)
        params, opt_state, om = sgdm_update(params, grads, opt_state, lr=lr,
                                            rules=rules, specs=specs)
        return params, new_state, opt_state, {"loss": loss, **om}

    return train_step
