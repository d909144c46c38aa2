"""The port's CUDA kernels on the card (``-m gpu``; skipped without one).

This file imports neither jax nor the JAX package, so it runs on a
machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held bit for bit against its plain PyTorch version (which
``tests/test_torch_kernels.py`` holds against the JAX package on the CPU),
and the tiny workloads on the card against the same port on the CPU.
"""

import dataclasses
from statistics import NormalDist

import numpy as np
import pytest
import torch

from repro_torch import configs, workloads
from repro_torch.core import bitplanes, packing
from repro_torch.workloads import preprocess
from repro_torch.kernels import bitplane_pack as k4
from repro_torch.kernels import build, pm1_gemm
from repro_torch.kernels import chain_conv as k5
from repro_torch.kernels import direct_conv_bn_binarize as k3
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import fused_conv_bn_binarize as k2
from repro_torch.kernels import mxu_pm1_matmul as k6
from repro_torch.kernels import xnor_popcount_matmul as k1
from repro_torch import optim, tree
from repro_torch.models import dit, layers, moe, transformer, vit
from repro_torch.runtime import (GraphExecutor, assign_layouts,
                                 default_pipeline, lower_trained, regions)
from repro_torch.runtime.executor import WARMUP_CALLS, CapturedExecutor
from repro_torch.serving.lm_server import LMServer

pytestmark = pytest.mark.gpu

RNG = np.random.default_rng(23)
# On the card a bucket is captured on its first call: its kernel wrappers
# run once a warm-up call and once while captured; a replay runs none.
CAPTURE_CALLS = WARMUP_CALLS + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def words(dev, *shape) -> torch.Tensor:
    return torch.from_numpy(RNG.integers(-2 ** 31, 2 ** 31, shape,
                                         dtype=np.int64).astype(np.int32)
                            ).to(dev)


def epilogue(dev, n: int, ww: torch.Tensor, pool_positions: int = 1):
    """Thresholds and sign flips of ``n`` channels that give a mix of
    output bits.  Over full random words the count ``sum ww·popcount``
    has mean ``16·sum ww`` and variance ``8·sum ww²``.  A pooled bit ORs
    ``pool_positions`` conv bits, so each conv bit is centred on the
    probability q with ``1 - (1 - q)^P = 1/2``; each channel's threshold
    is spread by one standard deviation around that centre."""
    ww = ww.double()
    mean, sd = 16.0 * float(ww.sum()), (8.0 * float((ww * ww).sum())) ** .5
    z = NormalDist().inv_cdf(1 - 0.5 ** (1 / pool_positions))
    sgn = RNG.integers(0, 2, n).astype(bool)
    thr = np.round(mean + sd * (np.where(sgn, -z, z) + RNG.uniform(-1, 1, n)))
    return (torch.from_numpy(thr.astype(np.int32)).to(dev),
            torch.from_numpy(sgn).to(dev))


def captured_launches(call, x, fns) -> tuple[int, ...]:
    """Launches of ``fns`` a forward, counted while ``call(x)`` builds and
    captures its bucket (the counts over that first call, divided by
    ``CAPTURE_CALLS``); a second call, a replay, must add none."""
    for fn in fns:
        fn.launches = 0
    call(x)
    torch.cuda.synchronize()
    first = tuple(fn.launches for fn in fns)
    call(x)
    torch.cuda.synchronize()
    assert tuple(fn.launches for fn in fns) == first, "a replay launched"
    assert all(n % CAPTURE_CALLS == 0 for n in first), first
    return tuple(n // CAPTURE_CALLS for n in first)


def assert_mixed(out: torch.Tensor, channels: int) -> None:
    """A near-constant output could hide a miscount: most bits must mix."""
    share = packing.unpack_bits(out, channels).float().mean().item()
    assert 0.2 <= share <= 0.8, share


@pytest.mark.parametrize("shape", [(2, 31, 29, 3), (1, 7, 5, 40)])
def test_bitplane_pack_on_card(cuda, shape):
    x = torch.from_numpy(RNG.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    assert torch.equal(k4.bitplane_pack(x), k4.bitplane_pack_plain(x))


@pytest.mark.parametrize("shape", [(1, 37, 41, c) for c in (
    1, 8, 31, 32, 33, 64, 100, 200)] + [(3, 1, 1, 33), (2, 333, 1, 5),
                                        (8, 227, 227, 3), (1, 1, 2, 16384)])
def test_bitplane_pack_every_width_on_card(cuda, shape):
    """K4 at every C path (Cw 1 with the warp's shuffled stores, 2-4 from
    registers, above by words), at pixel counts no multiple of a block's
    256, from an aligned start and from a start off a 16-byte boundary."""
    n = shape[0]
    big = torch.from_numpy(RNG.integers(0, 256, (n + 1,) + shape[1:],
                                        dtype=np.uint8)).to(cuda)
    for x in (big[:n].contiguous(), big[1:]):
        assert torch.equal(k4.bitplane_pack(x), k4.bitplane_pack_plain(x))
    with pytest.raises(ValueError, match="channels"):
        k4.bitplane_pack(torch.zeros((1, 1, 1, k4.MAX_CHANNELS + 1),
                                     dtype=torch.uint8, device=cuda))


@pytest.mark.parametrize("m,n,w,weighted", [(8, 4096, 288, False),
                                            (13, 48, 7, True),
                                            (1, 96, 30, False),
                                            (5832, 256, 75, False),
                                            (37, 48, 13, False),
                                            (17, 4096, 288, False)])
def test_fused_matmul_on_card(cuda, m, n, w, weighted):
    ww = (torch.from_numpy(RNG.integers(1, 129, w).astype(np.int32)).to(cuda)
          if weighted else None)
    args = (words(cuda, m, w), words(cuda, n, w),
            *epilogue(cuda, n, ww if weighted else torch.ones(w)), ww)
    got = k2.fused_matmul_bn_binarize(*args)
    assert torch.equal(got, k2.fused_matmul_bn_binarize_plain(*args))
    assert_mixed(got, n)


@pytest.mark.parametrize("case", [
    ((2, 9, 8, 2), 3, 1, 1, 64, None, False),
    ((1, 13, 13, 3), 5, 1, 2, 48, (3, 2, (0, 0)), False),
    ((2, 7, 7, 2), 3, 1, 1, 32, (2, 1, (0, 1)), False),
    ((2, 35, 35, 8), 11, 4, 0, 96, (3, 2, (0, 0)), True),
])
def test_direct_conv_on_card(cuda, case):
    (n, h, w, cw), k, st, pad, o, pool, first = case
    ww = (bitplanes.plane_word_weights(cw // 8).repeat(k * k).to(cuda)
          if first else None)
    args = (words(cuda, n, h, w, cw), words(cuda, o, k * k * cw),
            *epilogue(cuda, o, ww if first else torch.ones(k * k * cw),
                      pool[0] ** 2 if pool else 1))
    kw = dict(kh=k, kw=k, stride=st, pad=pad, word_weights=ww, pool=pool)
    got = k3.direct_conv_bn_binarize(*args, **kw)
    assert torch.equal(got, k3.direct_conv_bn_binarize_plain(*args, **kw))
    assert_mixed(got, o)


CHAIN_CASES = [  # (entry (N, H, W, C), first layer, stages, tile)
    ((2, 51, 51, 3), True,
     (k5.StageSpec("conv", 11, 4, 0, 0, 96, True),
      k5.StageSpec("pool", 3, 2, 0, 0, 96),
      k5.StageSpec("conv", 5, 1, 2, 2, 64),
      k5.StageSpec("pool", 3, 2, 0, 0, 64)), {}),
    ((2, 51, 51, 3), True,
     (k5.StageSpec("conv", 11, 4, 0, 0, 96, True),
      k5.StageSpec("pool", 3, 2, 0, 0, 96),
      k5.StageSpec("conv", 5, 1, 2, 2, 64),
      k5.StageSpec("pool", 3, 2, 0, 0, 64)), dict(block_h=1, block_w=1)),
    ((3, 13, 13, 64), False,
     (k5.StageSpec("conv", 3, 1, 1, 1, 64),
      k5.StageSpec("pool", 2, 1, 0, 1, 64),
      k5.StageSpec("conv", 3, 1, 1, 1, 40)),
     dict(block_h=5, block_w=4, block_n=2)),
    # Fewer rows than a cluster has ranks from stage 1 on: shared out by
    # output words, most ranks get none.
    ((2, 16, 16, 64), False,
     (k5.StageSpec("conv", 3, 1, 1, 1, 64),
      k5.StageSpec("pool", 2, 2, 0, 0, 64),
      k5.StageSpec("conv", 3, 1, 1, 1, 128),
      k5.StageSpec("pool", 2, 2, 0, 0, 128)), {}),
    # Batch 1, and 3 images a cluster with a last block of 1.
    ((1, 51, 51, 3), True,
     (k5.StageSpec("conv", 11, 4, 0, 0, 96, True),
      k5.StageSpec("pool", 3, 2, 0, 0, 96),
      k5.StageSpec("conv", 5, 1, 2, 2, 64)), {}),
    ((7, 19, 19, 64), False,
     (k5.StageSpec("conv", 3, 1, 1, 1, 64),
      k5.StageSpec("pool", 2, 2, 0, 0, 64),
      k5.StageSpec("conv", 3, 1, 1, 1, 40)), dict(block_n=3)),
]


def chain_inputs(cuda, entry, first, stages, tile):
    """A seeded K5 call: the entry, kernel-layout operands, and the
    planner's arena keywords."""
    n, h, w, c = entry
    planes = 8 if first else 1
    cw = planes * packing.num_words(c)
    x = words(cuda, n, h, w, cw)
    arrays, cin = [], cw
    convs = [i for i, st in enumerate(stages) if st.kind == "conv"]
    for i in convs:
        st = stages[i]
        k = st.kernel * st.kernel * cin
        ww = (bitplanes.plane_word_weights(cin // 8).repeat(
            st.kernel * st.kernel).to(cuda) if st.first else None)
        pooled = i + 1 < len(stages) and stages[i + 1].kind == "pool"
        arrays += [words(cuda, st.channels, k), ww,
                   *epilogue(cuda, st.channels,
                             ww if st.first else torch.ones(k),
                             stages[i + 1].kernel ** 2 if pooled else 1)]
        cin = packing.num_words(st.channels)
    ops = k5.chain_operands(stages, tuple(arrays))
    plan = regions.plan_chain_vmem(stages, x.shape, tile=tile)
    kw = dict(tile, arena_offsets=tuple(o // 4 for o in plan.offsets),
              arena_words=plan.arena_bytes // 4)
    return x, ops, kw


@pytest.mark.parametrize("entry,first,stages,tile", CHAIN_CASES)
def test_chain_conv_on_card(cuda, entry, first, stages, tile):
    """K5 against its plain version, at the planner's arena offsets: the
    whole-map tile, and tiles smaller than the map (halo recompute, border
    masking, a padded stride-1 pool, a ragged image block)."""
    x, ops, kw = chain_inputs(cuda, entry, first, stages, tile)
    got = k5.chain_conv(x, stages, ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, k5.chain_conv_plain(x, stages, ops, **kw))
    assert_mixed(got, stages[-1].channels)


@pytest.mark.parametrize("case", [0, 2, 3])
def test_chain_conv_every_cluster_size(cuda, case):
    """The same call at each cluster size the card can schedule gives the
    plain version's words: the output does not depend on the shares."""
    entry, first, stages, tile = CHAIN_CASES[case]
    x, ops, kw = chain_inputs(cuda, entry, first, stages, tile)
    want = k5.chain_conv_plain(x, stages, ops, **kw)
    arena_words = kw["arena_words"]
    assert k5.cluster_size(arena_words) in k5.CLUSTER_SIZES
    sizes = [c for c in k5.CLUSTER_SIZES
             if k5.max_clusters(arena_words, c) >= 1]
    assert k5.cluster_size(arena_words) == sizes[0]
    for c in sizes:
        assert torch.equal(k5.chain_conv(x, stages, ops, cluster=c, **kw),
                           want), c
    with pytest.raises(ValueError, match="cluster of 3"):
        k5.chain_conv(x, stages, ops, cluster=3, **kw)


def test_chain_conv_raises_past_shared_memory(cuda):
    st = (k5.StageSpec("conv", 3, 1, 1, 1, 32),
          k5.StageSpec("pool", 2, 2, 0, 0, 32))
    x = words(cuda, 1, 300, 300, 1)
    ops = k5.chain_operands(st, (words(cuda, 32, 9), None,
                                 *epilogue(cuda, 32, torch.ones(9))))
    with pytest.raises(ValueError, match="shared memory"):
        k5.chain_conv(x, st, ops)


@pytest.mark.parametrize("m,n,w,weighted", [(8, 4096, 288, False),
                                            (37, 50, 13, False),
                                            (130, 96, 968, True),
                                            (1, 33, 70, True)])
def test_xnor_popcount_matmul_on_card(cuda, m, n, w, weighted):
    ww = (torch.from_numpy(RNG.integers(1, 129, w).astype(np.int32)).to(cuda)
          if weighted else None)
    a, b = words(cuda, m, w), words(cuda, n, w)
    got = k1.xnor_popcount_matmul(a, b, ww)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.xnor_popcount_matmul_plain(a, b, ww))


def plane_filters(dev, o: int, taps: int, cw: int, c_real: int):
    """Converter-structured first-layer filters on the card: each tap's
    sign words (pad bits 0) copied into all 8 planes, their plane word
    weights, and the u8 x s8 form built from them."""
    bits = torch.from_numpy(RNG.integers(0, 2, (o, taps, c_real)))
    signs = packing.pack_bits(bits, axis=-1)
    wp = signs[:, :, None].expand(-1, -1, 8, -1).reshape(o, -1)
    wp = wp.contiguous().to(dev)
    ww = bitplanes.plane_word_weights(cw).repeat(taps).to(dev)
    return wp, ww, bitplanes.plane_filters(wp, ww, taps)


PLANE_CONV_CASES = [  # ((N, H, W, C), k, stride, pad, O, pool, pad bits)
    ((8, 227, 227, 3), 11, 4, 0, 96, (3, 2, (0, 0)), False),   # conv1
    ((2, 227, 227, 3), 11, 4, 0, 96, None, False),
    ((2, 416, 416, 3), 3, 1, 1, 16, (2, 2, (0, 0)), False),    # yolo conv1
    ((2, 37, 29, 3), 3, 1, 1, 48, (2, 1, (0, 1)), True),
    ((1, 30, 30, 40), 5, 2, 2, 72, (3, 2, (0, 0)), True),
]


@pytest.mark.parametrize("case", PLANE_CONV_CASES)
def test_direct_conv_planes_on_card(cuda, case):
    """K3's bit-plane variant against its plain version and the generic
    plain K3 on the weighted words, bit for bit."""
    (n, h, w, c), k, st, pad, o, pool, pad_bits = case
    cw = packing.num_words(c)
    if pad_bits:
        x = words(cuda, n, h, w, 8 * cw)
    else:
        img = torch.from_numpy(RNG.integers(0, 256, (n, h, w, c),
                                            dtype=np.uint8)).to(cuda)
        x = k4.bitplane_pack(img).reshape(n, h, w, -1)
    wp, ww, filters = plane_filters(cuda, o, k * k, cw, c)
    thr, sgn = epilogue(cuda, o, ww, pool[0] ** 2 if pool else 1)
    kw = dict(kh=k, kw=k, stride=st, pad=pad, pool=pool)
    got = k3.direct_conv_bn_binarize_planes(x, filters, thr, sgn, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, k3.direct_conv_bn_binarize_planes_plain(
        x, filters, thr, sgn, **kw))
    assert torch.equal(got, k3.direct_conv_bn_binarize_plain(
        x, wp, thr, sgn, word_weights=ww, **kw))


@pytest.mark.parametrize("case", [
    ((8, 27, 27, 96), 5, 1, 2, 256, (3, 2, (0, 0))),     # AlexNet conv2
    ((8, 13, 13, 384), 3, 1, 1, 384, None),              # conv4
    ((2, 13, 13, 256), 3, 1, 1, 512, (2, 1, (0, 1))),    # YOLO conv6
    ((3, 11, 9, 40), 3, 2, 1, 70, (3, 2, (0, 0))),       # ragged O, stride 2
])
def test_direct_conv_mma_on_card(cuda, case):
    """K3 without word weights (the tensor-core kernel) at AlexNet's and
    YOLOv2-Tiny's later convs and a ragged case, input pad bits set."""
    (n, h, w, c), k, st, pad, o, pool = case
    cw = packing.num_words(c)
    args = (words(cuda, n, h, w, cw), words(cuda, o, k * k * cw),
            *epilogue(cuda, o, torch.ones(k * k * cw),
                      pool[0] ** 2 if pool else 1))
    kw = dict(kh=k, kw=k, stride=st, pad=pad, pool=pool)
    got = k3.direct_conv_bn_binarize(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, k3.direct_conv_bn_binarize_plain(*args, **kw))
    assert_mixed(got, o)


@pytest.mark.parametrize("case", [
    ((8, 27, 27, 96), 5, 1, 2, 256, (3, 2, (0, 0))),     # AlexNet conv2
    ((1, 13, 13, 384), 3, 1, 1, 384, None),              # conv4, bucket 1
])
def test_direct_conv_every_tuned_tile_on_card(cuda, case):
    """K3 at each tile the autotuner sweeps (``plan_mma``'s pick and the
    next three by its model), forced through the wrapper's ``tile``: the
    planner's output, bit for bit."""
    (n, h, w, c), k, st, pad, o, pool = case
    cw = packing.num_words(c)
    args = (words(cuda, n, h, w, cw), words(cuda, o, k * k * cw),
            *epilogue(cuda, o, torch.ones(k * k * cw),
                      pool[0] ** 2 if pool else 1))
    kw = dict(kh=k, kw=k, stride=st, pad=pad, pool=pool)
    want = k3.direct_conv_bn_binarize(*args, **kw)
    _, _, fh, fw = k3.conv_geometry(h, w, k, k, st, pad, pool)
    cands = sorted(k3.mma_candidates(n, fh, fw, o, kh=k, kw=k, stride=st,
                                     cw=cw, pool=pool, planes=False,
                                     limits=k3.mma_limits(cuda)),
                   key=lambda c: c[0])[:4]
    for _, plan in cands:
        tile = (plan.tile_h, plan.tile_w, plan.nw_block)
        assert torch.equal(k3.direct_conv_bn_binarize(*args, **kw,
                                                      tile=tile), want)
    with pytest.raises(ValueError, match="not a candidate"):
        k3.direct_conv_bn_binarize(*args, **kw, tile=(99, 1, 1))


@pytest.mark.parametrize("name", ["alexnet_imagenet", "vgg16_imagenet",
                                  "yolov2_tiny_voc"])
def test_auto_engine_on_card(cuda, name, tmp_path, monkeypatch):
    """``matmul_mode="auto"`` on the card: the tuned graph equals
    ``cross_check``, no node is won by a plain backend, every K3 node
    carries its tile, and bucket 1 reuses bucket 2's winners."""
    from repro_torch.obs import metrics
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    wl = workloads.get(name, variant="tiny", matmul_mode="auto")
    eng = wl.engine.engine
    h, w = wl.input_hw
    x = torch.from_numpy(RNG.integers(0, 256, (2, h, w, 3),
                                      dtype=np.uint8)).to(cuda)
    eng.cross_check(x)
    with metrics.use_registry() as reg:
        eng.cross_check(x[:1])
    # Nothing re-timed: transfers, and plain hits for a node identical to
    # an earlier one of the graph.
    seen = {e["outcome"] for e in reg.events("autotune")}
    assert "xfer_hit" in seen and seen <= {"xfer_hit", "hit"}
    rows = eng.backend_choices
    assert rows and not {r["backend"] for r in rows} & {"torch",
                                                        "torch_pm1"}
    for r in rows:
        if r["backend"] in ("cuda_direct", "cuda_direct_pool"):
            assert set(r["tile"]) == {"tile_h", "tile_w", "nw_block"}


@pytest.mark.parametrize("m,taps,cw,o", [(24200, 121, 1, 96), (84, 9, 1, 33),
                                         (8, 9, 2, 130)])
def test_xnor_popcount_matmul_planes_on_card(cuda, m, taps, cw, o):
    """K1's bit-plane variant at conv1's im2col rows, a ragged case and two
    words a plane, every bit of the rows random."""
    a = words(cuda, m, taps * 8 * cw)
    wp, ww, filters = plane_filters(cuda, o, taps, cw, 32 * cw - 3)
    got = k1.xnor_popcount_matmul_planes(a, filters, cw)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.xnor_popcount_matmul_planes_plain(
        a, filters, cw))
    assert torch.equal(got, k1.xnor_popcount_matmul_plain(a, wp, ww))


def test_plane_variant_refuses_filters_whose_planes_differ(cuda):
    """The bit-plane form is built from the converter's structure or not
    at all: an executor whose first layer's planes differ raises when it
    is built, and a wrapper handed operands of the wrong shape raises —
    neither falls back to the weighted kernel."""
    wl = workloads.get("alexnet_imagenet", variant="tiny")
    graph = wl.engine.engine._graph.copy()
    first = next(n for n in graph.nodes.values() if n.attrs.get("first")
                 and n.op.startswith("packed"))
    w = first.params["w_packed"].clone()
    w[0, 1] ^= 1
    first.params = dict(first.params, w_packed=w)
    before = (k3.direct_conv_bn_binarize.launches,
              k3.direct_conv_bn_binarize_planes.launches)
    with pytest.raises(ValueError, match="planes of a tap differ"):
        GraphExecutor(graph, "cuda_direct_pool")
    _, _, filters = plane_filters(cuda, 32, 9, 1, 3)
    thr, sgn = epilogue(cuda, 32, torch.ones(9))
    with pytest.raises(ValueError):
        k3.direct_conv_bn_binarize_planes(words(cuda, 1, 8, 8, 16), filters,
                                          thr, sgn, kh=3, kw=3, pad=1)
    with pytest.raises(ValueError):
        k1.xnor_popcount_matmul_planes(words(cuda, 4, 9 * 8 * 2), filters)
    assert (k3.direct_conv_bn_binarize.launches,
            k3.direct_conv_bn_binarize_planes.launches) == before


def test_mma_limits_read_from_the_card(cuda):
    """K3's tile planner reads its limits from the card: the SM count and
    the opt-in shared memory a block (the region budget's value on an
    H100)."""
    limits = k3.mma_limits(cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert limits.sms == props.multi_processor_count
    assert limits.smem_block == regions.DEFAULT_SMEM_BUDGET


def test_engine_default_path_takes_the_plane_variant(cuda):
    """Paper AlexNet on the engine's default path (cuda_direct_pool): conv1
    is the one launch of K3's bit-plane variant a forward, and the output
    equals the flat oracle."""
    wl = workloads.get("alexnet_imagenet")
    assert wl.engine.engine.matmul_mode == "cuda_direct_pool"
    x = torch.from_numpy(RNG.integers(0, 256, (2, 227, 227, 3),
                                      dtype=np.uint8)).to(cuda)
    assert captured_launches(wl.engine.engine.cross_check, x, (
        k3.direct_conv_bn_binarize_planes, k3.direct_conv_bn_binarize,
        k1.xnor_popcount_matmul_planes)) == (1, 4, 0)


def channel_words(dev, rows: int, channels: int, positions: int
                  ) -> torch.Tensor:
    """im2col-shaped rows: ``positions`` packed groups of ``channels``
    random real bits each, pad bits 0."""
    bits = torch.from_numpy(RNG.integers(0, 2, (rows, positions, channels)))
    return packing.pack_bits(bits, axis=-1).reshape(rows, -1).to(dev)


@pytest.mark.parametrize("m,n,c,pos", [(5832, 256, 96, 25),
                                       (8, 4096, 9216, 1),
                                       (8, 4096, 4096, 1),
                                       (1, 4096, 9216, 1),
                                       (7, 9, 16, 9), (65, 70, 40, 3),
                                       (3, 5, 32, (1 << 19) + 1)])
def test_mxu_pm1_matmul_on_card(cuda, m, n, c, pos):
    """K6 against its plain version: AlexNet's conv2, fc6 and fc7, batch 1
    at fc6, pad bits in every word, ragged tiles, and k_valid past 2^24
    (where a float32 accumulation is no longer exact)."""
    a, b = channel_words(cuda, m, c, pos), channel_words(cuda, n, c, pos)
    got = k6.mxu_pm1_matmul(a, b, c * pos)
    torch.cuda.synchronize()
    assert torch.equal(got, k6.mxu_pm1_matmul_plain(a, b, c * pos))


@pytest.mark.parametrize("m,n,w", [(8, 4096, 128), (40, 100, 13),
                                   (3, 48, 9)])
def test_pm1_every_plan_on_card(cuda, m, n, w):
    """Every tile and cluster split of the +-1 mainloop
    (``pm1_gemm.TILES``), K6's and K2's epilogues, against the plain
    versions."""
    a, b = words(cuda, m, w), words(cuda, n, w)
    thr, sgn = epilogue(cuda, n, torch.ones(w))
    dot = k6.mxu_pm1_matmul_plain(a, b, 32 * w)
    packed = k2.fused_matmul_bn_binarize_plain(a, b, thr, sgn)
    lib, stream = build.library(), build.stream_ptr(cuda)
    units = w // pm1_gemm.granule(w)
    for tile, t in enumerate(pm1_gemm.TILES):
        if t.swap and m > t.by:
            continue
        for cluster in (1, 2, 4, 8):
            if cluster > units:
                continue
            out = torch.full_like(dot, -1)
            build.check(lib.launch_mxu_pm1_matmul(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, w, 0,
                tile, cluster, stream), "mxu_pm1_matmul")
            words_out = torch.full_like(packed, -1)
            build.check(lib.launch_fused_matmul_bn_binarize_pm1(
                a.data_ptr(), b.data_ptr(), thr.data_ptr(), sgn.data_ptr(),
                words_out.data_ptr(), m, n, w, tile, cluster, stream),
                "fused_matmul_bn_binarize")
            torch.cuda.synchronize()
            plan = (tile, cluster)
            assert torch.equal(out, dot), plan
            assert torch.equal(words_out, packed), plan


def test_pm1_refuses_an_empty_slice(cuda):
    """A cluster larger than the word axis has units is refused at launch,
    not run."""
    a, b = words(cuda, 8, 3), words(cuda, 64, 3)
    out = torch.empty((8, 64), dtype=torch.int32, device=cuda)
    err = build.library().launch_mxu_pm1_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), 8, 64, 3, 0,
        pm1_gemm.SWAP_8, 4, build.stream_ptr(cuda))
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(err, "mxu_pm1_matmul")


@pytest.mark.parametrize("transform", [
    lambda x: preprocess.center_crop_resize(x, (227, 227)),
    lambda x: preprocess.letterbox(x, (416, 416))])
def test_preprocess_hook_on_card_matches_cpu(cuda, transform):
    img = RNG.integers(0, 256, (375, 500, 3), dtype=np.uint8)
    got = preprocess.as_server_hook(transform, cuda)(img)
    want = preprocess.as_server_hook(transform, "cpu")(img)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    # Float rounding may move a value near .5 across the rounding point.
    assert (got.cpu().int() - want.int()).abs().max() <= 1


@pytest.mark.parametrize("backend", ["cuda_direct_pool", "cuda_popcount",
                                     "cuda_chain", "cuda_pm1"])
@pytest.mark.parametrize("name", ["alexnet_imagenet", "vgg16_imagenet",
                                  "yolov2_tiny_voc"])
def test_tiny_workload_on_card_matches_cpu(cuda, name, backend):
    params = workloads.checkpoint_params(
        workloads.get(name, variant="tiny", device="cpu").spec, 5)
    on_cpu = workloads.get(name, variant="tiny", device="cpu",
                           matmul_mode="torch", params=params)
    on_card = workloads.get(name, variant="tiny", matmul_mode=backend,
                            params=params)
    h, w = on_cpu.input_hw
    x = torch.from_numpy(RNG.integers(0, 256, (3, h, w, 3), dtype=np.uint8))
    want = on_cpu.engine.raw(x)
    raw = on_card.engine.engine.cross_check(x.to(cuda))   # graph == flat
    torch.testing.assert_close(raw.cpu(), want, rtol=0, atol=1e-4)
    rows = on_card.postprocess(raw).cpu()
    ref = on_cpu.postprocess(want)
    idx = 0 if on_cpu.task == "classify" else 5
    assert torch.equal(rows[..., idx], ref[..., idx])


def test_tiny_alexnet_launch_counts(cuda):
    wl = workloads.get("alexnet_imagenet", variant="tiny")
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    # conv1 through K3's bit-plane variant, conv2 through K3.
    assert captured_launches(wl.engine, x, (
        k4.bitplane_pack, k3.direct_conv_bn_binarize,
        k3.direct_conv_bn_binarize_planes,
        k2.fused_matmul_bn_binarize)) == (1, 1, 1, 2)


def test_tiny_alexnet_chain_launch_counts(cuda):
    """Under cuda_chain the two convs and their pools are one K5 launch."""
    wl = workloads.get("alexnet_imagenet", variant="tiny",
                       matmul_mode="cuda_chain")
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    # Built first: the build times the region's tiles, launches that are
    # not the forward's.
    wl.engine.engine.compile(2, capture=False)
    assert captured_launches(wl.engine, x, (
        k4.bitplane_pack, k5.chain_conv, k2.fused_matmul_bn_binarize,
        k3.direct_conv_bn_binarize)) == (1, 1, 2, 0)


def test_tiny_alexnet_pm1_launch_counts(cuda):
    """Under cuda_pm1 the bit-plane conv takes K1's bit-plane variant and
    every other binary layer K6."""
    wl = workloads.get("alexnet_imagenet", variant="tiny",
                       matmul_mode="cuda_pm1")
    x = torch.zeros((2, 16, 16, 3), dtype=torch.uint8, device=cuda)
    assert captured_launches(wl.engine.engine.cross_check, x, (
        k4.bitplane_pack, k1.xnor_popcount_matmul,
        k1.xnor_popcount_matmul_planes, k6.mxu_pm1_matmul,
        k2.fused_matmul_bn_binarize,
        k3.direct_conv_bn_binarize)) == (1, 0, 1, 3, 0, 0)


@pytest.mark.parametrize("name", ["alexnet_imagenet", "yolov2_tiny_voc"])
def test_trained_graph_on_card_matches_cpu(cuda, name):
    """The unfused trained-params graph on the card (K1 for every count
    node, the first conv's through its bit-plane variant) equals the same
    graph on the CPU and its fused pipeline graph."""
    spec = workloads.get(name, variant="tiny", device="cpu").spec
    hw = workloads.get(name, variant="tiny", device="cpu").input_hw
    params = workloads.checkpoint_params(spec, 4)
    unfused = assign_layouts(lower_trained(spec, params, hw))
    fused = default_pipeline(lower_trained(spec, params, hw))
    x = torch.from_numpy(RNG.integers(0, 256, (2, *hw, 3), dtype=np.uint8))
    want = GraphExecutor(unfused)(x)
    k1.xnor_popcount_matmul.launches = 0
    k1.xnor_popcount_matmul_planes.launches = 0
    got = GraphExecutor(unfused.to(cuda))(x.to(cuda))
    torch.cuda.synchronize()
    counts = sum(n.op in ("conv_counts", "dense_counts")
                 for n in unfused.nodes.values())
    assert (k1.xnor_popcount_matmul.launches,
            k1.xnor_popcount_matmul_planes.launches) == (counts - 1, 1)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    fused_out = GraphExecutor(fused.to(cuda), "cuda_direct_pool")(x.to(cuda))
    torch.testing.assert_close(fused_out.cpu(), want, rtol=0, atol=1e-4)


# K7 against its plain version: the two round p to bf16 under different
# running maxima (128-key tiles against the plain version's blocks) and
# round the output once each, so they agree to a few bf16 steps (2^-8
# relative): 1e-2 absolute + 1e-2 relative.
K7_TOL = 1e-2


@pytest.mark.parametrize("b,s,h,kvh,hd,causal", [
    (2, 512, 8, 2, 128, True),
    (1, 256, 4, 4, 128, False),     # G = 1, non-causal
    (2, 64, 8, 2, 128, True),       # one tile
    (1, 100, 4, 1, 128, True),      # ragged last tile
    (1, 192, 4, 2, 128, True),
    (1, 129, 4, 2, 128, True),      # one full 128-row tile and one row
    (1, 256, 4, 4, 128, True),      # G = 1, two full tiles
    (2, 512, 16, 2, 128, True),     # G = 8 (qwen3, command-r)
    (1, 100, 16, 2, 128, True),     # G = 8, ragged last tile
    (1, 256, 16, 2, 64, True),      # hd 64, G = 8
    (2, 512, 6, 2, 64, True),       # head width 64 (granite), G = 3
    (1, 100, 4, 1, 64, True),       # hd 64, ragged last tile
    (1, 129, 4, 4, 64, False),      # hd 64, G = 1, non-causal
    (2, 197, 16, 16, 64, False),    # ViT-L/16's layer, non-causal, G = 1
    # the padded widths (the hd-128 tiles over zero-filled columns):
    # ViT-H/14's layer (hd 80, S 257 at 224, 730 at 384, ragged against
    # the 128-row tiles), DiT-XL/2's (hd 72, S 256 and gen_1024's 4096),
    # non-causal with G = 1, and causal once
    (2, 257, 16, 16, 80, False),
    (1, 730, 16, 16, 80, False),
    (2, 256, 16, 16, 72, False),
    (1, 4096, 16, 16, 72, False),
    (1, 100, 4, 4, 72, False),      # hd 72, ragged S 100
    (1, 100, 8, 2, 80, True),       # hd 80, causal, G = 4
])
def test_flash_attention_on_card(cuda, b, s, h, kvh, hd, causal):
    q, k, v = (torch.from_numpy(RNG.standard_normal(shape)
                                .astype(np.float32)).to(cuda, torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kvh, hd),
                             (b, s, kvh, hd)))
    k7.flash_attention.launches = 0
    # the kernel tiles by 128 whatever the blocks: 48 divides no S but 192
    got = k7.flash_attention(q, k, v, causal, block_q=48, block_k=48)
    torch.cuda.synchronize()
    assert k7.flash_attention.launches == 1
    assert got.dtype == torch.bfloat16
    want = k7.flash_attention_plain(q, k, v, causal, plain_blocks(s),
                                    plain_blocks(s))
    torch.testing.assert_close(got.float(), want.float(), rtol=K7_TOL,
                               atol=K7_TOL)


@pytest.mark.parametrize("sq,skv", [(100, 300), (300, 100), (128, 129)])
def test_flash_attention_on_card_sq_ne_skv(cuda, sq, skv):
    """Non-causal with Sq != Skv: the q and key tiles are ragged apart."""
    q = torch.from_numpy(RNG.standard_normal((1, sq, 4, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k, v = (torch.from_numpy(RNG.standard_normal((1, skv, 2, 128)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(2))
    got = k7.flash_attention(q, k, v, False)
    torch.cuda.synchronize()
    want = k7.flash_attention_plain(q, k, v, False)
    torch.testing.assert_close(got.float(), want.float(), rtol=K7_TOL,
                               atol=K7_TOL)


def test_flash_attention_rejects_what_the_kernel_cannot_take(cuda):
    for hd in (32, 96):          # no instantiation, and no padded width
        q = torch.zeros((1, 64, 2, hd), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match=r"hd in \(64, 72, 80, 128\)"):
            k7.flash_attention(q, q, q)
        with pytest.raises(ValueError, match=r"hd in \(64, 72, 80, 128\)"):
            k7.flash_attention_bwd(q, q, q, q, torch.zeros(
                (1, 2, 64), device=cuda), q, False)
    q = torch.zeros((1, 64, 2, 128), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        k7.flash_attention(q, q, q)
    buf = torch.zeros(64 * 2 * 128 + 1, dtype=torch.bfloat16, device=cuda)
    q = buf[1:].view(1, 64, 2, 128)         # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        k7.flash_attention(q, q, q)


# K7b against its plain version: |kernel - plain| <= tol·(1 + |plain|) for
# each of dq, dk and dv, and the same against autograd of the float32
# ``reference_attention``.  Both versions round p and dS to bf16 before
# their products and the outputs once, but the kernel sums in 16-wide
# wgmma steps over 64-row, 128-key tiles (dq over the key tiles in a fixed
# order) where the plain version takes whole blocks, so they agree to a
# few bf16 steps (2^-8 relative) of the gradients' scale.
K7B_TOL = 2e-2


def k7b_operands(cuda, b, sq, skv, h, kvh, hd):
    return tuple(torch.from_numpy(RNG.standard_normal(shape)
                                  .astype(np.float32)).to(cuda,
                                                          torch.bfloat16)
                 for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                               (b, skv, kvh, hd), (b, sq, h, hd)))


def plain_blocks(s: int) -> int:
    """A block of the plain versions that divides S: 512 cut to S, else
    128, else S itself (ViT-H/14's 730)."""
    return 512 if s <= 512 or s % 512 == 0 else 128 if s % 128 == 0 else s


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal", [
    (2, 512, 512, 12, 4, 64, True),     # lm-100m's layer, two rows of it
    (1, 512, 512, 32, 8, 128, True),    # minitron-8b's layer at S 512
    (1, 100, 100, 12, 4, 64, True),     # ragged last tile
    (1, 129, 129, 8, 8, 128, False),    # G = 1, non-causal, a tile and a row
    (2, 200, 200, 4, 4, 128, True),     # causal, ragged at hd 128
    (1, 2048, 2048, 32, 8, 128, True),  # minitron-8b's prefill layer
    (1, 100, 300, 12, 4, 64, False),    # non-causal, Sq != Skv
    (1, 640, 640, 16, 4, 64, True),     # G = 4, 5 key tiles: dq's order
    (2, 197, 197, 16, 16, 64, False),   # ViT-L/16's layer
    # the padded widths: ViT-H/14's layer (hd 80) at S 257 and 730,
    # DiT-XL/2's (hd 72), ragged S 100, non-causal with G = 1
    (2, 257, 257, 16, 16, 80, False),
    (1, 730, 730, 16, 16, 80, False),
    (2, 256, 256, 16, 16, 72, False),
    (1, 100, 100, 4, 4, 72, False),
])
def test_flash_attention_bwd_on_card(cuda, b, sq, skv, h, kvh, hd, causal):
    q, k, v, do = k7b_operands(cuda, b, sq, skv, h, kvh, hd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k7.flash_attention.launches = k7.flash_attention_bwd.launches = 0
    out = k7.flash_attention(*leaves, causal)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (k7.flash_attention.launches,
            k7.flash_attention_bwd.launches) == (1, 1)
    # the plain backward on the same forward output and lse
    blocks = (plain_blocks(sq), plain_blocks(skv))
    o, lse = k7.flash_attention_plain(q, k, v, causal, *blocks,
                                      return_lse=True)
    want = k7.flash_attention_bwd_plain(q, k, v, out.detach(), lse, do,
                                        causal, *blocks)
    f32 = [t.float().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(
        layers.reference_attention(*f32, causal=causal), f32,
        do.float())
    for g, w, r in zip(got, want, ref):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), w.float(), rtol=K7B_TOL,
                                   atol=K7B_TOL)
        torch.testing.assert_close(g.float(), r, rtol=K7B_TOL, atol=K7B_TOL)


@pytest.mark.parametrize("b,s,h,kvh,hd", [
    (1, 640, 16, 4, 64),                # 5 key tiles a (b, KV head)
    (2, 512, 32, 8, 128),               # 4 key tiles, two dq blocks a row
    (1, 730, 16, 16, 80),               # hd 80: the second block ragged
    (1, 300, 8, 8, 72),                 # hd 72
])
def test_flash_attention_bwd_is_deterministic(cuda, b, s, h, kvh, hd):
    """dq is summed over the key tiles in a fixed order and dk, dv in one
    block's registers: two calls on the same inputs give the same bits."""
    q, k, v, do = k7b_operands(cuda, b, s, s, h, kvh, hd)
    out, lse = k7.flash_attention_fwd(q, k, v, True)
    first = k7.flash_attention_bwd(q, k, v, out, lse, do, True)
    second = k7.flash_attention_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_flash_attention_bwd_launches_two_kernels(cuda):
    """One K7b call is two device launches: the D pre-pass and the main
    kernel (torch.profiler's device records), and one wrapper count."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do = k7b_operands(cuda, 2, 512, 512, 12, 4, 64)
    out, lse = k7.flash_attention_fwd(q, k, v, True)
    k7.flash_attention_bwd(q, k, v, out, lse, do, True)      # warm-up
    torch.cuda.synchronize()
    k7.flash_attention_bwd.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        k7.flash_attention_bwd(q, k, v, out, lse, do, True)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU
               and "flash_bwd" in e.key}
    assert sorted(n for n in kernels.values()) == [1, 1], kernels
    assert any("flash_bwd_dot_kernel" in n for n in kernels)
    assert any("flash_bwd_main_kernel" in n for n in kernels)
    assert k7.flash_attention_bwd.launches == 1


def test_flash_attention_serving_launch_unchanged(cuda):
    """Without autograd the call launches the forward alone (no lse), and
    its output equals the one the Function saves, bit for bit."""
    q, k, v = (torch.from_numpy(RNG.standard_normal(shape).astype(
        np.float32)).to(cuda, torch.bfloat16)
        for shape in ((2, 256, 12, 64), (2, 256, 4, 64), (2, 256, 4, 64)))
    k7.flash_attention.launches = k7.flash_attention_bwd.launches = 0
    with torch.inference_mode():
        served = k7.flash_attention(q, k, v, True)
    plain_grad_off = k7.flash_attention(q, k, v, True)     # no input needs it
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    trained = k7.flash_attention(*leaves, True)
    torch.cuda.synchronize()
    assert served.grad_fn is None and plain_grad_off.grad_fn is None
    assert trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
    assert torch.equal(served, plain_grad_off)
    assert (k7.flash_attention.launches,
            k7.flash_attention_bwd.launches) == (3, 0)


def test_lm100m_train_step_on_card(cuda):
    """One lm-100m train step at full width (B 2, S 512) through K7 and K7b
    (K7 twice a layer: the forward and the remat's recompute; K7b once):
    a finite loss and gradient norm, within 1e-3 relative of a second run
    from the same state (the embedding's backward accumulates with atomics,
    so the two need not be equal bit for bit)."""
    from repro_torch.launch.train import LM_100M
    from repro_torch.optim import adamw_init

    cfg = LM_100M
    params = transformer.init_params(cfg, torch.Generator(cuda)
                                     .manual_seed(0), cuda,
                                     dtype=torch.float32)
    opt = adamw_init(params)
    step = transformer.make_train_step(cfg)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 513)).astype(
        np.int32)).to(cuda)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    k7.flash_attention.launches = k7.flash_attention_bwd.launches = 0
    runs = [step(params, opt, batch)[2] for _ in range(2)]
    torch.cuda.synchronize()
    assert (k7.flash_attention.launches,
            k7.flash_attention_bwd.launches) == (4 * cfg.n_layers,
                                                 2 * cfg.n_layers)
    for key in ("loss", "grad_norm"):
        a, b = (float(m[key]) for m in runs)
        assert np.isfinite(a) and abs(a - b) <= 1e-3 * abs(a), (key, a, b)
    assert 9.0 < float(runs[0]["loss"]) < 12.0     # ~ln 32768 at init


LM_CFG = dict(name="gpu-lm", n_layers=2, d_model=256, n_heads=4,
              n_kv_heads=2, d_head=128, d_ff=512, vocab=1000,
              rope_theta=10_000.0, mlp_act="relu2")


@pytest.fixture
def lm_params(cuda):
    cfg = transformer.LMConfig(**LM_CFG)
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    return cfg, cpu, {k: ({n: t.to(cuda) for n, t in v.items()}
                          if isinstance(v, dict) else v.to(cuda))
                      for k, v in cpu.items()}


def test_lm_prefill_on_card_matches_cpu(cuda, lm_params):
    """A 2-layer prefill on the card (K7 once a layer) against the same
    prefill on the CPU (K7's plain version), within bf16 rounding."""
    cfg, cpu, card = lm_params
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 128)))
    step = transformer.make_prefill_step(cfg, 160)
    k7.flash_attention.launches = 0
    logits, cache = step(card, toks.to(cuda))
    torch.cuda.synchronize()
    assert k7.flash_attention.launches == cfg.n_layers
    want, want_cache = step(cpu, toks)
    scale = want.float().abs().max()
    assert (logits.cpu().float() - want.float()).abs().max() <= 2e-2 * scale
    for name in ("k", "v"):
        ref = want_cache[name].float()
        err = (cache[name].cpu().float() - ref).abs().max()
        assert err <= 2e-2 * ref.abs().max()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "granite-moe-3b-a800m"])
def test_moe_decode_on_card(cuda, arch):
    """An MoE arch's SMOKE at the published capacity factor (1.25, so
    tokens drop): the captured decode step's logits equal the eager
    step's bit for bit, and the MoE layer on the card equals the same
    layer on the CPU within bf16 rounding."""
    cfg = dataclasses.replace(configs.get(arch).smoke, capacity_factor=1.25)
    params = transformer.init_params(cfg, torch.Generator(device=cuda)
                                     .manual_seed(0), cuda)
    logits = {}
    for capture in (True, False):
        server = LMServer(cfg, params, n_slots=4, max_seq=32,
                          capture=capture)
        run, seen = server._run_decode, []
        server._run_decode = lambda pos: seen.append(run(pos).clone()) \
            or seen[-1]
        server.generate([1, 2, 3], max_new=5)
        logits[capture] = torch.stack(seen)
    assert torch.equal(logits[True], logits[False])
    # the MoE layer on the card against the same layer on the CPU: the
    # same routing, drops and (within bf16 rounding) outputs
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    lay = {n: t[0] for n, t in params["layers"].items()}
    experts = [lay[n] for n in ("router", "we_gate", "we_up", "we_down")]
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=1.25, act=cfg.mlp_act)
    got, _ = moe.moe_apply(x.to(cuda), *experts, **kw)
    want, _ = moe.moe_apply(x, *(t.cpu() for t in experts), **kw)
    scale = want.float().abs().max()
    assert (got.cpu().float() - want.float()).abs().max() <= 2e-2 * scale


def sharded_lm_rank(rank, device, cfg, cpu, toks, teacher):
    """One of 2 ranks sharing the card: the SMOKE-size LM's shards, its
    sharded prefill (K7 on the rank's 2 heads) and decode steps."""
    from repro_torch.distributed.sharding import rules_for_mesh, shard_tree
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=1, model=2, device=device)
    rules = rules_for_mesh(mesh)
    params = tree.tree_map(lambda t: t.to(device), shard_tree(
        cpu, transformer.param_specs(cfg, rules), rules))
    k7.flash_attention.launches = 0
    logits, cache = transformer.make_prefill_step(cfg, 160, rules)(
        params, toks.to(device))
    launches = k7.flash_attention.launches
    decode = transformer.make_decode_step(cfg, 160, rules)
    steps = [logits.float().cpu()]
    for i, tok in enumerate(teacher):
        logits, cache = decode(params, cache, tok.to(device), 128 + i)
        steps.append(logits.float().cpu())
    return (mesh.backend, mesh.staged, launches,
            k7.flash_attention.launches, torch.stack(steps))


def test_sharded_lm_on_card(cuda, lm_params):
    """2 ranks on cuda:0 (gloo, collectives through pinned host memory):
    the sharded prefill and 4 decode steps against the one-device path on
    the card, within the chip smoke's 4e-2 of the logits' scale; K7 once
    a layer a rank at prefill, never at decode."""
    from repro_torch.launch.mesh import spawn

    cfg, cpu, card = lm_params
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 128)))
    teacher = torch.from_numpy(RNG.integers(0, cfg.vocab, (4, 2, 1)))
    logits, cache = transformer.make_prefill_step(cfg, 160)(card,
                                                            toks.to(cuda))
    want = [logits.float().cpu()]
    decode = transformer.make_decode_step(cfg, 160)
    for i, tok in enumerate(teacher):
        logits, cache = decode(card, cache, tok.to(cuda), 128 + i)
        want.append(logits.float().cpu())
    want = torch.stack(want)
    ranks = spawn(sharded_lm_rank, 2, cfg, cpu, toks, teacher,
                  device="cuda", timeout_s=300)
    for backend, staged, prefill_k7, total_k7, got in ranks:
        assert (backend, staged) == ("gloo", True)
        assert prefill_k7 == total_k7 == cfg.n_layers
        assert (got - want).abs().max() <= 4e-2 * want.abs().max()
        assert torch.equal(got, ranks[0][-1])


def sharded_train_rank(rank, device, cfg, cpu, batch):
    """One of 2 ranks sharing the card: the narrow LM's gradient and one
    train step on (1, 2) (TP: the row-parallel products' backward on
    CUDA, K7b on the rank's 2 heads)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh

    rules = sharding.rules_for_mesh(make_host_mesh(data=1, model=2,
                                                   device=device))
    specs = transformer.param_specs(cfg, rules)
    params = tree.tree_map(lambda t: t.to(device),
                           sharding.shard_tree(cpu, specs, rules))
    batch = {k: v.to(device) for k, v in batch.items()}
    (_, _), grads = tree.value_and_grad(transformer.loss_fn, params, batch,
                                        cfg, rules)
    grads = sharding.sync_grads(grads, specs, rules)
    full = [sharding.gather(g, s, rules).cpu()
            for g, s in zip(tree.leaves(grads), tree.leaves(specs))]
    k7.flash_attention_bwd.launches = 0
    _, _, m = transformer.make_train_step(cfg, rules, lr=1e-3)(
        params, optim.adamw_init(params), batch)
    return (m["loss"].item(), m["grad_norm"].item(), full,
            k7.flash_attention_bwd.launches)


def test_sharded_train_step_on_card(cuda, lm_params):
    """2 ranks on cuda:0 (gloo, staged): the sharded gradient and train
    step of the narrow LM (float32 masters) against the one-device step on
    the card: the loss within 2e-3, the gradient norm within 1e-2 and
    every gathered gradient leaf within 2e-2 relative L2 (the chip
    smoke's limits); K7b once a layer a rank."""
    from repro_torch.launch.mesh import spawn

    cfg = lm_params[0]
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu", dtype=torch.float32)
    card = tree.tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 129))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    (_, _), want = tree.value_and_grad(transformer.loss_fn, card, on_card,
                                       cfg)
    _, _, m = transformer.make_train_step(cfg, lr=1e-3)(
        card, optim.adamw_init(card), on_card)
    loss, gnorm = m["loss"].item(), m["grad_norm"].item()
    ranks = spawn(sharded_train_rank, 2, cfg, cpu, batch, device="cuda",
                  timeout_s=300)
    for got_loss, got_norm, grads, k7b in ranks:
        assert abs(got_loss - loss) <= 2e-3 * loss
        assert abs(got_norm - gnorm) <= 1e-2 * gnorm
        assert k7b == cfg.n_layers
        for g, w in zip(grads, tree.leaves(want)):
            w = w.float().cpu()
            assert (g - w).norm() <= 2e-2 * w.norm()


def test_lm_server_on_card(cuda, lm_params):
    """LMServer on the card serves every request; decoding launches no K7."""
    cfg, _, card = lm_params
    server = LMServer(cfg, card, n_slots=2, max_seq=64)
    k7.flash_attention.launches = 0
    reqs = [server.submit(list(RNG.integers(1, cfg.vocab, n)), max_new=m)
            for n, m in ((5, 3), (8, 4), (3, 2))]
    server.drain()
    assert all(r.outcome == "served" and len(r.result) == m
               for r, m in zip(reqs, (3, 4, 2)))
    assert k7.flash_attention.launches == 0
    assert server.metrics()["served"] == 3


# --------------------------------------------------------------------------
# Captured buckets, artifacts, the multiplexer and the captured decode step
# --------------------------------------------------------------------------

CAPTURE_MODES = ["cuda_direct_pool", "cuda_chain", "cuda_pm1",
                 "cuda_popcount", "auto"]


@pytest.mark.parametrize("mode", CAPTURE_MODES)
@pytest.mark.parametrize("name", ["alexnet_imagenet", "yolov2_tiny_voc"])
def test_captured_bucket_equals_eager(cuda, name, mode, tmp_path,
                                      monkeypatch):
    """Every mode and bucket: the captured graph's rows and raw output
    equal the eager executor's and head's bit for bit, the raw equals the
    flat oracle (``cross_check``), and replays capture nothing more."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    wl = workloads.get(name, variant="tiny", matmul_mode=mode)
    h, w = wl.input_hw
    for b in (1, 2, 4):
        x = torch.from_numpy(RNG.integers(0, 256, (b, h, w, 3),
                                          dtype=np.uint8)).to(cuda)
        exe = wl.engine.compile(b)
        assert isinstance(exe, CapturedExecutor)
        rows, raw = exe.run(x)
        eager = wl.engine.engine.compile(b, capture=False)(x)
        assert torch.equal(raw, eager)
        assert torch.equal(rows, wl.postprocess(eager))
        assert torch.equal(wl.engine(x), rows)
        wl.engine.cross_check(x)
    captures = wl.engine.capture_count
    assert captures == 3
    wl.engine(x)
    assert wl.engine.capture_count == captures


def test_captured_server_on_card(cuda):
    """Mixed-size traffic through captured buckets: every row equals
    ``cross_check``, and nothing is built or captured while serving."""
    wl = workloads.get("yolov2_tiny_voc", variant="tiny")
    server = wl.server(max_batch=4, buckets=(1, 2, 4))
    server.compile_buckets()
    builds, captures = wl.engine.build_count, wl.engine.capture_count
    assert captures == 3
    imgs = [RNG.integers(0, 256, (40, 50, 3), dtype=np.uint8)
            for _ in range(7)]
    groups, served = [], 0
    for g in (1, 2, 4):
        batch = imgs[served:served + g]
        reqs = [server.submit(im) for im in batch]
        server.drain()
        served += g
        pad = server.scheduler.bucket_for(g) - g
        groups.append((reqs, batch + [np.zeros_like(batch[-1])] * pad))
    assert (wl.engine.build_count, wl.engine.capture_count) == \
        (builds, captures)
    for reqs, padded in groups:
        x = torch.stack([wl.preprocess_hook(p) for p in padded])
        ref = wl.engine.cross_check(x).cpu().numpy()
        for r, want in zip(reqs, ref):
            assert r.outcome == "served"
            np.testing.assert_array_equal(r.result, want)


@pytest.mark.parametrize("capture", [None, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_server_refuses_a_payload_of_another_dtype(cuda, dtype, capture):
    """A payload of the input's shape but not uint8 resolves ``error``,
    captured as eager: staging refuses its row (a copy into the static
    input would cast it), alone, once its retries are spent; the uint8
    payload after it is served and no bucket demotes."""
    wl = workloads.get("alexnet_imagenet", variant="tiny")
    server = wl.server(preprocess=None, max_batch=1, buckets=(1,),
                       capture=capture)
    img = RNG.integers(0, 256, (*wl.input_hw, 3), dtype=np.uint8)
    bad = server.submit(img.astype(dtype) * (1 if dtype == np.float32
                                             else 300))
    good = server.submit(img)
    server.drain()
    assert bad.outcome == "error"
    assert good.outcome == "served"
    assert server.metrics()["degraded"] == 0
    np.testing.assert_array_equal(
        good.result,
        wl.engine.cross_check(torch.from_numpy(img[None])).cpu().numpy()[0])


@pytest.mark.parametrize("mode", ["cuda_direct_pool", "cuda_chain", "auto"])
def test_artifact_load_captures_on_card(cuda, mode, tmp_path, monkeypatch):
    """A workload loaded from an artifact captures every bucket at load,
    asks the tuner nothing, builds nothing while serving, and serves the
    exporter's rows."""
    from repro_torch.obs import metrics
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    src = workloads.get("alexnet_imagenet", variant="tiny", matmul_mode=mode)
    src.engine.export_artifact(tmp_path / "art", buckets=(1, 2))
    dst = workloads.get("alexnet_imagenet", variant="tiny", matmul_mode=mode)
    with metrics.use_registry() as reg:
        server = dst.server(artifact=str(tmp_path / "art"), buckets=(1, 2),
                            max_batch=2)
        assert server.artifact_report["loaded"] == [1, 2]
        assert dst.engine.capture_count == 2
        builds = dst.engine.build_count
        imgs = [RNG.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                for _ in range(2)]
        reqs = [server.submit(im) for im in imgs]
        server.drain()
    assert reg.events("autotune") == []
    assert dst.engine.build_count == builds
    x = torch.stack([src.preprocess_hook(im) for im in imgs])
    want = src.engine(x).cpu().numpy()
    for r, row in zip(reqs, want):
        np.testing.assert_array_equal(r.result, row)


def test_multiplexed_lanes_on_card(cuda):
    from repro_torch.serving import MultiTenantServer
    mux = MultiTenantServer(buckets=(1, 2), max_batch=2)
    wls = {"alex": workloads.get("alexnet_imagenet", variant="tiny"),
           "yolo": workloads.get("yolov2_tiny_voc", variant="tiny")}
    mux.add_workload("alex", wls["alex"], weight=3.0)
    mux.add_workload("yolo", wls["yolo"])
    imgs = {t: [RNG.integers(0, 256, (30, 30, 3), dtype=np.uint8)
                for _ in range(4)] for t in wls}
    reqs = {t: [mux.submit(t, im) for im in imgs[t]] for t in wls}
    mux.drain()
    for t, wl in wls.items():
        for r, im in zip(reqs[t], imgs[t]):
            x = torch.stack([wl.preprocess_hook(im)])
            np.testing.assert_array_equal(
                r.result, wl.engine.cross_check(x).cpu().numpy()[0])


def test_captured_decode_equals_eager(cuda, lm_params):
    """``LMServer`` with its decode step captured gives the eager server's
    logits bit for bit at every step and the same tokens."""
    cfg, _, card = lm_params
    servers = {c: LMServer(cfg, card, n_slots=2, max_seq=64, capture=c)
               for c in (True, False)}
    assert servers[True].capture_count == 1
    assert servers[False].capture_count == 0
    logits = {c: [] for c in servers}
    for c, server in servers.items():
        run = server._run_decode

        def record(pos, run=run, log=logits[c]):
            out = run(pos)
            log.append(out.clone())
            return out
        server._run_decode = record
    prompts = [(list(RNG.integers(1, cfg.vocab, n)), m)
               for n, m in ((5, 3), (8, 4), (3, 2))]
    out = {}
    for c, server in servers.items():
        reqs = [server.submit(p, max_new=m) for p, m in prompts]
        server.drain()
        out[c] = [r.result for r in reqs]
    assert len(logits[True]) == len(logits[False]) > 0
    for a, b in zip(logits[True], logits[False]):
        assert torch.equal(a, b)
    assert out[True] == out[False]


# --------------------------------------------------------------------------
# Resilience on the card: a demoted bucket captured lazily, a restore
# through the captured decode step
# --------------------------------------------------------------------------

def test_demoted_bucket_captured_lazily_with_watchdog(cuda):
    """Tiny AlexNet under ``cuda_chain``, captured, with the watchdog on:
    a latency spike wedges a readback past ``watchdog_s`` (its reader
    thread is abandoned asleep) and a dispatch fault follows, so bucket 2
    demotes to ``cuda_direct_pool`` and that rung is built and captured at
    the next dispatch, while the abandoned reader is still alive (the
    capture is thread-local).  The rows equal ``cross_check``; bucket 1
    stays on ``cuda_chain``."""
    import threading
    import time
    from repro_torch.serving import faults
    from repro_torch.serving.faults import FaultSpec, RetryPolicy

    wl = workloads.get("alexnet_imagenet", variant="tiny",
                       matmul_mode="cuda_chain")
    server = wl.server(preprocess=None, buckets=(1, 2), max_batch=2,
                       watchdog_s=0.3, demote_after=2, probe_after_s=60.0,
                       retry=RetryPolicy(max_attempts=3,
                                         backoff_base_s=0.001, jitter=0.0))
    server.compile_buckets()
    captures = wl.engine.capture_count
    compile_, alive = wl.engine.compile, []

    def watched(bs=None, *, mode=None, capture=None):
        if mode == "cuda_direct_pool":
            alive.append(threading.active_count())
        return compile_(bs, mode=mode, capture=capture)
    wl.engine.compile = watched
    n0 = threading.active_count()
    imgs = [RNG.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            for _ in range(3)]
    with faults.inject([
            FaultSpec("server.device", "latency_spike", times=1,
                      duration_s=2.0, match={"bucket": 2}),
            FaultSpec("server.dispatch", "device_fault", times=1, after=1,
                      match={"mode": "cuda_chain", "bucket": 2})],
            sleep=time.sleep):
        reqs = [server.submit(im) for im in imgs[:2]]
        server.drain()
        one = server.submit(imgs[2])
        server.drain()
    assert [r.outcome for r in reqs + [one]] == ["served"] * 3
    assert alive and alive[0] > n0                # the reader was alive
    assert server.health.mode_for(2) == "cuda_direct_pool"
    assert server.health.mode_for(1) == "cuda_chain"
    assert server.metrics()["degraded"] == 1
    assert wl.engine.capture_count == captures + 1
    want = wl.engine.cross_check(torch.from_numpy(np.stack(imgs[:2])))
    np.testing.assert_array_equal(np.stack([r.result for r in reqs]),
                                  want.cpu().numpy())
    np.testing.assert_array_equal(
        one.result,
        wl.engine.cross_check(torch.from_numpy(imgs[2][None])).cpu()
        .numpy()[0])


@pytest.mark.parametrize("base", ["cuda_chain", "cuda_pm1"])
def test_card_bucket_never_reaches_a_torch_mode(cuda, base):
    """On the card a bucket's ladder ends at ``cuda_popcount``, the last
    hand-written rung: with every dispatch faulted, the bucket walks only
    ``cuda_*`` rungs, rests at the floor and its request resolves
    ``error`` after its retries; with the plan gone it serves there, its
    rung captured lazily, equal to ``cross_check``."""
    import time
    from repro_torch.serving import faults
    from repro_torch.serving.faults import FaultSpec, RetryPolicy

    wl = workloads.get("alexnet_imagenet", variant="tiny",
                       matmul_mode=base)
    server = wl.server(preprocess=None, buckets=(1,), max_batch=1,
                       demote_after=1, probe_after_s=60.0,
                       retry=RetryPolicy(max_attempts=8,
                                         backoff_base_s=0.001, jitter=0.0))
    server.compile_buckets()
    img = RNG.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    with faults.inject([FaultSpec("server.dispatch", "device_fault")],
                       sleep=time.sleep) as plan:
        r = server.submit(img)
        server.drain()
    assert r.outcome == "error"
    tried = [f["mode"] for f in plan.log]
    assert tried[-1] == server.health.mode_for(1) == "cuda_popcount"
    assert all(m.startswith("cuda_") for m in tried), tried
    ok = server.submit(img)
    server.drain()
    assert ok.outcome == "served"
    (rec,) = [f for f in server.flight.dump() if f.get("outcome") == "served"]
    assert rec["mode"] == "cuda_popcount"
    np.testing.assert_array_equal(
        ok.result,
        wl.engine.cross_check(torch.from_numpy(img[None])).cpu().numpy()[0])


def test_restore_through_the_captured_decode_step(cuda, lm_params):
    """A decode fault that spends the retries restores the last cut into
    the buffers the captured step reads and replays through the same
    graph: the tokens equal an unfaulted captured server's; the cut's
    pages are pinned host copies with a device time."""
    from repro_torch.serving import faults
    from repro_torch.serving.faults import FaultSpec

    cfg, _, card = lm_params
    prompts = [(list(RNG.integers(1, cfg.vocab, n)), m)
               for n, m in ((5, 12), (8, 12))]
    out = {}
    for label, kw in (("clean", {}), ("faulted", {"checkpoint_every": 3})):
        server = LMServer(cfg, card, n_slots=2, max_seq=64, **kw)
        assert server.capture_count == 1
        with faults.inject([FaultSpec("lm.step", "device_fault", times=3,
                                      after=5)]
                           if label == "faulted" else []):
            reqs = [server.submit(p, max_new=m) for p, m in prompts]
            server.drain()
        out[label] = [r.result for r in reqs]
        assert [r.outcome for r in reqs] == ["served"] * 2
    assert out["faulted"] == out["clean"]
    assert server.restores == 1
    ck = server.checkpointer
    assert ck.last_copy_ms() > 0 and ck.last_bytes > 0
    assert all(c.k_pages.is_pinned() for c in ck.set.seqs.values())


# --------------------------------------------------------------------------
# Placement on the card: staged and sharded buckets, replicas, LM lanes
# --------------------------------------------------------------------------

PLACE_KERNELS = (k4.bitplane_pack, k3.direct_conv_bn_binarize,
                 k3.direct_conv_bn_binarize_planes,
                 k2.fused_matmul_bn_binarize, k5.chain_conv,
                 k1.xnor_popcount_matmul_planes, k6.mxu_pm1_matmul)


@pytest.mark.parametrize("mode", ["cuda_direct_pool", "cuda_chain",
                                  "cuda_pm1"])
@pytest.mark.parametrize("name", ["alexnet_imagenet", "yolov2_tiny_voc"])
def test_staged_bucket_captured_on_card(cuda, name, mode, tmp_path,
                                        monkeypatch):
    """A bucket pipelined over (cuda, cuda, cuda): one graph a stage; its
    rows and raw output equal the single-device graph's bit for bit, and
    its launches a forward summed over the stages are the single-device
    forward's."""
    from repro_torch.runtime.placement import CapturedStages

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "a.json"))
    wl = workloads.get(name, variant="tiny", matmul_mode=mode)
    stages = (cuda,) * 3
    h, w = wl.input_hw
    x = torch.from_numpy(RNG.integers(0, 256, (2, h, w, 3),
                                      dtype=np.uint8)).to(cuda)
    # Built first: under cuda_chain the build times the region tiles.
    wl.engine.engine.compile(2, capture=False)
    wl.engine.engine.compile(2, pipeline=stages, capture=False)
    single = captured_launches(wl.engine, x, PLACE_KERNELS)
    staged = captured_launches(
        lambda t: wl.engine.compile(2, pipeline=stages).run(t), x,
        PLACE_KERNELS)
    assert staged == single and any(single)
    exe = wl.engine.compile(2, pipeline=stages)
    assert isinstance(exe, CapturedStages)
    plan = exe.executor.plan
    # One graph a stage, but none for a stage of the graph's input alone.
    assert plan.n_stages >= 2 and exe.n_graphs == plan.n_stages - (
        plan.stages[0] == (exe.executor.graph.input_id,))
    got, want = exe.run(x), wl.engine.compile(2).run(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    wl.engine.cross_check(x)


def test_pipelined_and_sharded_servers_on_card(cuda):
    """Pipelined and data-parallel servers over the one card serve the
    single-device server's rows, building nothing while serving."""
    from repro_torch.distributed import DataParallel, Pipelined

    wl = workloads.get("yolov2_tiny_voc", variant="tiny")
    imgs = [RNG.integers(0, 256, (40, 50, 3), dtype=np.uint8)
            for _ in range(7)]
    rows = []
    for kw in ({}, dict(placement=Pipelined((cuda, cuda))),
               dict(placement=DataParallel((cuda, cuda))),
               dict(async_dispatch=False)):
        server = wl.server(max_batch=4, buckets=(1, 2, 4), **kw)
        server.compile_buckets()
        builds = wl.engine.build_count
        reqs = [server.submit(im) for im in imgs]
        server.drain()
        assert wl.engine.build_count == builds
        assert all(r.outcome == "served" for r in reqs)
        rows.append([r.result for r in reqs])
    for other in rows[1:]:
        for a, b in zip(other, rows[0]):
            np.testing.assert_array_equal(a, b)


def test_replicas_share_weights_not_buffers_on_card(cuda):
    from repro_torch.distributed import ReplicaGroup

    wl = workloads.get("alexnet_imagenet", variant="tiny")
    grp = ReplicaGroup(wl.engine, [cuda] * 2, buckets=(2,), max_batch=2,
                       preprocess=wl.preprocess_hook)
    grp.compile_buckets()
    builds, captures = grp.build_count, grp.capture_count
    e0, e1 = (r.server.engine.engine for r in grp.replicas.values())
    assert e0.packed[0]["w_packed"] is e1.packed[0]["w_packed"]
    assert e0._graph_pool != e1._graph_pool
    (c0,), (c1,) = e0._captured.values(), e1._captured.values()
    assert c0.static_output.data_ptr() != c1.static_output.data_ptr()
    imgs = [RNG.integers(0, 256, (20, 20, 3), dtype=np.uint8)
            for _ in range(8)]
    reqs = [grp.submit(im) for im in imgs]
    grp.drain()
    assert (grp.build_count, grp.capture_count) == (builds, captures)
    want = wl.predict(imgs)
    for r, row in zip(reqs, want):
        np.testing.assert_array_equal(r.result, row)


def test_lm_lanes_migrate_on_card(cuda, lm_params):
    """Two captured LM lanes over one params dict: lm0's decode faults
    past its restore; its sequence migrates to lm1 with the emitted
    prefix kept, and is served."""
    from repro_torch.distributed import LMReplicaGroup
    from repro_torch.serving import faults

    cfg, _, params = lm_params
    grp = LMReplicaGroup(cfg, None, params, n_slots=2, max_seq=64, device=cuda,
                         checkpoint_every=2, max_restore_attempts=1)
    assert all(ln.server.capture_count == 1 for ln in grp.lanes.values())
    r = grp.submit([1, 2, 3], max_new=12, lane="lm0")
    for _ in range(4):
        grp.serve_tick()
    prefix = list(next(iter(
        grp.lanes["lm0"].server.manager.active.values())).tokens)
    with faults.inject([faults.FaultSpec("lm.step", "device_fault",
                                         match={"tenant": "lm0"})]):
        grp.drain()
    assert r.outcome == "served" and len(r.result) == 12
    assert r.result[:len(prefix)] == prefix and grp.migrations == 1
    assert grp.lanes["lm0"].quarantined(grp.clock())


def test_capture_holds_off_the_collector(cuda):
    """The cyclic collector waits for a capture to end: a collection inside
    it could free an unreachable object owning another graph (a server or
    replica group in a reference cycle), and destroying a graph while the
    stream captures voids the capture ("operation failed due to a previous
    error during capture").  Here a graph in a reference cycle becomes
    garbage during the capture; the collector stays off until the capture
    ends, and frees it after."""
    import gc

    cycle = {"graph": CapturedExecutor(lambda t: t + 1, (2, 4), cuda)}
    cycle["self"] = cycle
    holder, seen = [cycle], []
    del cycle

    def fn(t):
        seen.append(gc.isenabled())
        if torch.cuda.is_current_stream_capturing():
            holder.clear()              # the cycle is garbage from here
        return t + 1

    exe = CapturedExecutor(fn, (2, 4), cuda)
    assert seen == [True] * WARMUP_CALLS + [False] and gc.isenabled()
    assert gc.collect() > 0             # the cycle, freed after the capture
    x = torch.ones((2, 4), dtype=torch.uint8, device=cuda)
    assert torch.equal(exe(x), x + 1)


class _PlainAttention(torch.autograd.Function):
    """K7 and K7b swapped for their plain versions."""

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


@pytest.mark.parametrize("family", ["vit", "dit"])
def test_zoo_attention_through_the_kernels(cuda, family, monkeypatch):
    """A narrow ViT at ViT-H/14's head width 80 and a narrow DiT at
    DiT-XL/2's 72: K7 once a layer a forward and twice a layer a train step
    (the forward and the remat's recompute), K7b once a layer a train
    step; the forward and the loss against the same model with K7/K7b
    swapped for their plain versions (relative max error 2e-2 on the
    output, 2e-3 on the loss: K7's bf16 tolerance through two layers)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    if family == "vit":
        cfg = vit.ViTConfig(name="vit-hd80", img_res=56, patch=14,
                            n_layers=2, d_model=160, n_heads=2, d_ff=320,
                            n_classes=10)
        params = vit.init_params(cfg, g, cuda)
        x = torch.rand((2, 56, 56, 3), device=cuda, generator=g)
        batch = {"images": x, "labels": torch.tensor([1, 2], device=cuda)}
        serve = lambda: vit.forward(params, x, cfg)  # noqa: E731
        loss_fn, args = vit.loss_fn, (batch, cfg)
    else:
        cfg = dit.DiTConfig(name="dit-hd72", img_res=128, patch=2,
                            n_layers=2, d_model=144, n_heads=2,
                            n_classes=10)
        params = dit.init_params(cfg, g, cuda)
        # adaLN-zero would leave attention out of the output: non-zero
        params = tree.tree_map(lambda t: t + 0.02 * torch.randn(
            t.shape, device=cuda, generator=g), params)
        r = cfg.latent_res()
        lat = torch.randn((2, r, r, 4), device=cuda, generator=g)
        t = torch.tensor([5, 600], device=cuda)
        labels = torch.tensor([1, 10], device=cuda)
        serve = lambda: dit.forward(params, lat, t, labels, cfg)[0]  # noqa
        batch = {"latents": lat, "labels": labels, "t": t,
                 "noise": torch.randn((2, r, r, 4), device=cuda,
                                      generator=g)}
        loss_fn, args = dit.train_loss, (batch, cfg)
    assert cfg.d_head in (72, 80)
    k7.flash_attention.launches = k7.flash_attention_bwd.launches = 0
    out = serve()
    (loss, _), grads = tree.value_and_grad(loss_fn, params, *args)
    torch.cuda.synchronize()
    assert (k7.flash_attention.launches,
            k7.flash_attention_bwd.launches) == (3 * cfg.n_layers,
                                                 cfg.n_layers)
    assert torch.isfinite(optim.global_norm(grads))
    monkeypatch.setattr(layers, "flash_attention", _PlainAttention.apply)
    want = serve()
    (want_loss, _), _ = tree.value_and_grad(loss_fn, params, *args)
    err = ((out.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert err <= 2e-2
    assert abs(loss.item() - want_loss.item()) <= 2e-3 * abs(
        want_loss.item())
